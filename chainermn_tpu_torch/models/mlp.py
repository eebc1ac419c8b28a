"""Three-layer MLP (the reference MNIST model,
``examples/mnist/train_mnist.py:20-31``: 784 -> units -> units -> 10
with ReLU).

Counterpart of ``chainermn_tpu/models/mlp.py``.  The three layers are
named ``Dense_0``, ``Dense_1`` and ``Dense_2`` as flax names them, so
:func:`~chainermn_tpu_torch.models.load_flax_variables` carries the
JAX package's parameters across (a ``(in, out)`` kernel is the
``nn.Linear`` weight, transposed).  The dense products are plain
matmuls in the JAX package too: no TPU kernel lies on this model.
"""

import torch
import torch.nn as nn
import torch.nn.functional as F

from chainermn_tpu_torch.models.resnet50 import _lecun_normal_
from chainermn_tpu_torch.ops._common import resolve_device

N_IN = 784  # a flattened 28 x 28 image


class MLP(nn.Module):
    """``dtype`` is the COMPUTE dtype (``None``: the input's, full
    precision for f32 inputs); parameters are float32 whatever it is.
    They are made on the CPU from ``generator`` (default: seed 0), with
    flax's ``Dense`` initializers, and moved to ``device`` (default: the
    current CUDA device; raises when there is none).  ``n_in`` is the
    input width (flax infers it at ``init``): 784 for a flattened
    MNIST image, ``n_units`` for the second stage of the
    model-parallel example."""

    def __init__(self, n_units=100, n_out=10, dtype=None, device=None,
                 generator=None, n_in=N_IN):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        widths = (n_in, n_units, n_units, n_out)
        for i in range(3):
            layer = nn.Linear(widths[i], widths[i + 1])
            with torch.no_grad():
                _lecun_normal_(layer.weight, widths[i], generator)
                layer.bias.zero_()
            setattr(self, 'Dense_%d' % i, layer)
        self.to(device)

    def _dense(self, layer, x):
        if self.dtype is None:
            return layer(x)
        return F.linear(x, layer.weight.to(self.dtype),
                        layer.bias.to(self.dtype))

    def forward(self, x):
        x = x.reshape(len(x), -1)
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self._dense(self.Dense_0, x))
        x = F.relu(self._dense(self.Dense_1, x))
        return self._dense(self.Dense_2, x)
