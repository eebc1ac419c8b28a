"""AlexNet (the reference's ``examples/imagenet/models_v2/alex.py``,
insize 227).

Counterpart of ``chainermn_tpu/models/alex.py``: five convs (with bias)
and relu, three 3x3/2 max pools, Dense 4096 -> relu -> dropout 0.5 twice
and an f32 Dense head.  ``Dense_0`` reads the NHWC map flattened in
``(H, W, C)`` order; its width follows ``insize`` (6 x 6 x 256 at 227).
Inputs under 68 px raise ``ValueError``, as in the JAX package: the
VALID 11x11/4 stem and the three pools leave nothing to flatten.
"""

import torch
from torch import nn

from chainermn_tpu_torch.models._layers import (
    Conv, Dense, Dropout, max_pool, out_size)
from chainermn_tpu_torch.ops._common import resolve_device

# (features, kernel, stride, padding, max pool after)
_CONVS = ((96, 11, 4, 'VALID', True), (256, 5, 1, 2, True),
          (384, 3, 1, 1, False), (384, 3, 1, 1, False),
          (256, 3, 1, 1, True))


def _check_size(name, insize, x):
    if x.shape[1] < 68 or x.shape[2] < 68:
        raise ValueError('%s needs input >= 68x68 (canonical %d), got %r'
                         % (name, insize, tuple(x.shape[1:3])))


class Alex(nn.Module):
    """AlexNet over NHWC input, returning f32 logits; parameters from
    ``generator`` (default: seed 0) on ``device`` (default: the current
    CUDA device)."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16, insize=227,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.insize = insize
        in_features, size = 3, insize
        for i, (feats, k, s, pad, pool) in enumerate(_CONVS):
            setattr(self, 'Conv_%d' % i, Conv(
                in_features, feats, k, s, dtype=dtype, generator=generator,
                padding=pad, use_bias=True))
            in_features, size = feats, out_size(size, k, s, pad)
            if pool:
                size = out_size(size, 3, 2, 'VALID')
        dense = dict(dtype=dtype, generator=generator)
        self.Dense_0 = Dense(in_features * size * size, 4096, **dense)
        self.Dense_1 = Dense(4096, 4096, **dense)
        self.Dense_2 = Dense(4096, num_classes, dtype=torch.float32,
                             generator=generator)
        self.dropout = Dropout(0.5)
        self.to(device)

    def forward(self, x):
        _check_size('Alex', self.insize, x)
        x = x.to(self.dtype)
        for i, (_, _, _, _, pool) in enumerate(_CONVS):
            x = torch.relu(getattr(self, 'Conv_%d' % i)(x))
            if pool:
                x = max_pool(x, 3, 2)
        x = x.reshape(x.shape[0], -1)
        x = self.dropout(torch.relu(self.Dense_0(x)))
        x = self.dropout(torch.relu(self.Dense_1(x)))
        return self.Dense_2(x).float()
