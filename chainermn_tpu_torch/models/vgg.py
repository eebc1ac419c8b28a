"""VGG-16 (``BASELINE.json`` config 3: the tensor-fusion stress
workload, 138 M parameters in a handful of large tensors).

Counterpart of ``chainermn_tpu/models/vgg.py``: five stages of 3x3 convs
(with bias) and relu, a 2x2 max pool after each, then Dense 4096 ->
relu -> dropout 0.5 twice and an f32 Dense head.  There is no norm: the
activations go through :func:`~chainermn_tpu_torch.models._norm.norm_act`
with ``use_norm=False``, so ``fused_norm`` is accepted and changes
nothing, as in the JAX package.

``Dense_0`` reads the NHWC map flattened in ``(H, W, C)`` order, as flax
does; its width follows ``insize`` (7 x 7 x 512 at 224), which flax
infers at ``init`` and the port takes from the constructor.
"""

import torch
from torch import nn

from chainermn_tpu_torch.models._layers import (
    Conv, Dense, Dropout, max_pool, out_size)
from chainermn_tpu_torch.models._norm import norm_act
from chainermn_tpu_torch.ops._common import resolve_device

_VGG16 = (2, 2, 3, 3, 3)
_WIDTHS = (64, 128, 256, 512, 512)


class VGG(nn.Module):
    """VGG over NHWC input, returning f32 logits.  Parameters are made on
    the CPU from ``generator`` (default: seed 0) and moved to ``device``
    (default: the current CUDA device; raises when there is none)."""

    def __init__(self, stage_sizes=_VGG16, num_classes=1000,
                 dtype=torch.bfloat16, insize=224, fused_norm=False,
                 device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.insize = insize
        self.fused_norm = fused_norm
        self.stage_sizes = tuple(stage_sizes)
        conv = dict(dtype=dtype, generator=generator, padding=1,
                    use_bias=True)
        i, in_features, size = 0, 3, insize
        for n, width in zip(self.stage_sizes, _WIDTHS):
            for _ in range(n):
                setattr(self, 'Conv_%d' % i,
                        Conv(in_features, width, 3, **conv))
                i, in_features = i + 1, width
            size = out_size(size, 2, 2, 'VALID')
        self.n_convs = i
        dense = dict(dtype=dtype, generator=generator)
        self.Dense_0 = Dense(in_features * size * size, 4096, **dense)
        self.Dense_1 = Dense(4096, 4096, **dense)
        self.Dense_2 = Dense(4096, num_classes, dtype=torch.float32,
                             generator=generator)
        self.dropout = Dropout(0.5)
        self.to(device)

    def forward(self, x):
        x = x.to(self.dtype)
        i = 0
        for n in self.stage_sizes:
            for _ in range(n):
                x = norm_act(getattr(self, 'Conv_%d' % i)(x), None, None,
                             None, None, train=self.training,
                             fused=self.fused_norm, use_norm=False)
                i += 1
            x = max_pool(x, 2, 2)
        x = x.reshape(x.shape[0], -1)
        x = self.dropout(torch.relu(self.Dense_0(x)))
        x = self.dropout(torch.relu(self.Dense_1(x)))
        return self.Dense_2(x).float()


def VGG16(num_classes=1000, dtype=torch.bfloat16, fused_norm=False,
          insize=224, device=None, generator=None):
    return VGG(num_classes=num_classes, dtype=dtype, insize=insize,
               fused_norm=fused_norm, device=device, generator=generator)
