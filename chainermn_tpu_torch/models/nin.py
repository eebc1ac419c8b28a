"""Network-in-Network (the reference's
``examples/imagenet/models_v2/nin.py``, insize 227: four mlpconv stacks
and a global-average head).

Counterpart of ``chainermn_tpu/models/nin.py``.  Each mlpconv is a conv
(with bias) and two 1x1 convs, each followed by relu through
:func:`~chainermn_tpu_torch.models._norm.norm_act` with
``use_norm=False`` (``fused_norm`` is accepted and changes nothing, as
in the JAX package); 3x3/2 max pools between them and dropout 0.5
before the last.  Inputs under 68 px raise ``ValueError``.
"""

import torch
from torch import nn

from chainermn_tpu_torch.models._layers import (
    Conv, Dropout, global_mean, max_pool)
from chainermn_tpu_torch.models._norm import norm_act
from chainermn_tpu_torch.models.alex import _check_size
from chainermn_tpu_torch.ops._common import resolve_device


class NIN(nn.Module):
    """NIN over NHWC input, returning f32 logits (``num_classes``
    channels of the last mlpconv, averaged); parameters from
    ``generator`` (default: seed 0) on ``device`` (default: the current
    CUDA device)."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16, insize=227,
                 fused_norm=False, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.insize = insize
        self.fused_norm = fused_norm
        # (features, kernel, stride, padding) of each mlpconv's first conv
        self.stacks = ((96, 11, 4, 'VALID'), (256, 5, 1, 2), (384, 3, 1, 1),
                       (num_classes, 3, 1, 1))
        i, in_features = 0, 3
        for feats, k, s, pad in self.stacks:
            for kernel, stride, padding in ((k, s, pad), (1, 1, 'SAME'),
                                            (1, 1, 'SAME')):
                setattr(self, 'Conv_%d' % i, Conv(
                    in_features, feats, kernel, stride, dtype=dtype,
                    generator=generator, padding=padding, use_bias=True))
                i, in_features = i + 1, feats
        self.dropout = Dropout(0.5)
        self.to(device)

    def _act(self, x):
        return norm_act(x, None, None, None, None, train=self.training,
                        fused=self.fused_norm, use_norm=False)

    def forward(self, x):
        _check_size('NIN', self.insize, x)
        x = x.to(self.dtype)
        for j in range(len(self.stacks)):
            if j == 3:
                x = self.dropout(x)
            for i in range(3 * j, 3 * j + 3):
                x = self._act(getattr(self, 'Conv_%d' % i)(x))
            if j < 3:
                x = max_pool(x, 3, 2)
        return global_mean(x, self.dtype).float()
