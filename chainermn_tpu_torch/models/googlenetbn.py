"""GoogLeNet-BN / BN-Inception (the reference's
``examples/imagenet/models_v2/googlenetbn.py``; ``BASELINE.json`` config
5: multi-branch gradients).

Counterpart of ``chainermn_tpu/models/googlenetbn.py``.  Every conv ->
BatchNorm -> relu triple goes through
:class:`~chainermn_tpu_torch.models._norm.NormAct`, so ``fused_norm=True``
runs the fused BN kernels (``bn_stats`` and ``bn_apply``) once per
interlude: 68 a forward (2 in the stem, 7 in each of eight
``InceptionBN`` modules and 5 in the two stride-2 ones).  Module names
replay flax's (``Conv_<i>`` and ``BatchNorm_<i>`` in call order inside
each ``InceptionBN_<j>``), so ``flax_weights`` maps the trees.

The branches are concatenated on the channel axis of NHWC tensors: each
branch ends in its own conv (or pool), so every BatchNorm input is a
conv's contiguous ``(..., C)`` output.
"""

import torch
from torch import nn

from chainermn_tpu_torch.models._layers import (
    Conv, Dense, avg_pool, global_mean, max_pool, max_pool_same)
from chainermn_tpu_torch.models._norm import NormAct
from chainermn_tpu_torch.ops._common import resolve_device


class InceptionBN(nn.Module):
    """1x1 / 3x3 / double 3x3 / pool-projection branches, each conv
    followed by BatchNorm and relu; ``n1 = 0`` and ``proj = 0`` drop the
    1x1 branch and the projection (the stride-2 modules)."""

    def __init__(self, in_features, n1, n3r, n3, d3r, d3, proj, pool='avg',
                 stride=1, dtype=torch.bfloat16, fused_norm=False,
                 generator=None):
        super().__init__()
        self.n1, self.proj, self.pool, self.stride = n1, proj, pool, stride
        count = []

        def cbr(in_f, features, kernel, stride=1):
            # Conv_i -> BatchNorm_i, numbered in call order as flax does
            i = len(count)
            count.append(i)
            setattr(self, 'Conv_%d' % i, Conv(in_f, features, kernel, stride,
                                              dtype=dtype,
                                              generator=generator))
            setattr(self, 'BatchNorm_%d' % i,
                    NormAct(features, fused=fused_norm))
            return i

        if n1:
            self.b1 = cbr(in_features, n1, 1)
        self.b3 = [cbr(in_features, n3r, 1), cbr(n3r, n3, 3, stride)]
        self.bd = [cbr(in_features, d3r, 1), cbr(d3r, d3, 3),
                   cbr(d3, d3, 3, stride)]
        if proj:
            self.bp = cbr(in_features, proj, 1)
        self.out_features = n1 + n3 + d3 + (proj or in_features)

    def _run(self, i, x):
        return getattr(self, 'BatchNorm_%d' % i)(
            getattr(self, 'Conv_%d' % i)(x))

    def forward(self, x):
        branches = []
        if self.n1:
            branches.append(self._run(self.b1, x))
        branches.append(self._run(self.b3[1], self._run(self.b3[0], x)))
        y = x
        for i in self.bd:
            y = self._run(i, y)
        branches.append(y)
        pool = avg_pool if self.pool == 'avg' else max_pool
        y = pool(x, 3, self.stride, 'SAME')
        if self.proj:
            y = self._run(self.bp, y)
        branches.append(y)
        return torch.cat(branches, dim=-1)


# (n1, n3r, n3, d3r, d3, proj, pool, stride) of the ten modules
_MODULES = ((64, 64, 64, 64, 96, 32, 'avg', 1),
            (64, 64, 96, 64, 96, 64, 'avg', 1),
            (0, 128, 160, 64, 96, 0, 'max', 2),
            (224, 64, 96, 96, 128, 128, 'avg', 1),
            (192, 96, 128, 96, 128, 128, 'avg', 1),
            (160, 128, 160, 128, 160, 128, 'avg', 1),
            (96, 128, 192, 160, 192, 128, 'avg', 1),
            (0, 128, 192, 192, 256, 0, 'max', 2),
            (352, 192, 320, 160, 224, 128, 'avg', 1),
            (352, 192, 320, 192, 224, 128, 'max', 1))


class GoogLeNetBN(nn.Module):
    """GoogLeNet-BN over NHWC input, returning f32 logits; parameters
    from ``generator`` (default: seed 0) on ``device`` (default: the
    current CUDA device)."""

    def __init__(self, num_classes=1000, dtype=torch.bfloat16, insize=224,
                 fused_norm=False, device=None, generator=None):
        super().__init__()
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.insize = insize
        self.fused_norm = fused_norm
        conv = dict(dtype=dtype, generator=generator)
        self.Conv_0 = Conv(3, 64, 7, 2, padding=3, **conv)
        self.BatchNorm_0 = NormAct(64, fused=fused_norm)
        self.Conv_1 = Conv(64, 192, 3, padding=1, **conv)
        self.BatchNorm_1 = NormAct(192, fused=fused_norm)
        in_features = 192
        for j, (n1, n3r, n3, d3r, d3, proj, pool, s) in enumerate(_MODULES):
            m = InceptionBN(in_features, n1, n3r, n3, d3r, d3, proj,
                            pool=pool, stride=s, fused_norm=fused_norm,
                            **conv)
            setattr(self, 'InceptionBN_%d' % j, m)
            in_features = m.out_features
        self.Dense_0 = Dense(in_features, num_classes, dtype=torch.float32,
                             generator=generator)
        self.to(device)

    @property
    def n_norms(self):
        """The BatchNorm interludes of one forward (68)."""
        return sum(isinstance(m, NormAct) for m in self.modules())

    def forward(self, x):
        x = x.to(self.dtype)
        x = max_pool_same(self.BatchNorm_0(self.Conv_0(x)))
        x = max_pool_same(self.BatchNorm_1(self.Conv_1(x)))
        for j in range(len(_MODULES)):
            x = getattr(self, 'InceptionBN_%d' % j)(x)
        return self.Dense_0(global_mean(x, self.dtype)).float()
