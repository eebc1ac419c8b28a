"""ResNet-50 (the flagship training workload).

Counterpart of ``chainermn_tpu/models/resnet50.py``: bottleneck blocks
of [3, 4, 6, 3], stride on the 3x3 (v1.5), bf16 compute with f32 master
parameters and f32 BatchNorm statistics, ``fused_norm=`` selecting the
fused BN kernels.

Layout: ``ResNet.forward`` takes the JAX package's NHWC input ``(B, H,
W, 3)``.  Inside, activations are NHWC-contiguous tensors; permuted to
NCHW they are ``torch.channels_last`` tensors, which is what the
convolutions take and give, so every BatchNorm input is a zero-copy
``(M, C)`` row view.

Padding: flax's ``SAME`` pads a strided layer asymmetrically (the 7x7/2
stem at 224 pads (2, 3); a 3x3/2 at an even size pads (0, 1); the 3x3/2
max pool pads (0, 1) with -inf).  PyTorch's ``padding=`` is symmetric,
so such layers get an explicit ``F.pad`` first.

Module names follow flax's auto-numbering (``conv_init``, ``bn_init``,
``Bottleneck_<i>``, ``Conv_<j>``, ``BatchNorm_<j>``, ``proj``,
``proj_bn``, ``fc``), so :mod:`flax_weights` maps the two trees
mechanically.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models._norm import NormAct
from chainermn_tpu_torch.ops._common import resolve_device


def same_pads(size, kernel, stride):
    """flax/XLA ``SAME`` padding ``(lo, hi)`` of one spatial dim."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _lecun_normal_(w, fan_in, generator):
    """flax's default kernel init: truncated normal at +-2 std, variance
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` without bias and with ``SAME`` padding, on NHWC
    tensors; the weight is an f32 OIHW channels_last master cast to
    ``dtype`` for the convolution."""

    def __init__(self, in_features, features, kernel, stride=1,
                 dtype=torch.bfloat16, generator=None):
        super().__init__()
        self.kernel = kernel
        self.stride = stride
        self.dtype = dtype
        w = torch.empty((features, in_features, kernel, kernel))
        _lecun_normal_(w, in_features * kernel * kernel, generator)
        self.weight = nn.Parameter(
            w.contiguous(memory_format=torch.channels_last))

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2).to(self.dtype)
        (ht, hb), (wl, wr) = (same_pads(s, self.kernel, self.stride)
                              for s in xc.shape[2:])
        if ht == hb and wl == wr:
            pad = (ht, wl)
        else:
            xc = F.pad(xc, (wl, wr, ht, hb))
            pad = 0
        y = F.conv2d(xc, self.weight.to(self.dtype), stride=self.stride,
                     padding=pad)
        return y.permute(0, 2, 3, 1)


def max_pool_same(x, kernel=3, stride=2):
    """``nn.max_pool(x, (k, k), strides=(s, s), padding='SAME')`` on an
    NHWC tensor: -inf padding, asymmetric where flax pads so."""
    xc = x.permute(0, 3, 1, 2)
    (ht, hb), (wl, wr) = (same_pads(s, kernel, stride) for s in xc.shape[2:])
    xc = F.pad(xc, (wl, wr, ht, hb), value=float('-inf'))
    return F.max_pool2d(xc, kernel, stride).permute(0, 2, 3, 1)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 bottleneck; BatchNorm_2 (zero-init
    scale) + shortcut add + relu is one fused pass."""

    def __init__(self, in_features, features, stride=1, dtype=torch.bfloat16,
                 fused_norm=False, generator=None):
        super().__init__()
        conv = dict(dtype=dtype, generator=generator)
        self.Conv_0 = Conv(in_features, features, 1, **conv)
        self.BatchNorm_0 = NormAct(features, fused=fused_norm)
        self.Conv_1 = Conv(features, features, 3, stride, **conv)
        self.BatchNorm_1 = NormAct(features, fused=fused_norm)
        self.Conv_2 = Conv(features, features * 4, 1, **conv)
        if in_features != features * 4 or stride != 1:
            self.proj = Conv(in_features, features * 4, 1, stride, **conv)
            self.proj_bn = NormAct(features * 4, relu=False,
                                   fused=fused_norm)
        else:
            self.proj = self.proj_bn = None
        self.BatchNorm_2 = NormAct(features * 4, fused=fused_norm,
                                   scale_init=0.0)

    def forward(self, x):
        residual = x
        y = self.BatchNorm_0(self.Conv_0(x))
        y = self.BatchNorm_1(self.Conv_1(y))
        y = self.Conv_2(y)
        if self.proj is not None:
            residual = self.proj_bn(self.proj(residual))
        return self.BatchNorm_2(y, residual=residual)


class ResNet(nn.Module):
    """ResNet over NHWC input, returning f32 logits.

    Parameters are made on the CPU from ``generator`` (default: seed 0)
    and moved to ``device`` (default: the current CUDA device; raises
    when there is none)."""

    def __init__(self, stage_sizes, num_classes=1000, width=64,
                 dtype=torch.bfloat16, stem='standard',
                 fused_norm=False, device=None, generator=None):
        super().__init__()
        if stem == 'space_to_depth':
            raise NotImplementedError(
                "the space_to_depth stem is not ported yet (ROADMAP.md "
                "A3); use stem='standard'")
        if stem != 'standard':
            raise ValueError("stem must be 'standard' or 'space_to_depth', "
                             "got %r" % (stem,))
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.fused_norm = fused_norm
        self.conv_init = Conv(3, width, 7, 2, dtype=dtype,
                              generator=generator)
        self.bn_init = NormAct(width, fused=fused_norm)
        self.block_names = []
        in_features = width
        for i, block_count in enumerate(stage_sizes):
            for j in range(block_count):
                name = 'Bottleneck_%d' % len(self.block_names)
                stride = 2 if i > 0 and j == 0 else 1
                setattr(self, name, Bottleneck(
                    in_features, width * 2 ** i, stride, dtype=dtype,
                    fused_norm=fused_norm, generator=generator))
                self.block_names.append(name)
                in_features = width * 2 ** i * 4
        self.fc = nn.Linear(in_features, num_classes)
        with torch.no_grad():
            _lecun_normal_(self.fc.weight, in_features, generator)
            self.fc.bias.zero_()
        self.to(device)

    def forward(self, x):
        x = self.conv_init(x.to(self.dtype))
        x = self.bn_init(x)
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean over bf16 accumulates in f32 and rounds to bf16; the
        # f32 Dense then widens it again
        x = x.float().mean((1, 2)).to(self.dtype)
        return self.fc(x.float()).float()


def ResNet50(num_classes=1000, dtype=torch.bfloat16, stem='standard',
             fused_norm=False, device=None, generator=None):
    return ResNet(stage_sizes=[3, 4, 6, 3], num_classes=num_classes,
                  dtype=dtype, stem=stem, fused_norm=fused_norm,
                  device=device, generator=generator)


def ResNet101(*args, **kwargs):
    raise NotImplementedError('ResNet-101 is not ported yet (ROADMAP.md A3)')


def ResNet152(*args, **kwargs):
    raise NotImplementedError('ResNet-152 is not ported yet (ROADMAP.md A3)')
