"""ResNet-50 (the flagship training workload), ResNet-101 and ResNet-152.

Counterpart of ``chainermn_tpu/models/resnet50.py``: bottleneck blocks
of [3, 4, 6, 3] ([3, 4, 23, 3] and [3, 8, 36, 3] for the deeper two),
stride on the 3x3 (v1.5), bf16 compute with f32 master
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

``stem='space_to_depth'`` replaces the 7x7/2 stem conv ``conv_init`` by
``conv_init_s2d``, a 4x4/1 ``VALID`` conv over the 2x2 space-to-depth
rearrangement of the input padded (1, 2): the same function, under the
weight map :func:`s2d_stem_kernel` (:func:`convert_stem_variables`
converts a whole flax-layout tree).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch.models._layers import (  # noqa: F401
    Conv, _lecun_normal_, max_pool_same, same_pads)
from chainermn_tpu_torch.models._norm import NormAct
from chainermn_tpu_torch.ops._common import resolve_device


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
    when there is none).  ``insize`` (the reference's 224) is the input
    size the data pipeline crops to; the widths do not depend on it."""

    def __init__(self, stage_sizes, num_classes=1000, width=64,
                 dtype=torch.bfloat16, stem='standard',
                 fused_norm=False, device=None, generator=None,
                 insize=224):
        super().__init__()
        if stem not in ('standard', 'space_to_depth'):
            raise ValueError("stem must be 'standard' or 'space_to_depth', "
                             "got %r" % (stem,))
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.insize = insize
        self.fused_norm = fused_norm
        self.stem = stem
        if stem == 'space_to_depth':
            self.conv_init_s2d = Conv(12, width, 4, 1, dtype=dtype,
                                      generator=generator, padding='VALID')
        else:
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
        x = x.to(self.dtype)
        if self.stem == 'space_to_depth':
            b, h, w, c = x.shape
            if h % 2 or w % 2:
                raise ValueError('space_to_depth stem needs even spatial '
                                 'dims, got %s' % ((h, w),))
            x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(
                0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            # the 4 stride-1 taps cover source rows [p - 1, p + 2]: the
            # 7x7/2 conv's SAME padding (2, 3)
            x = self.conv_init_s2d(F.pad(x, (0, 0, 1, 2, 1, 2)))
        else:
            x = self.conv_init(x)
        x = self.bn_init(x)
        x = max_pool_same(x)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # jnp.mean over bf16 accumulates in f32 and rounds to bf16; the
        # f32 Dense then widens it again, and its parameters too (a
        # policy hands them over in the compute dtype)
        x = x.float().mean((1, 2)).to(self.dtype)
        return F.linear(x.float(), self.fc.weight.float(),
                        self.fc.bias.float())


def ResNet50(num_classes=1000, dtype=torch.bfloat16, stem='standard',
             fused_norm=False, device=None, generator=None, insize=224):
    return ResNet(stage_sizes=[3, 4, 6, 3], num_classes=num_classes,
                  dtype=dtype, stem=stem, fused_norm=fused_norm,
                  device=device, generator=generator, insize=insize)


def s2d_stem_kernel(w7):
    """Map a standard ``(7, 7, C, F)`` flax stem kernel to the equivalent
    ``(4, 4, 4C, F)`` space-to-depth kernel: tap ``t = 2a + phi`` of the
    strided 7x7 window lands on s2d tap ``a``, phase channel ``phi``
    (taps with ``t == 7`` do not exist and stay zero)."""
    w7 = np.asarray(w7)
    c, f = w7.shape[2], w7.shape[3]
    w4 = np.zeros((4, 4, 4 * c, f), w7.dtype)
    for ah in range(4):
        for ph in range(2):
            th = 2 * ah + ph
            if th > 6:
                continue
            for aw in range(4):
                for pw in range(2):
                    tw = 2 * aw + pw
                    if tw > 6:
                        continue
                    ch = (ph * 2 + pw) * c
                    w4[ah, aw, ch:ch + c, :] = w7[th, tw]
    return w4


def convert_stem_variables(variables):
    """A standard-stem flax-layout variable tree (``{'params': ...,
    ...}``, e.g. ``to_flax_variables(model)``) in the space-to-depth
    layout: ``conv_init`` becomes ``conv_init_s2d`` through
    :func:`s2d_stem_kernel`; everything else is shared."""
    params = dict(variables['params'])
    w7 = params.pop('conv_init')['kernel']
    params['conv_init_s2d'] = {'kernel': s2d_stem_kernel(w7)}
    return {'params': params,
            **{k: v for k, v in variables.items() if k != 'params'}}


def ResNet101(num_classes=1000, dtype=torch.bfloat16, fused_norm=False,
              device=None, generator=None, width=64, insize=224):
    return ResNet(stage_sizes=[3, 4, 23, 3], num_classes=num_classes,
                  width=width, dtype=dtype, fused_norm=fused_norm,
                  device=device, generator=generator, insize=insize)


def ResNet152(num_classes=1000, dtype=torch.bfloat16, fused_norm=False,
              device=None, generator=None, width=64, insize=224):
    return ResNet(stage_sizes=[3, 8, 36, 3], num_classes=num_classes,
                  width=width, dtype=dtype, fused_norm=fused_norm,
                  device=device, generator=generator, insize=insize)
