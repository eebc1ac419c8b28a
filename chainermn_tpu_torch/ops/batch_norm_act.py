"""Fused BatchNorm + activation (+ residual add): one pass per direction.

Counterpart of ``chainermn_tpu/ops/batch_norm_act.py``.  The training-mode
op normalizes with f32 batch statistics over a bf16 or f32 activation,
applies the affine, adds the optional residual and applies the optional
relu, in one pass over the activation.  Its backward recomputes the
normalized value from the saved ``(x, mean, rstd)`` and takes the relu
mask from the sign of the saved OUTPUT, so no activation-sized f32 tensor
crosses the forward/backward boundary.

On a CUDA tensor the forward launches two hand-written kernels
(``csrc/batch_norm_act.cu``): :func:`bn_stats` and :func:`bn_apply`.  On
a CPU tensor it runs their plain PyTorch versions (:func:`_batch_stats`,
:func:`_apply_ref`).  The backward is PyTorch ops on both, as the JAX
package's backward is ``jnp``.

Layout: the public functions take the JAX package's layout, an
activation ``(..., C)`` with C last and contiguous, viewed without a copy
as ``(M, C)`` rows.  A ``torch.channels_last`` NCHW tensor permuted to
NHWC is such a tensor.  The statistics match ``flax.linen.BatchNorm``:
f32, fast variance ``E[x^2] - E[x]^2`` clipped at zero.
"""

import ctypes

import torch

from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._build import LIBRARIES

_TILE_C = 32   # channels per block (kTileC in the .cu source)
_LANES = 8     # row lanes per block (kLanes in the .cu source)


def _wide(t):
    """``t`` in f32, or in its own wider type (the plain versions of a
    float64 model compute in float64, as flax promotes)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def _batch_stats(x2d, eps):
    """Plain version of :func:`bn_stats`: flax-parity batch statistics
    (f32, fast variance, clipped); returns ``(mean, var, rstd)``."""
    xf = _wide(x2d)
    mean = xf.mean(0)
    mean2 = (xf * xf).mean(0)
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    return mean, var, torch.rsqrt(var + eps)


def _apply_ref(x, mean, rstd, scale, bias, residual, relu):
    """Plain version of :func:`bn_apply`: normalize + affine (+ add)
    (+ relu) in f32, output in ``x.dtype``."""
    y = (_wide(x) - mean) * (rstd * scale) + bias
    if residual is not None:
        y = y + _wide(residual)
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


# ---------------------------------------------------------------------
# CUDA kernel wrappers

def _lib():
    lib = LIBRARIES.get('batch_norm_act')
    if not getattr(lib, '_cmn_typed', False):
        vp, i64, f32p = ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p
        lib.cmn_bn_stats.argtypes = [vp, ctypes.c_int, i64, i64, i64, f32p,
                                     f32p, ctypes.c_float, f32p, f32p, f32p,
                                     vp]
        lib.cmn_bn_stats.restype = ctypes.c_int
        lib.cmn_bn_apply.argtypes = [vp, vp, ctypes.c_int, f32p, f32p, f32p,
                                     f32p, vp, i64, i64, i64, ctypes.c_int,
                                     vp]
        lib.cmn_bn_apply.restype = ctypes.c_int
        lib.cmn_bn_strerror.argtypes = [ctypes.c_int]
        lib.cmn_bn_strerror.restype = ctypes.c_char_p
        lib._cmn_typed = True
    return lib


def _rows_per_chunk(m, c, device):
    """Rows each block walks: enough blocks to fill the card about eight
    blocks deep per SM, a multiple of the row lanes."""
    c_tiles = -(-c // _TILE_C)
    target = max(1, (8 * _common.sm_count(device)) // c_tiles)
    chunks = max(1, min(-(-m // _LANES), target))
    rows = -(-m // chunks)
    return -(-rows // _LANES) * _LANES


def _check_rows(x2d, what):
    if x2d.device.type != 'cuda':
        raise ValueError('%s: the kernel takes CUDA tensors, got %s'
                         % (what, x2d.device))
    if x2d.dim() != 2 or not x2d.is_contiguous():
        raise ValueError('%s: expects a contiguous (M, C) matrix, got shape '
                         '%s strides %s' % (what, tuple(x2d.shape),
                                            x2d.stride()))
    if x2d.shape[0] == 0 or x2d.shape[1] == 0:
        raise ValueError('%s: empty input %s' % (what, tuple(x2d.shape)))
    return _common.dtype_code(x2d, what)


def _check_vec(v, c, device, what):
    if (v.dtype != torch.float32 or v.shape != (c,) or v.device != device
            or not v.is_contiguous()):
        raise ValueError('%s: expects a contiguous float32 (%d,) vector on '
                         '%s, got %s %s on %s' % (what, c, device, v.dtype,
                                                  tuple(v.shape), v.device))


def bn_stats(x2d, eps):
    """Kernel wrapper: per-channel ``(mean, var, rstd)`` in f32 over the
    rows of a CUDA ``(M, C)`` matrix, in two launches (partials per row
    chunk, then a fixed-order sum; every sum compensated).  Replaces
    ``_stats_pallas``."""
    code = _check_rows(x2d, 'bn_stats')
    m, c = x2d.shape
    dev = x2d.device
    rows = _rows_per_chunk(m, c, dev)
    n_chunks = -(-m // rows)
    partials = torch.empty((2, n_chunks, c), dtype=torch.float32, device=dev)
    mean, var, rstd = (torch.empty((c,), dtype=torch.float32, device=dev)
                       for _ in range(3))
    lib = _lib()
    err = lib.cmn_bn_stats(
        _common.ptr(x2d), code, m, c, rows, _common.ptr(partials[0]),
        _common.ptr(partials[1]), float(eps), _common.ptr(mean),
        _common.ptr(var), _common.ptr(rstd), _common.stream_ptr(dev))
    _common.check_launch(err, lib.cmn_bn_strerror, 'bn_stats')
    bn_stats.launches += 1
    return mean, var, rstd


bn_stats.launches = 0


def bn_apply(x2d, res2d, mean, rstd, scale, bias, relu):
    """Kernel wrapper: ``(x - mean) * (rstd * scale) + bias`` (+ res)
    (relu) over a CUDA ``(M, C)`` matrix, output in ``x2d.dtype``.
    Replaces ``_apply_pallas``."""
    code = _check_rows(x2d, 'bn_apply')
    m, c = x2d.shape
    dev = x2d.device
    if res2d is not None and (res2d.shape != x2d.shape
                              or res2d.dtype != x2d.dtype
                              or res2d.device != dev
                              or not res2d.is_contiguous()):
        raise ValueError('bn_apply: residual must match x (%s %s), got %s '
                         '%s' % (tuple(x2d.shape), x2d.dtype,
                                 tuple(res2d.shape), res2d.dtype))
    for v, name in ((mean, 'mean'), (rstd, 'rstd'), (scale, 'scale'),
                    (bias, 'bias')):
        _check_vec(v, c, dev, 'bn_apply ' + name)
    out = torch.empty_like(x2d)
    lib = _lib()
    err = lib.cmn_bn_apply(
        _common.ptr(x2d), _common.ptr(res2d), code, _common.ptr(mean),
        _common.ptr(rstd), _common.ptr(scale), _common.ptr(bias),
        _common.ptr(out), m, c, _rows_per_chunk(m, c, dev), int(relu),
        _common.stream_ptr(dev))
    _common.check_launch(err, lib.cmn_bn_strerror, 'bn_apply')
    bn_apply.launches += 1
    return out


bn_apply.launches = 0


# ---------------------------------------------------------------------
# the differentiable training-mode op

def _rows(x, what):
    if not x.is_contiguous():
        raise ValueError('%s: expects a contiguous (..., C) tensor (a '
                         'channels_last activation permuted to NHWC); '
                         'got strides %s' % (what, x.stride()))
    return x.view(-1, x.shape[-1])


class _BatchNormAct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, scale, bias, residual, eps, relu):
        x2d = _rows(x, 'batch_norm_act')
        res2d = _rows(residual, 'batch_norm_act residual') \
            if residual is not None else None
        scale_f = scale.float().contiguous()
        bias_f = bias.float().contiguous()
        if _common.on_cuda(x, residual, scale, bias):
            mean, var, rstd = bn_stats(x2d, eps)
            out2d = bn_apply(x2d, res2d, mean, rstd, scale_f, bias_f, relu)
        else:
            mean, var, rstd = _batch_stats(x2d, eps)
            out2d = _apply_ref(x2d, mean, rstd, scale_f, bias_f, res2d, relu)
        out = out2d.view(x.shape)
        ctx.relu = relu
        ctx.has_residual = residual is not None
        ctx.save_for_backward(x, scale, mean, rstd, out)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, g_mean, g_var):
        # transcription of the JAX package's _bn_act_bwd
        x, scale, mean, rstd, out = ctx.saved_tensors
        shape = x.shape
        c = shape[-1]
        xf = _wide(x.reshape(-1, c))
        gf = _wide(g.reshape(-1, c))
        m = xf.shape[0]
        xhat = (xf - mean) * rstd          # recomputed, never saved
        gm = gf * (out.reshape(-1, c) > 0) if ctx.relu else gf
        scale_f = _wide(scale)
        dbeta = gm.sum(0)
        dgamma = (gm * xhat).sum(0)
        dx = (scale_f * rstd) * (gm - dbeta / m - xhat * (dgamma / m))
        # closed-form terms of the statistics outputs (zero in training,
        # where they feed only the undifferentiated running averages)
        if g_mean is not None or g_var is not None:
            gmf = _wide(g_mean) if g_mean is not None else 0.0
            gvf = _wide(g_var) if g_var is not None else 0.0
            dx = dx + (gmf + 2.0 * (xf - mean) * gvf) / m
        dres = gm.to(x.dtype).reshape(shape) if ctx.has_residual else None
        return (dx.to(x.dtype).reshape(shape), dgamma.to(scale.dtype),
                dbeta.to(scale.dtype), dres, None, None)


def batch_norm_act(x, scale, bias, eps=1e-5, residual=None, relu=True):
    """Training-mode fused BatchNorm + optional residual add + optional
    relu over the last axis of ``x``.

    Args:
      x: contiguous ``(..., C)`` activation, bf16 or f32.
      scale, bias: ``(C,)`` affine parameters (f32 masters).
      eps: variance epsilon.
      residual: optional ``(..., C)`` tensor added AFTER the affine,
        BEFORE the relu (the ResNet shortcut).
      relu: apply ``max(y, 0)`` as the final step.

    Returns:
      ``(out, batch_mean, batch_var)``; ``out`` has ``x.dtype``, the
      statistics are f32 ``(C,)`` (the running-average update inputs).
    """
    return _BatchNormAct.apply(x, scale, bias, residual, eps, relu)


def batch_norm_act_reference(x, scale, bias, eps=1e-5, residual=None,
                             relu=True):
    """Plain PyTorch oracle, differentiable by autograd; returns
    ``(out, batch_mean, batch_var)`` like :func:`batch_norm_act`."""
    c = x.shape[-1]
    mean, var, rstd = _batch_stats(x.reshape(-1, c), eps)
    out = _apply_ref(x, mean, rstd, scale.float(), bias.float(), residual,
                     relu)
    return out, mean, var


def batch_norm_act_inference(x, scale, bias, mean, var, eps=1e-5,
                             residual=None, relu=True):
    """Inference-mode normalize with RUNNING statistics: an elementwise
    chain of PyTorch ops (the JAX package leaves it to XLA too); f32
    math, output in ``x.dtype``."""
    rstd = torch.rsqrt(var.float() + eps)
    return _apply_ref(x, mean.float(), rstd, scale.float(), bias.float(),
                      residual, relu)
