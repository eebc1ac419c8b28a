"""LayerNorm over the last axis.

Counterpart of ``chainermn_tpu/ops/layer_norm.py``: per row, the mean
and the variance of the centred values in float32, ``(x - mean) *
rsqrt(var + eps) * gamma + beta`` with ``gamma`` / ``beta`` widened to
float32, written in ``x.dtype``.  ``eps`` defaults to 1e-6, the JAX
package's value (``torch.nn.LayerNorm`` uses 1e-5).

On a CUDA tensor :func:`layer_norm` launches the hand-written kernel
``csrc/layer_norm.cu`` (:func:`ln_forward`); on a CPU tensor it runs the
plain version (:func:`layer_norm_reference`).

The backward is the closed form of the JAX package's ``_ln_bwd`` in
PyTorch ops on both devices (the JAX package has no LayerNorm backward
kernel either): the statistics are recomputed in float32 from the saved
``x``, ``dx`` comes back in ``x.dtype``, ``dgamma`` and ``dbeta`` in
``gamma.dtype``.
"""

import ctypes

import torch

from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._build import LIBRARIES

MAX_D = 1024   # 32 lanes x 32 values held in registers per row


def layer_norm_reference(x, gamma, beta, eps=1e-6):
    """Plain version: f32 statistics, two passes, output in ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _lib():
    lib = LIBRARIES.get('layer_norm')
    if not getattr(lib, '_cmn_typed', False):
        vp = ctypes.c_void_p
        lib.cmn_layer_norm.argtypes = [vp, ctypes.c_int, vp, vp, ctypes.c_int,
                                       vp, ctypes.c_int64, ctypes.c_int,
                                       ctypes.c_float, vp]
        lib.cmn_layer_norm.restype = ctypes.c_int
        lib.cmn_ln_strerror.argtypes = [ctypes.c_int]
        lib.cmn_ln_strerror.restype = ctypes.c_char_p
        lib._cmn_typed = True
    return lib


def ln_forward(x2d, gamma, beta, eps=1e-6):
    """Kernel wrapper: LayerNorm of the rows of a contiguous CUDA ``(N,
    D)`` matrix (bf16 or f32), ``gamma`` / ``beta`` contiguous ``(D,)``
    bf16 or f32; returns a new ``(N, D)`` tensor of ``x2d.dtype``.
    Replaces ``_ln_pallas``."""
    if x2d.device.type != 'cuda':
        raise ValueError('ln_forward: the kernel takes CUDA tensors, got %s'
                         % x2d.device)
    if x2d.dim() != 2 or not x2d.is_contiguous() or x2d.shape[0] == 0:
        raise ValueError('ln_forward: expects a contiguous non-empty (N, D) '
                         'matrix, got shape %s strides %s'
                         % (tuple(x2d.shape), x2d.stride()))
    n, d = x2d.shape
    if not 0 < d <= MAX_D:
        raise ValueError('ln_forward: D = %d outside 1..%d' % (d, MAX_D))
    x_code = _common.dtype_code(x2d, 'ln_forward x')
    g_code = _common.dtype_code(gamma, 'ln_forward gamma')
    for v, what in ((gamma, 'gamma'), (beta, 'beta')):
        if (v.shape != (d,) or v.dtype != gamma.dtype
                or v.device != x2d.device or not v.is_contiguous()):
            raise ValueError('ln_forward: %s must be a contiguous (%d,) '
                             'vector of one dtype on %s, got %s %s on %s'
                             % (what, d, x2d.device, tuple(v.shape),
                                v.dtype, v.device))
    out = torch.empty_like(x2d)
    lib = _lib()
    err = lib.cmn_layer_norm(
        _common.ptr(x2d), x_code, _common.ptr(gamma), _common.ptr(beta),
        g_code, _common.ptr(out), n, d, float(eps),
        _common.stream_ptr(x2d.device))
    _common.check_launch(err, lib.cmn_ln_strerror, 'ln_forward')
    ln_forward.launches += 1
    return out


ln_forward.launches = 0


class _LayerNorm(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma)
        ctx.eps = eps
        if not _common.on_cuda(x, gamma, beta):
            return layer_norm_reference(x, gamma, beta, eps)
        d = x.shape[-1]
        out = ln_forward(x.reshape(-1, d).contiguous(), gamma.contiguous(),
                         beta.contiguous(), eps)
        return out.view(x.shape)

    @staticmethod
    def backward(ctx, g):
        x, gamma = ctx.saved_tensors
        d = x.shape[-1]
        xf = x.reshape(-1, d).float()
        gf = g.reshape(-1, d).float()
        xc = xf - xf.mean(-1, keepdim=True)
        rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + ctx.eps)
        xhat = xc * rstd
        dgamma = (gf * xhat).sum(0)
        dbeta = gf.sum(0)
        gy = gf * gamma.float()
        dx = rstd * (gy - gy.mean(-1, keepdim=True)
                     - xhat * (gy * xhat).mean(-1, keepdim=True))
        return (dx.reshape(x.shape).to(x.dtype), dgamma.to(gamma.dtype),
                dbeta.to(gamma.dtype), None)


def layer_norm(x, gamma, beta, eps=1e-6):
    """LayerNorm over the last axis.  ``x`` ``(..., D)``, ``gamma`` /
    ``beta`` ``(D,)``; returns ``x.dtype``.  Differentiable in all
    three."""
    return _LayerNorm.apply(x, gamma, beta, eps)
