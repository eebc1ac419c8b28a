"""Fused BatchNorm + activation (+ residual add): one pass per direction.

Counterpart of ``chainermn_tpu/ops/batch_norm_act.py``.  The training-mode
op normalizes with f32 batch statistics over a bf16, f16 or f32 activation,
applies the affine, adds the optional residual and applies the optional
relu, in one pass over the activation.  Its backward recomputes the
normalized value from the saved ``(x, mean, rstd)`` and takes the relu
mask from the sign of the saved OUTPUT, so no activation-sized f32 tensor
crosses the forward/backward boundary.

On a CUDA tensor the op launches three hand-written kernels
(``csrc/batch_norm_act.cu``): :func:`bn_stats` and :func:`bn_apply` in
the forward, :func:`bn_backward` in the backward; the inference-mode op
(:func:`batch_norm_act_inference`, running statistics) is one
:func:`bn_apply`.  On a CPU tensor it
runs their plain PyTorch versions (:func:`_batch_stats`,
:func:`_apply_ref`; :func:`_bwd_sums_ref` and :func:`_bwd_apply_ref`,
the JAX package's ``jnp`` backward split at its per-channel sums).

Layout: the public functions take the JAX package's layout, an
activation ``(..., C)`` with C last and contiguous, viewed without a copy
as ``(M, C)`` rows.  A ``torch.channels_last`` NCHW tensor permuted to
NHWC is such a tensor.  The statistics match ``flax.linen.BatchNorm``:
f32, fast variance ``E[x^2] - E[x]^2`` clipped at zero.
"""

import collections
import ctypes

import torch

from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._build import LIBRARIES

#: the activation types the three kernels take (statistics and sums f32)
BN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_TILE_C = 32   # bn_apply: channels per block (kTileC in the .cu source)
_LANES = 8     # bn_apply: row lanes per block (kLanes in the .cu source)

# bn_stats / bn_backward (kThreads, kMaxTileVec in the .cu source)
_THREADS = 256        # threads a block
_MAX_TILE_VEC = 8     # 16-byte vectors a block covers along C
_BLOCKS_PER_SM = 2    # chunks: about this many blocks per SM in all ...
_MIN_CHUNK_BYTES = 32768   # ... each reading at least this much


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


def _bwd_terms(x2d, g2d, out2d, mean, rstd, relu):
    """The backward's per-element values: ``(x, gm, xhat)`` in the wide
    type, ``gm`` the output gradient masked by the relu (the sign of the
    saved output), ``xhat`` recomputed, never saved."""
    xf = _wide(x2d)
    gf = _wide(g2d)
    gm = gf * (out2d > 0) if relu else gf
    return xf, gm, (xf - mean) * rstd


def _bwd_sums_ref(x2d, g2d, out2d, mean, rstd, relu):
    """Plain version of :func:`bn_backward`'s reduce pass: per channel
    ``(dbeta, dgamma) = (sum gm, sum gm * xhat)``."""
    _, gm, xhat = _bwd_terms(x2d, g2d, out2d, mean, rstd, relu)
    return gm.sum(0), (gm * xhat).sum(0)


def _bwd_apply_ref(x2d, g2d, out2d, mean, rstd, scale, dbeta, dgamma,
                   g_mean, g_var, relu, want_dres):
    """Plain version of :func:`bn_backward`'s elementwise pass, in the
    kernel's rounding order: ``dx`` (in ``x2d.dtype``) of the JAX
    package's ``_bn_act_bwd`` from the sums, and the residual's gradient
    ``gm`` (None unless ``want_dres``).  ``g_mean`` / ``g_var`` are the
    statistics outputs' cotangents, None when zero.  Divisions by the row
    count divide by a tensor: on CUDA, PyTorch multiplies by the
    reciprocal of a Python scalar divisor, which rounds otherwise."""
    xf, gm, xhat = _bwd_terms(x2d, g2d, out2d, mean, rstd, relu)
    m = torch.full_like(dbeta, xf.shape[0])
    dx = (_wide(scale) * rstd) * (gm - dbeta / m - xhat * (dgamma / m))
    # closed-form terms of the statistics outputs (zero in training,
    # where they feed only the undifferentiated running averages)
    if g_mean is not None or g_var is not None:
        gmf = _wide(g_mean) if g_mean is not None else 0.0
        gvf = _wide(g_var) if g_var is not None else 0.0
        dx = dx + (gmf + 2.0 * (xf - mean) * gvf) / m
    return dx.to(x2d.dtype), gm.to(x2d.dtype) if want_dres else None


# ---------------------------------------------------------------------
# CUDA kernel wrappers

def _lib():
    lib = LIBRARIES.get('batch_norm_act')
    if not getattr(lib, '_cmn_typed', False):
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        plan = [i64, i64, ci, ci, ci, ci, i64, ci]
        lib.cmn_bn_stats.argtypes = [vp, ci, *plan, vp, vp, ctypes.c_float,
                                     vp, vp, vp, vp]
        lib.cmn_bn_stats.restype = ci
        lib.cmn_bn_apply.argtypes = [vp, vp, ci, vp, vp, vp, vp, vp, i64,
                                     i64, i64, ci, vp]
        lib.cmn_bn_apply.restype = ci
        lib.cmn_bn_backward.argtypes = [vp, vp, vp, ci, *plan, vp, vp, vp,
                                        vp, vp, ci, vp, vp, vp, vp, vp, vp,
                                        vp]
        lib.cmn_bn_backward.restype = ci
        lib.cmn_bn_strerror.argtypes = [ci]
        lib.cmn_bn_strerror.restype = ctypes.c_char_p
        lib._cmn_typed = True
    return lib


def _rows_per_chunk(m, c, device):
    """:func:`bn_apply`'s rows a block: enough blocks to fill the card
    about eight blocks deep per SM, a multiple of the row lanes."""
    c_tiles = -(-c // _TILE_C)
    target = max(1, (8 * _common.sm_count(device)) // c_tiles)
    chunks = max(1, min(-(-m // _LANES), target))
    rows = -(-m // chunks)
    return -(-rows // _LANES) * _LANES


#: how a :func:`bn_stats` / :func:`bn_backward` launch covers ``(M, C)``:
#: ``vec`` elements a load (16 bytes' worth, or 1 when C or a pointer is
#: not aligned to it), channel tiles of ``tcv`` vectors (``n_ctiles`` of
#: them; the last may be ragged), ``lanes`` row lanes a block, chunks of
#: ``rows`` rows (``n_chunks``; the last may be short)
Plan = collections.namedtuple(
    'Plan', 'm c vec tcv lanes n_ctiles rows n_chunks')


def _plan(m, c, itemsize, aligned, sms):
    """The launch plan of the column-sum kernels.  A block covers at most
    128 bytes of a row (``_MAX_TILE_VEC`` vectors), so its threads read
    16 bytes each, neighbours on neighbouring addresses, and at C = 32
    bf16 a warp reads 8 rows at once.  Chunks are sized by the bytes a
    tile reads: about ``_BLOCKS_PER_SM`` blocks per SM in all, each
    reading at least ``_MIN_CHUNK_BYTES``, so the last block of a tile
    sums few partials."""
    full = 16 // itemsize
    vec = full if aligned and c % full == 0 else 1
    cv = c // vec
    n_ctiles = -(-cv // _MAX_TILE_VEC)
    tcv = -(-cv // n_ctiles)
    lanes = _THREADS // tcv
    row_bytes = tcv * vec * itemsize
    by_wave = max(1, _BLOCKS_PER_SM * sms // n_ctiles)
    by_bytes = max(1, m * row_bytes // _MIN_CHUNK_BYTES)
    rows = -(-m // min(by_wave, by_bytes, m))
    return Plan(m, c, vec, tcv, lanes, n_ctiles, rows, -(-m // rows))


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
    return _common.dtype_code(x2d, what, BN_DTYPES)


def _check_like(t, x2d, what):
    """``t`` must be a contiguous matrix of ``x2d``'s shape, dtype and
    device."""
    if (t.shape != x2d.shape or t.dtype != x2d.dtype
            or t.device != x2d.device or not t.is_contiguous()):
        raise ValueError('%s must be a contiguous %s %s on %s like x, got '
                         '%s %s on %s' % (what, x2d.dtype,
                                          tuple(x2d.shape), x2d.device,
                                          t.dtype, tuple(t.shape), t.device))


def _check_vec(v, c, device, what):
    if (v.dtype != torch.float32 or v.shape != (c,) or v.device != device
            or not v.is_contiguous()):
        raise ValueError('%s: expects a contiguous float32 (%d,) vector on '
                         '%s, got %s %s on %s' % (what, c, device, v.dtype,
                                                  tuple(v.shape), v.device))


def _launch_plan(*operands):
    """The plan of a launch over the (M, C) operands (16-byte loads when
    every operand's address allows them) and its scratch: the chunks'
    compensated partials and the tiles' ticket counters."""
    x2d = operands[0]
    m, c = x2d.shape
    dev = x2d.device
    aligned = all(t.data_ptr() % 16 == 0 for t in operands)
    plan = _plan(m, c, x2d.element_size(), aligned, _common.sm_count(dev))
    part = torch.empty((4, plan.n_chunks, c), dtype=torch.float32,
                       device=dev)
    return plan, part, _common.tickets(dev, plan.n_ctiles)


def bn_stats(x2d, eps):
    """Kernel wrapper: per-channel ``(mean, var, rstd)`` in f32 over the
    rows of a CUDA ``(M, C)`` matrix, in one launch (chunk partials, the
    last block of each channel tile sums them in a fixed order; every sum
    compensated).  Replaces ``_stats_pallas``."""
    code = _check_rows(x2d, 'bn_stats')
    c = x2d.shape[1]
    dev = x2d.device
    plan, part, tickets = _launch_plan(x2d)
    mean, var, rstd = (torch.empty((c,), dtype=torch.float32, device=dev)
                       for _ in range(3))
    lib = _lib()
    err = lib.cmn_bn_stats(
        _common.ptr(x2d), code, *plan, _common.ptr(part),
        _common.ptr(tickets), float(eps), _common.ptr(mean),
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
    if res2d is not None:
        _check_like(res2d, x2d, 'bn_apply: residual')
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


def bn_backward(x2d, g2d, out2d, mean, rstd, scale, g_mean, g_var, relu,
                want_dres):
    """Kernel wrapper: the fused op's backward over CUDA ``(M, C)``
    matrices -- ``x2d`` the saved input, ``g2d`` the output's gradient,
    ``out2d`` the saved output (its sign is the relu mask) -- in one call
    of two launches: the per-channel sums ``dbeta`` / ``dgamma`` on
    :func:`bn_stats`' reduction, then ``dx`` and the residual's gradient
    in one elementwise pass.  ``g_mean`` / ``g_var``: the statistics
    outputs' cotangents, None when zero.  Returns ``(dx, dgamma, dbeta,
    dres)``: ``dx`` and ``dres`` (None unless ``want_dres``) in
    ``x2d.dtype``, the sums f32.  Computes the JAX package's ``jnp``
    ``_bn_act_bwd``."""
    what = 'bn_backward'
    code = _check_rows(x2d, what)
    c = x2d.shape[1]
    dev = x2d.device
    _check_like(g2d, x2d, what + ': g')
    _check_like(out2d, x2d, what + ': out')
    for v, name in ((mean, 'mean'), (rstd, 'rstd'), (scale, 'scale'),
                    (g_mean, 'g_mean'), (g_var, 'g_var')):
        if v is not None:
            _check_vec(v, c, dev, '%s %s' % (what, name))
    plan, part, tickets = _launch_plan(x2d, g2d, out2d)
    dx = torch.empty_like(x2d)
    dres = torch.empty_like(x2d) if want_dres else None
    dbeta, dgamma = (torch.empty((c,), dtype=torch.float32, device=dev)
                     for _ in range(2))
    lib = _lib()
    err = lib.cmn_bn_backward(
        _common.ptr(x2d), _common.ptr(g2d), _common.ptr(out2d), code, *plan,
        _common.ptr(mean), _common.ptr(rstd), _common.ptr(scale),
        _common.ptr(g_mean), _common.ptr(g_var), int(relu),
        _common.ptr(part), _common.ptr(tickets), _common.ptr(dbeta),
        _common.ptr(dgamma), _common.ptr(dx), _common.ptr(dres),
        _common.stream_ptr(dev))
    _common.check_launch(err, lib.cmn_bn_strerror, what)
    bn_backward.launches += 1
    return dx, dgamma, dbeta, dres


bn_backward.launches = 0


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
        ctx.set_materialize_grads(False)
        ctx.relu = relu
        ctx.has_residual = residual is not None
        ctx.save_for_backward(x, scale, mean, rstd, out)
        return out, mean, var

    @staticmethod
    def backward(ctx, g, g_mean, g_var):
        # the JAX package's _bn_act_bwd; a cotangent that autograd leaves
        # unmaterialized (None) is zero
        x, scale, mean, rstd, out = ctx.saved_tensors
        shape = x.shape
        c = shape[-1]
        if g is None:
            g = torch.zeros_like(x)
        x2d, out2d = x.view(-1, c), out.view(-1, c)
        g2d = g.reshape(-1, c)
        if _common.on_cuda(x, g, scale, g_mean, g_var):
            dx, dgamma, dbeta, dres = bn_backward(
                x2d, g2d.contiguous(), out2d, mean, rstd,
                scale.float().contiguous(),
                None if g_mean is None else g_mean.float().contiguous(),
                None if g_var is None else g_var.float().contiguous(),
                ctx.relu, ctx.has_residual)
        else:
            dbeta, dgamma = _bwd_sums_ref(x2d, g2d, out2d, mean, rstd,
                                          ctx.relu)
            dx, dres = _bwd_apply_ref(x2d, g2d, out2d, mean, rstd, scale,
                                      dbeta, dgamma, g_mean, g_var, ctx.relu,
                                      ctx.has_residual)
        return (dx.view(shape), dgamma.to(scale.dtype),
                dbeta.to(scale.dtype),
                dres.view(shape) if dres is not None else None, None, None)


def batch_norm_act(x, scale, bias, eps=1e-5, residual=None, relu=True):
    """Training-mode fused BatchNorm + optional residual add + optional
    relu over the last axis of ``x``.

    Args:
      x: contiguous ``(..., C)`` activation, bf16, f16 or f32.
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
    """Inference-mode normalize with RUNNING statistics over the last axis
    of a contiguous ``(..., C)`` ``x``: ``(x - mean) * (rstd * scale) +
    bias`` (+ residual) (relu) with ``rstd = rsqrt(var + eps)``, f32 math,
    output in ``x.dtype``.

    On CUDA tensors it is one :func:`bn_apply` launch (the per-channel
    ``rstd`` and the f32 vectors are formed first); on CPU tensors it runs
    the plain version, :func:`_apply_ref`.  The JAX package leaves this
    chain to XLA, so this is the same function on a kernel the port
    already has.  Forward-only."""
    rstd = torch.rsqrt(var.float() + eps)
    mean_f, scale_f, bias_f = mean.float(), scale.float(), bias.float()
    if not _common.on_cuda(x, residual, scale, bias, mean, var):
        return _apply_ref(x, mean_f, rstd, scale_f, bias_f, residual, relu)
    _common.forbid_grad('batch_norm_act_inference', x, residual, scale,
                        bias)
    x2d = _rows(x, 'batch_norm_act_inference')
    res2d = (_rows(residual, 'batch_norm_act_inference residual')
             if residual is not None else None)
    out2d = bn_apply(x2d, res2d, mean_f.contiguous(), rstd.contiguous(),
                     scale_f.contiguous(), bias_f.contiguous(), relu)
    return out2d.view(x.shape)
