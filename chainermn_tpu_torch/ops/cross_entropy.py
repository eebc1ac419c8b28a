"""Fused softmax cross-entropy.

Counterpart of ``chainermn_tpu/ops/cross_entropy.py``: per row of a
``(B, V)`` logits matrix the log-sum-exp and the label's logit in one
pass, in float32, without writing a ``(B, V)`` probability matrix;
``loss = lse - logits[label]``.  A label outside ``[0, V)`` picks
nothing, so its ``loss`` is ``lse`` (the JAX kernel's one-hot sum gives
the same): ``lm_loss`` hands over ``pad_id = -1`` targets and masks those
rows afterwards.

On a CUDA tensor :func:`softmax_cross_entropy` launches the hand-written
kernel ``csrc/cross_entropy.cu`` (:func:`ce_forward`); on a CPU tensor it
runs the plain version (:func:`_ce_forward_plain`).  The backward is
PyTorch ops on both, as the JAX package leaves ``_ce_bwd`` to XLA:
``(exp(logits - lse) - onehot) * g`` from the saved ``lse``, in the
logits' dtype.
"""

import ctypes

import torch

from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._build import LIBRARIES


def _pick(logits, labels):
    """``logits[i, labels[i]]`` as f32, 0 where the label is outside
    ``[0, V)`` (``torch.gather`` raises there; the index is clamped and
    the value masked)."""
    v = logits.shape[-1]
    valid = (labels >= 0) & (labels < v)
    idx = labels.clamp(0, v - 1).long()[:, None]
    picked = logits.gather(1, idx)[:, 0].float()
    return torch.where(valid, picked, torch.zeros_like(picked))


def softmax_cross_entropy_reference(logits, labels):
    """Plain oracle: per-example loss, ``(B,)`` float32 (the twin of the
    JAX ``softmax_cross_entropy_reference``)."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    return lse - _pick(logits, labels)


def _ce_forward_plain(logits, labels):
    """The plain forward that also returns ``lse``: max, then the sum of
    ``exp(x - max)``, as the JAX package's fallback forward."""
    lf = logits.float()
    m = lf.amax(-1)
    lse = m + torch.log(torch.exp(lf - m[:, None]).sum(-1))
    return lse - _pick(logits, labels), lse


def _lib():
    lib = LIBRARIES.get('cross_entropy')
    if not getattr(lib, '_cmn_typed', False):
        vp = ctypes.c_void_p
        lib.cmn_cross_entropy.argtypes = [vp, ctypes.c_int, vp, vp, vp,
                                          ctypes.c_int64, ctypes.c_int, vp]
        lib.cmn_cross_entropy.restype = ctypes.c_int
        lib.cmn_ce_strerror.argtypes = [ctypes.c_int]
        lib.cmn_ce_strerror.restype = ctypes.c_char_p
        lib._cmn_typed = True
    return lib


def ce_forward(logits, labels):
    """Kernel wrapper: ``logits`` a contiguous CUDA ``(B, V)`` matrix
    (f32 or bf16), ``labels`` a contiguous int32 ``(B,)`` vector on the
    same device; returns ``(loss, lse)``, both f32 ``(B,)``.  Any ``B``
    (no padding to a multiple of 8 rows).  Replaces ``_ce_pallas``."""
    for t in (logits, labels):
        if t.device.type != 'cuda':
            raise ValueError('ce_forward: the kernel takes CUDA tensors, '
                             'got %s' % t.device)
    if logits.dim() != 2 or not logits.is_contiguous() or \
            logits.numel() == 0:
        raise ValueError('ce_forward: expects a contiguous non-empty (B, V) '
                         'matrix, got shape %s strides %s'
                         % (tuple(logits.shape), logits.stride()))
    b, v = logits.shape
    if v >= 2 ** 31:
        raise ValueError('ce_forward: V = %d does not fit an int32' % v)
    if (labels.shape != (b,) or labels.dtype != torch.int32
            or labels.device != logits.device or not labels.is_contiguous()):
        raise ValueError('ce_forward: labels must be a contiguous int32 '
                         '(%d,) vector on %s, got %s %s on %s'
                         % (b, logits.device, labels.dtype,
                            tuple(labels.shape), labels.device))
    code = _common.dtype_code(logits, 'ce_forward')
    loss = torch.empty(b, dtype=torch.float32, device=logits.device)
    lse = torch.empty(b, dtype=torch.float32, device=logits.device)
    lib = _lib()
    err = lib.cmn_cross_entropy(
        _common.ptr(logits), code, _common.ptr(labels), _common.ptr(loss),
        _common.ptr(lse), b, v, _common.stream_ptr(logits.device))
    _common.check_launch(err, lib.cmn_ce_strerror, 'ce_forward')
    ce_forward.launches += 1
    return loss, lse


ce_forward.launches = 0


class _SoftmaxCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, logits, labels):
        if _common.on_cuda(logits, labels):
            loss, lse = ce_forward(logits.contiguous(),
                                   labels.to(torch.int32).contiguous())
        else:
            loss, lse = _ce_forward_plain(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        v = logits.shape[-1]
        # one (B, V) f32 temporary, updated in place: at (8192, 32000)
        # each further temporary would be another 1 GB
        d = torch.sub(logits, lse[:, None])       # f32: lse is f32
        d.exp_()
        # minus the one-hot: an out-of-range label subtracts 0 at a
        # clamped index (one add per row, so the order is fixed)
        valid = (labels >= 0) & (labels < v)
        d.scatter_add_(1, labels.clamp(0, v - 1).long()[:, None],
                       -valid.to(d.dtype)[:, None])
        d.mul_(g.to(d.dtype)[:, None])
        return d.to(logits.dtype), None


def softmax_cross_entropy(logits, labels):
    """Per-example softmax cross-entropy: ``logits`` ``(B, V)`` (any
    float dtype, widened to f32), ``labels`` ``(B,)`` int -> ``(B,)``
    float32 losses.  Differentiable in ``logits``."""
    if logits.dim() != 2 or labels.shape != logits.shape[:1]:
        raise ValueError('softmax_cross_entropy: expects logits (B, V) and '
                         'labels (B,), got %s and %s'
                         % (tuple(logits.shape), tuple(labels.shape)))
    return _SoftmaxCrossEntropy.apply(logits, labels)
