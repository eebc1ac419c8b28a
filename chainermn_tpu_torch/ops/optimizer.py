"""Fused momentum-SGD update.

Counterpart of ``chainermn_tpu/ops/optimizer.py``: the velocity update
and the parameter step in one elementwise pass per parameter tensor, so
each gradient is read once.  Exposed two ways:

- :func:`momentum_sgd` -- functional, over lists of tensors;
- :class:`FusedMomentumSGD` -- a ``torch.optim.Optimizer`` (the
  counterpart of ``fused_momentum_sgd``).

The arithmetic is that of the JAX package's ``_sgd_kernel`` followed by
``optax.apply_updates``: ``v' = mu * v + g`` with ``v`` float32 and never
narrowed, then ``p <- p + (-lr * v')`` with the step cast to ``g``'s
dtype and then to ``p``'s.  Unlike the JAX version, the update runs IN
PLACE on ``p`` and ``v``.

On CUDA tensors each parameter's update launches the hand-written kernel
``csrc/momentum_sgd.cu`` (:func:`sgd_update`); on CPU tensors it runs the
plain version (:func:`_sgd_update_ref`).
"""

import ctypes

import torch

from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._build import LIBRARIES


def _sgd_update_ref(p, g, v, lr, momentum):
    """Plain version of :func:`sgd_update` (in place on ``p``, ``v``)."""
    v_new = momentum * v + g.float()
    v.copy_(v_new)
    p.add_((-lr * v_new).to(g.dtype).to(p.dtype))


def _lib():
    lib = LIBRARIES.get('momentum_sgd')
    if not getattr(lib, '_cmn_typed', False):
        vp = ctypes.c_void_p
        lib.cmn_momentum_sgd.argtypes = [vp, ctypes.c_int, vp, vp,
                                         ctypes.c_int, ctypes.c_int64,
                                         ctypes.c_float, ctypes.c_float,
                                         ctypes.c_int, vp]
        lib.cmn_momentum_sgd.restype = ctypes.c_int
        lib.cmn_sgd_strerror.argtypes = [ctypes.c_int]
        lib.cmn_sgd_strerror.restype = ctypes.c_char_p
        lib._cmn_typed = True
    return lib


def _dense(t):
    return t.is_contiguous() or (
        t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last))


def _order(t):
    """Strides of the dims that have more than one element: two dense
    tensors of one shape with equal orders lay out their elements
    alike (the strides of size-1 dims are arbitrary)."""
    return tuple(st for sz, st in zip(t.shape, t.stride()) if sz != 1)


def sgd_update(p, g, v, lr, momentum):
    """Kernel wrapper: one in-place heavy-ball step of CUDA tensor ``p``
    with gradient ``g`` and f32 velocity ``v``.  The three must share
    shape, element order and device, and be dense (contiguous or
    channels_last), so the kernel walks them as flat arrays.  Replaces
    ``_leaf_update_pallas``."""
    if p.device.type != 'cuda':
        raise ValueError('sgd_update: the kernel takes CUDA tensors, got %s'
                         % p.device)
    for t, name in ((p, 'param'), (g, 'grad'), (v, 'velocity')):
        if t.device != p.device:
            raise ValueError('sgd_update: %s must be on %s, got %s'
                             % (name, p.device, t.device))
        if t.shape != p.shape or _order(t) != _order(p) or not _dense(t):
            raise ValueError(
                'sgd_update: %s must be dense with the param\'s shape and '
                'strides %s %s, got %s %s' % (name, tuple(p.shape),
                                              p.stride(), tuple(t.shape),
                                              t.stride()))
    if v.dtype != torch.float32:
        raise TypeError('sgd_update: velocity must be float32, got %s'
                        % v.dtype)
    n = p.numel()
    if n == 0:
        return
    blocks = max(1, min(-(-n // 256), 8 * _common.sm_count(p.device)))
    lib = _lib()
    err = lib.cmn_momentum_sgd(
        _common.ptr(g), _common.dtype_code(g, 'sgd_update grad'),
        _common.ptr(v), _common.ptr(p),
        _common.dtype_code(p, 'sgd_update param'), n, float(lr),
        float(momentum), blocks, _common.stream_ptr(p.device))
    _common.check_launch(err, lib.cmn_sgd_strerror, 'sgd_update')
    sgd_update.launches += 1


sgd_update.launches = 0


@torch.no_grad()
def momentum_sgd(params, grads, velocity, lr, momentum=0.9):
    """One fused update over lists of tensors, IN PLACE on ``params``
    and ``velocity``; returns ``(params, velocity)``.  Matches
    ``optax.sgd(lr, momentum)`` (heavy-ball ``v = mu*v + g; p -= lr*v``)."""
    for p, g, v in zip(params, grads, velocity, strict=True):
        if _common.on_cuda(p, g, v):
            sgd_update(p, g, v, lr, momentum)
        else:
            _sgd_update_ref(p, g, v, lr, momentum)
    return params, velocity


class FusedMomentumSGD(torch.optim.Optimizer):
    """Fused momentum SGD: each ``step()`` updates every parameter that
    has a gradient in place, launching one kernel per CUDA parameter.
    The per-parameter state is ``'velocity'``, float32 whatever the
    parameter's dtype."""

    def __init__(self, params, lr, momentum=0.9):
        if lr < 0.0:
            raise ValueError('invalid learning rate %r' % lr)
        super().__init__(params, dict(lr=lr, momentum=momentum))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            ps, gs, vs = [], [], []
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if 'velocity' not in state:
                    state['velocity'] = torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.preserve_format)
                ps.append(p)
                gs.append(p.grad)
                vs.append(state['velocity'])
            momentum_sgd(ps, gs, vs, group['lr'], group['momentum'])
        return loss
