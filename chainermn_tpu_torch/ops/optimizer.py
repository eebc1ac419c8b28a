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

On CUDA tensors the update of a whole list of tensors is one launch of
the hand-written kernel ``csrc/momentum_sgd.cu``, which walks a table of
the tensors (one launch for each pair of gradient and parameter dtypes;
:func:`sgd_table`); on CPU tensors it runs the plain version
(:func:`_sgd_update_ref`) tensor by tensor.
"""

import array
import ctypes

import torch

from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._build import LIBRARIES


def _sgd_update_ref(p, g, v, lr, momentum):
    """Plain version of one tensor's update (in place on ``p``, ``v``)."""
    v_new = momentum * v + g.float()
    v.copy_(v_new)
    p.add_((-lr * v_new).to(g.dtype).to(p.dtype))


def _lib():
    lib = LIBRARIES.get('momentum_sgd')
    if not getattr(lib, '_cmn_typed', False):
        lib.cmn_momentum_sgd.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.POINTER(ctypes.c_int), ctypes.c_void_p]
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


def _check_operands(p, g, v):
    """The kernel's demands on one tensor's operands: the three share
    shape, element order and device and are dense (contiguous or
    channels_last), so the kernel walks them as flat arrays; the
    velocity is float32."""
    for t, name in ((p, 'param'), (g, 'grad'), (v, 'velocity')):
        if t.device != p.device:
            raise ValueError('momentum_sgd: %s must be on %s, got %s'
                             % (name, p.device, t.device))
        if t.shape != p.shape or _order(t) != _order(p) or not _dense(t):
            raise ValueError(
                'momentum_sgd: %s must be dense with the param\'s shape and '
                'strides %s %s, got %s %s' % (name, tuple(p.shape),
                                              p.stride(), tuple(t.shape),
                                              t.stride()))
    if v.dtype != torch.float32:
        raise TypeError('momentum_sgd: velocity must be float32, got %s'
                        % v.dtype)


def sgd_table(params, grads, velocity):
    """The kernel's table: ``{(grad dtype code, param dtype code): rows}``
    where ``rows`` is an int64 ``array`` of 4 entries a tensor (its
    gradient's, velocity's and parameter's data pointers and its element
    count), the tensors of each group in the lists' order, empty ones
    left out.  One launch takes one group.  Checks nothing but the
    dtypes: the callers have checked the operands."""
    groups = {}
    codes = {d: _common.DTYPE_CODES[d] for d in _common.KERNEL_DTYPES}
    for p, g, v in zip(params, grads, velocity, strict=True):
        n = p.numel()
        if not n:
            continue
        key = (codes.get(g.dtype), codes.get(p.dtype))
        if None in key:
            raise TypeError('momentum_sgd: grad %s, param %s: the kernel '
                            'takes float32 or bfloat16' % (g.dtype, p.dtype))
        rows = groups.get(key)
        if rows is None:
            rows = groups[key] = array.array('q')
        rows.extend((g.data_ptr(), v.data_ptr(), p.data_ptr(), n))
    return groups


def _launch(groups, lr, momentum, device):
    """One kernel launch per group of :func:`sgd_table` (more for a group
    of more tensors than a launch's table holds)."""
    lib = _lib()
    stream = _common.stream_ptr(device)
    for (g_code, p_code), rows in groups.items():
        n = len(rows) // 4
        launches = ctypes.c_int(0)
        err = lib.cmn_momentum_sgd(
            ctypes.cast(rows.buffer_info()[0],
                        ctypes.POINTER(ctypes.c_int64)), n, g_code, p_code,
            float(lr), float(momentum), ctypes.byref(launches), stream)
        momentum_sgd.launches += launches.value
        momentum_sgd.tensors += n
        _common.check_launch(err, lib.cmn_sgd_strerror, 'momentum_sgd')


def sgd_update(p, g, v, lr, momentum):
    """Kernel wrapper, one tensor: one in-place heavy-ball step of CUDA
    tensor ``p`` with gradient ``g`` and f32 velocity ``v`` -- the kernel
    of :func:`momentum_sgd` with a table of one."""
    if p.device.type != 'cuda':
        raise ValueError('sgd_update: the kernel takes CUDA tensors, got %s'
                         % p.device)
    _check_operands(p, g, v)
    _launch(sgd_table([p], [g], [v]), lr, momentum, p.device)


@torch.no_grad()
def momentum_sgd(params, grads, velocity, lr, momentum=0.9):
    """One fused update over lists of tensors, IN PLACE on ``params``
    and ``velocity``; returns ``(params, velocity)``.  Matches
    ``optax.sgd(lr, momentum)`` (heavy-ball ``v = mu*v + g; p -= lr*v``).
    Kernel wrapper: on CUDA tensors one launch updates them all (one for
    each pair of gradient and parameter dtypes), counted in
    ``momentum_sgd.launches`` and, by tensor, ``momentum_sgd.tensors``.
    Replaces ``_leaf_update_pallas``."""
    ps, gs, vs = list(params), list(grads), list(velocity)
    if len(ps) != len(gs) or len(ps) != len(vs):
        raise ValueError('momentum_sgd: %d params, %d grads, %d velocities'
                         % (len(ps), len(gs), len(vs)))
    if ps and _common.on_cuda(*ps, *gs, *vs):
        for p, g, v in zip(ps, gs, vs):
            _check_operands(p, g, v)
        _launch(sgd_table(ps, gs, vs), lr, momentum, ps[0].device)
    else:
        for p, g, v in zip(ps, gs, vs):
            _sgd_update_ref(p, g, v, lr, momentum)
    return params, velocity


momentum_sgd.launches = 0
momentum_sgd.tensors = 0


class FusedMomentumSGD(torch.optim.Optimizer):
    """Fused momentum SGD: each ``step()`` updates every parameter that
    has a gradient in place, in one kernel launch for all the CUDA
    parameters of a param group.  The per-parameter state is
    ``'velocity'``, float32 whatever the parameter's dtype; a parameter's
    layout is checked once, when its velocity is made, and each step
    checks only that its gradient has the parameter's shape and strides.

    ``lr`` is a number or a schedule, ``step -> lr`` (e.g.
    ``utils.distributed_sgd_schedule``).  A schedule is read at the
    update count of the group's first stepped parameter, kept in its
    state as ``'step'`` and 0 at the first update, as optax's ``count``
    (``optax.sgd(schedule, momentum)`` computes what this optimizer
    computes; with a number, the state is the JAX
    ``fused_momentum_sgd``'s, ``'velocity'`` alone).
    """

    def __init__(self, params, lr, momentum=0.9):
        if not callable(lr) and lr < 0.0:
            raise ValueError('invalid learning rate %r' % lr)
        super().__init__(params, dict(lr=lr, momentum=momentum))
        # param -> (shape, strides, element order), checked once
        self._layouts = {}

    def _first_use(self, p):
        """Make ``p``'s velocity and check, once, that the kernel can walk
        the two as flat arrays; returns ``p``'s layout."""
        state = self.state[p]
        if 'velocity' not in state:
            state['velocity'] = torch.zeros_like(
                p, dtype=torch.float32, memory_format=torch.preserve_format)
        if p.is_cuda:
            _check_operands(p, p, state['velocity'])
        layout = self._layouts[p] = (p.shape, p.stride(), _order(p))
        return layout

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            ps, gs, vs = [], [], []
            for p in group['params']:
                g = p.grad
                if g is None:
                    continue
                layout = self._layouts.get(p) or self._first_use(p)
                if g.shape != layout[0] or (g.stride() != layout[1]
                                            and _order(g) != layout[2]):
                    raise ValueError(
                        'FusedMomentumSGD: a grad %s %s does not match its '
                        'param %s %s' % (tuple(g.shape), g.stride(),
                                         tuple(layout[0]), layout[1]))
                ps.append(p)
                gs.append(g)
                vs.append(self.state[p]['velocity'])
            if not ps:
                continue
            lr = schedule = group['lr']
            if callable(schedule):
                lr = schedule(int(self.state[ps[0]].get('step', 0)))
            if _common.on_cuda(*ps, *vs):
                _launch(sgd_table(ps, gs, vs), lr, group['momentum'],
                        ps[0].device)
            else:
                momentum_sgd(ps, gs, vs, lr, group['momentum'])
            if callable(schedule):
                for p in ps:
                    state = self.state[p]
                    state['step'] = int(state.get('step', 0)) + 1
        return loss
