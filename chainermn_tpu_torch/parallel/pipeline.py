"""Micro-batched pipeline parallelism: the GPipe and 1F1B schedules.

Counterpart of ``chainermn_tpu/parallel/pipeline.py``.  The JAX pipeline
is one SPMD program: a ``lax.scan`` of ticks whose carry rotates
activations stage to stage with ``ppermute``, every stage running every
tick and masking the slots that hold no micro-batch.  Here one process
owns one stage: the stage axis (``'stage'``, or a plan's ``'pipe'``) is a
line of processes in the bound mesh, and each schedule is an explicit
loop over the same ticks with the same arithmetic for which micro-batch
a stage works on at tick ``t``:

- GPipe: the forward of micro ``m`` runs on stage ``s`` at ``t = m + s``
  (``M + S - 1`` ticks); the backward runs the ticks in reverse, micro
  ``m`` at ``t = m + s`` again, from the last micro-batch to the first
  (the order in which JAX's transposed scan adds the gradients);
- 1F1B: the forward of micro ``m`` at ``t = m + s``, its backward at ``t
  = m + 2S - 1 - s`` (``M + 2S - 1`` ticks); a stage keeps a ring of
  ``2S`` micro-batch inputs and recomputes the forward under autograd at
  the backward slot, accumulating from the first micro-batch to the last.

A tick ends with one exchange between neighbours on the stage line
(``torch.distributed.batch_isend_irecv``): activations to ``s + 1``,
cotangents to ``s - 1``.  Both ends derive each transfer from the same
arithmetic, so a stage posts a send exactly when its neighbour posts the
receive.  Slots that JAX computes and masks are skipped, and so is the
last stage's 1F1B forward slot, whose output no stage reads (JAX rotates
it to stage 0, which discards it).  The backward of each micro-batch is
driven from the loop (``torch.autograd.backward`` on its saved graph), so
every transfer is issued by the loop's thread, in order; no backward
crosses a process boundary.

Stages must be shape-homogeneous (activations keep the micro-batch
input's shape and dtype), as in the JAX package; the heterogeneous
general-DAG surface is :class:`chainermn_tpu_torch.MultiNodeChainList`.
The bubble accounting (:func:`schedule_ticks`, :func:`bubble_fraction`)
is the JAX arithmetic, copied.
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.parallel.meshplan import (
    _BOUND, _names, resolve_axis)


# ---------------------------------------------------------------------
# trees (nested dicts of tensors)

def tree_map(fn, *trees):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree):
    """The leaves of nested dicts, keys in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def stack_stage_params(params_per_stage):
    """Stack per-stage parameter trees along a new leading dim (numpy
    arrays or tensors), the layout a stage spec's leading ``pipe`` entry
    cuts."""
    def stack(*leaves):
        if isinstance(leaves[0], torch.Tensor):
            return torch.stack(leaves)
        return np.stack([np.asarray(v) for v in leaves])
    return tree_map(stack, *params_per_stage)


def microbatch(x, n_micro):
    """``(B, ...) -> (n_micro, B // n_micro, ...)``."""
    if x.shape[0] % n_micro:
        raise ValueError('batch %d not divisible into %d micro-batches'
                         % (x.shape[0], n_micro))
    return x.reshape((n_micro, x.shape[0] // n_micro) + tuple(x.shape[1:]))


# ---------------------------------------------------------------------
# schedule accounting: the pipeline bubble (the JAX arithmetic)

def schedule_ticks(n_micro, n_stages, schedule='1f1b'):
    """Total ticks of one pipelined step: ``M + S - 1`` for the gpipe
    forward (its backward runs the same ticks reversed), ``M + 2S - 1``
    for the combined forward and backward of 1F1B."""
    if schedule == 'gpipe':
        return n_micro + n_stages - 1
    if schedule == '1f1b':
        return n_micro + 2 * n_stages - 1
    raise ValueError("schedule must be 'gpipe' or '1f1b', got %r"
                     % (schedule,))


def bubble_fraction(n_micro, n_stages, schedule='1f1b'):
    """Fraction of a stage's work slots that are idle in one step, in
    ``[0, 1)``: ``(S - 1) / (M + S - 1)`` under gpipe, ``(2S - 1) / (M +
    2S - 1)`` under 1F1B (a forward and a backward slot a tick).
    Strictly decreasing in ``n_micro``."""
    if n_micro < 1 or n_stages < 1:
        raise ValueError('n_micro and n_stages must be >= 1, got '
                         '%d, %d' % (n_micro, n_stages))
    ticks = schedule_ticks(n_micro, n_stages, schedule)
    slots_per_tick = 1 if schedule == 'gpipe' else 2
    busy = slots_per_tick * n_micro
    return 1.0 - busy / float(slots_per_tick * ticks)


def bubble_fractions_per_stage(n_micro, n_stages, schedule='1f1b'):
    """Per-stage bubble fractions (a list of ``n_stages``): every stage
    holds the same valid work, so the values coincide."""
    b = bubble_fraction(n_micro, n_stages, schedule)
    return [b] * n_stages


# ---------------------------------------------------------------------
# the stage line and its tick exchange

class StageLine:
    """The stage axis as this process sees it: ``n_stages`` processes,
    this one stage ``stage``, its neighbours' global ranks ``prev`` /
    ``next`` (None at the ends)."""

    def __init__(self, axis):
        ax = resolve_axis(axis)
        self.axis, self.n_stages, self.stage = axis, ax.size, ax.index
        s = self.stage
        self.prev = ax.ranks[s - 1] if s > 0 else None
        self.next = ax.ranks[s + 1] if s < ax.size - 1 else None

    @property
    def is_last(self):
        return self.stage == self.n_stages - 1

    @staticmethod
    def exchange(sends, recvs):
        """One tick's transfers, posted together: ``sends`` a list of
        ``(tensor, rank)``, ``recvs`` a list of ``(template, rank)``;
        returns the received tensors, in ``recvs``' order."""
        out = [torch.empty_like(t) for t, _ in recvs]
        ops = [dist.P2POp(dist.isend, t.contiguous(), r) for t, r in sends]
        ops += [dist.P2POp(dist.irecv, o, r)
                for o, (_, r) in zip(out, recvs)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out


def _leaf(x, grad):
    """``x`` detached, a leaf that records its gradient when ``grad``
    (and ``x`` is floating)."""
    x = x.detach()
    if grad and x.is_floating_point():
        x.requires_grad_()
    return x


def gpipe_forward(stage_fn, params, x_micro, axis='stage', n_micro=None,
                  template=None, grad=True, want_dx=False):
    """The gpipe forward: micro ``m`` on this stage at tick ``m + s``.

    ``x_micro``: stage 0's micro-batch inputs (a sequence, or a ``(M,
    ...)`` tensor); other stages may pass None with ``n_micro`` and a
    ``template`` tensor of one micro-batch's shape and dtype.  Returns a
    :class:`GPipeRun`: the last stage's outputs ``(M, ...)`` (None on
    the others), each micro-batch's graph kept when ``grad`` (the
    inputs are leaves; stage 0's record their gradients when
    ``want_dx``)."""
    line = StageLine(axis)
    s = line.stage
    if n_micro is None:
        n_micro = len(x_micro)
    if template is None:
        template = x_micro[0]
    run = GPipeRun(line, stage_fn, n_micro, template)
    state = None
    for t in range(n_micro + line.n_stages - 1):
        m, y = t - s, None
        if 0 <= m < n_micro:
            x = x_micro[m] if s == 0 else state
            x = _leaf(x, grad and (s > 0 or want_dx))
            with torch.set_grad_enabled(grad):
                y = stage_fn(params, x)
            run.ins[m], run.outs[m] = x, y
        sends = ([(y.detach(), line.next)]
                 if y is not None and line.next is not None else [])
        recvs = ([(template, line.prev)]
                 if s > 0 and 0 <= t - (s - 1) < n_micro else [])
        got = line.exchange(sends, recvs)
        state = got[0] if recvs else None
    return run


class GPipeRun:
    """One gpipe forward's saved graphs and its backward."""

    def __init__(self, line, stage_fn, n_micro, template):
        self.line, self.stage_fn, self.n_micro = line, stage_fn, n_micro
        self.template = template
        self.ins = [None] * n_micro
        self.outs = [None] * n_micro

    @property
    def outputs(self):
        """The last stage's outputs stacked ``(M, ...)``, None
        elsewhere."""
        if not self.line.is_last:
            return None
        return torch.stack(self.outs)

    def backward(self, g_out=None):
        """The reversed ticks: micro ``m`` at ``t = m + s``, from the
        last to the first.  ``g_out``: the last stage's cotangents of its
        outputs, ``(M, ...)`` (ignored elsewhere).  Gradients accumulate
        into the parameters' ``grad``; returns stage 0's input
        cotangents as a list (Nones where its inputs record none, and on
        the other stages)."""
        line, s, n = self.line, self.line.stage, self.n_micro
        dxs = [None] * n
        state = None
        for t in reversed(range(n + line.n_stages - 1)):
            m, dx = t - s, None
            if 0 <= m < n:
                g = g_out[m] if line.is_last else state
                torch.autograd.backward(self.outs[m], g.to(self.outs[m].dtype))
                dx = self.ins[m].grad if self.ins[m].requires_grad else None
                self.outs[m] = None
                if s == 0:
                    dxs[m] = dx
            sends = ([(dx, line.prev)]
                     if dx is not None and line.prev is not None else [])
            recvs = ([(self.template, line.next)]
                     if line.next is not None and 0 <= t - (s + 1) < n
                     else [])
            got = line.exchange(sends, recvs)
            state = got[0] if recvs else None
        return dxs


class Pipeline:
    """GPipe-style pipeline over a stage axis (the JAX ``Pipeline``):
    ``stage_fn(stage_params, x) -> y``, the same code on every stage
    (stage-dependent behaviour can branch on the bound mesh's
    ``axis_index(axis)``); ``n_stages`` must equal the axis size.

    Call it with the axis bound (``with mesh.bind():``) on every process
    of the stage line, ``params`` this process's stage tree and
    ``x_microbatches`` ``(n_micro, micro_batch, ...)`` (only stage 0
    reads it; every stage takes its shape).  Returns the ``(n_micro,
    ...)`` outputs on the LAST stage and None on the others; under
    autograd the graphs are kept and :meth:`backward` runs the reversed
    schedule."""

    def __init__(self, stage_fn, n_stages, axis='stage'):
        self.stage_fn, self.n_stages, self.axis = stage_fn, n_stages, axis
        self.run = None

    def __call__(self, params, x_microbatches, want_dx=False):
        if resolve_axis(self.axis).size != self.n_stages:
            raise ValueError('%d stages over an axis of %d processes'
                             % (self.n_stages,
                                resolve_axis(self.axis).size))
        self.run = gpipe_forward(
            self.stage_fn, params, x_microbatches, self.axis,
            grad=torch.is_grad_enabled(), want_dx=want_dx)
        return self.run.outputs

    def backward(self, g_outputs=None):
        """The reversed schedule of the last call (see
        :meth:`GPipeRun.backward`)."""
        run, self.run = self.run, None
        return run.backward(g_outputs)


def pipeline_1f1b_grads(stage_fn, per_micro_loss, params_local,
                        x_microbatches, y_microbatches, n_stages=None,
                        axis='stage', extra=None,
                        collect_input_cotangents=True):
    """One-forward-one-backward pass: ``(loss, metrics, grads)``, or with
    ``extra`` ``(loss, metrics, grads, extra_grads, x_cotangents)``, as
    the JAX function returns.  ``loss`` / ``metrics`` are means over the
    ``M`` micro-batches, valid on the LAST stage (zeros elsewhere; the
    metrics None there); ``grads`` the stage-local parameter gradients of
    that mean loss.  The gradients ACCUMULATE into the leaves' ``grad``
    (``params_local`` and ``extra``, tensors that require it) and come
    back as trees of those ``grad`` tensors (zeros where none).

    Each stage keeps a ring of ``2S`` micro-batch inputs; at a
    micro-batch's backward slot it recomputes the forward under autograd
    and drives that micro-batch's backward.  ``per_micro_loss(y, y_micro)
    -> (loss, metrics)`` (with ``extra``: ``(extra, y, y_micro)``) must be
    a mean over micro-batches.  ``extra_grads`` (through the loss only)
    are valid on the last stage; ``x_cotangents`` is the list of stage
    0's input cotangents (Nones elsewhere, and empty without
    ``collect_input_cotangents``), for the prologue's backward.
    ``x_microbatches``: stage 0 reads them, the others take the
    template; ``y_microbatches``: the last stage reads them."""
    line = StageLine(axis)
    S, s = line.n_stages, line.stage
    if n_stages is not None and n_stages != S:
        raise ValueError('%d stages over an axis of %d processes'
                         % (n_stages, S))
    M = len(x_microbatches)
    ring = [None] * (2 * S)
    want_dx = s > 0 or (extra is not None and collect_input_cotangents)
    template = x_microbatches[0]
    loss_sum, metrics_sum = None, None
    dx_buf = [None] * M if (extra is not None
                            and collect_input_cotangents) else []
    state_f = state_b = None
    for t in range(M + 2 * S - 1):
        # the forward slot (the last stage only stashes its input)
        m_f, y = t - s, None
        if 0 <= m_f < M:
            x = x_microbatches[m_f] if s == 0 else state_f
            ring[m_f % (2 * S)] = x.detach()
            if not line.is_last:
                with torch.no_grad():
                    y = stage_fn(params_local, x)
        # the backward slot: recompute, then this micro-batch's backward
        m_b, dx = t - (2 * S - 1) + s, None
        if 0 <= m_b < M:
            x = _leaf(ring[m_b % (2 * S)], want_dx)
            ring[m_b % (2 * S)] = None
            y_re = stage_fn(params_local, x)
            if line.is_last:
                yl = y_re.detach().requires_grad_()
                ym = y_microbatches[m_b]
                loss_m, metrics_m = (per_micro_loss(yl, ym) if extra is None
                                     else per_micro_loss(extra, yl, ym))
                (loss_m / M).backward()
                g_in = yl.grad
                loss_m = loss_m.detach()
                metrics_m = {k: torch.as_tensor(v).detach()
                             for k, v in metrics_m.items()}
                if loss_sum is None:
                    loss_sum, metrics_sum = loss_m, metrics_m
                else:
                    loss_sum = loss_sum + loss_m
                    metrics_sum = {k: metrics_sum[k] + v
                                   for k, v in metrics_m.items()}
            else:
                g_in = state_b
            torch.autograd.backward(y_re, g_in.to(y_re.dtype))
            if want_dx:
                dx = x.grad
            if s == 0 and dx_buf:
                dx_buf[m_b] = dx
        sends, recvs = [], []
        if y is not None:
            sends.append((y, line.next))
        if dx is not None and line.prev is not None:
            sends.append((dx, line.prev))
        if s > 0 and 0 <= t - (s - 1) < M:
            recvs.append((template, line.prev))
        if line.next is not None and 0 <= t - (2 * S - 1) + s + 1 < M:
            recvs.append((template, line.next))
        got = line.exchange(sends, recvs)
        state_f = state_b = None
        for (_, r), v in zip(recvs, got):
            if r == line.prev:
                state_f = v
            else:
                state_b = v
    if line.is_last:
        loss = loss_sum / M
        metrics = {k: v / M for k, v in metrics_sum.items()}
    else:
        loss, metrics = torch.zeros((), device=template.device), None
    grads = _grads(params_local)
    if extra is None:
        return loss, metrics, grads
    return loss, metrics, grads, _grads(extra), dx_buf


def _grads(tree):
    return tree_map(lambda p: (p.grad if p.grad is not None
                               else torch.zeros_like(p)), tree)


# ---------------------------------------------------------------------
# the 1F1B guard

#: torch.distributed calls the guard records (collectives and transfers)
_DIST_CALLS = ('all_reduce', 'all_gather', 'all_gather_into_tensor',
               'all_to_all', 'all_to_all_single', 'broadcast', 'reduce',
               'reduce_scatter', 'reduce_scatter_tensor', 'gather',
               'scatter', 'send', 'recv', 'isend', 'irecv',
               'batch_isend_irecv')


def _collective_classes():
    from chainermn_tpu_torch.functions import (
        point_to_point_communication as p2p)
    from chainermn_tpu_torch.parallel import sequence, tensor
    return (tensor._Reduce, tensor._Copy, sequence._ShareSum,
            sequence._AllToAll, p2p._Permute)


def _group_axes(group):
    """The mesh axes a process group spans, in the innermost bound
    mesh: a tuple of names, ``('world',)`` for the default group outside
    one."""
    mesh = _BOUND[-1] if _BOUND else None
    if mesh is not None:
        for key, g in mesh._groups.items():
            if g is group:
                return _names(key) if isinstance(key, str) else tuple(
                    n for n in mesh.axis_names if n in key)
        if group is None or group is dist.group.WORLD:
            return tuple(n for n in mesh.axis_names if mesh.shape[n] > 1)
    return ('world',)


class _Recorder:
    """Records the collectives a block issues: every ``torch.distributed``
    call of :data:`_DIST_CALLS` with the mesh axes of its group, and
    whether it ran inside one of the port's differentiable collectives
    (``depth``), whose forward the graph walk accounts for instead."""

    def __init__(self):
        self.calls, self.depth = [], 0

    def _wrap(self, name, orig):
        def call(*args, **kwargs):
            if self.depth == 0:
                if name == 'batch_isend_irecv':
                    groups = [op.group for op in args[0]]
                else:
                    groups = [kwargs.get('group')]
                for g in groups:
                    self.calls.append((name, _group_axes(g)))
            return orig(*args, **kwargs)
        return call

    def _wrap_apply(self, orig):
        def apply(*args, **kwargs):
            self.depth += 1
            try:
                return orig(*args, **kwargs)
            finally:
                self.depth -= 1
        return staticmethod(apply)

    @contextlib.contextmanager
    def recording(self, entry_points):
        saved = {n: getattr(dist, n) for n in _DIST_CALLS if hasattr(dist, n)}
        classes = _collective_classes() if entry_points else ()
        own = {c: c.__dict__.get('apply') for c in classes}
        try:
            for n, f in saved.items():
                setattr(dist, n, self._wrap(n, f))
            for c in classes:
                c.apply = self._wrap_apply(c.apply)
            yield self
        finally:
            for n, f in saved.items():
                setattr(dist, n, f)
            for c, f in own.items():
                if f is None:
                    del c.apply
                else:
                    c.apply = f


def _graph_collectives(roots):
    """``(name, axes, raw)`` of every collective node of the port's
    differentiable collectives that ``roots`` (tensors) depend on: the
    counterpart of JAX's jaxpr walk after dead-code elimination down to
    the probed outputs (a collective whose result the outputs do not
    depend on, such as one in the metrics, is not found)."""
    seen, stack, out = set(), [r.grad_fn for r in roots
                               if r.grad_fn is not None], []
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        cls = getattr(node, '_forward_cls', None)
        name = getattr(cls, 'cmn_collective', None)
        if name is not None:
            axis = getattr(node, 'axis', None)
            axes = _names(axis.name) if axis is not None else ('world',)
            out.append((name, axes,
                        name == 'psum' and not getattr(node, 'conjugate',
                                                       False)))
        stack.extend(f for f, _ in node.next_functions)
    return out


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def assert_collective_free(what, fn, *args, allowed_axes=()):
    """Raise ``ValueError`` if ``fn(*args)``'s outputs, or the
    cotangents of its backward, depend on a collective over an axis
    outside ``allowed_axes``: the 1F1B schedule's guard (the JAX
    ``assert_collective_free``, without a jaxpr).

    ``fn`` runs once under a recorder, then its backward runs once with
    cotangents of ones (``torch.autograd.grad``: no ``grad`` is
    touched).  Found are: the port's differentiable collectives
    (``parallel.psum`` / ``tp_reduce`` / ``tp_copy``, ``share_sum``, the
    all-to-all, the permutation of ``functions.send``) that the outputs
    depend on, by a walk of the autograd graph; every other
    ``torch.distributed`` call the forward makes (a communicator's
    reduction, a hand-written one), which the walk cannot attribute to
    the outputs and so fails closed; and every ``torch.distributed`` call
    made during the backward (an ``autograd.Function`` whose backward
    communicates, the conjugate pair's sums).  A collective acting only
    over ``allowed_axes`` (the tensor-parallel axis) is exempt, except a
    raw ``parallel.psum``, whose summing backward is the wrong gradient
    when every process seeds its own copy of a replicated loss.  A
    collective over an axis of one process makes no call and is not
    found.

    The recorder replaces the ``torch.distributed`` calls and the
    collectives' ``apply`` process-wide while ``fn`` and its backward
    run, not for the calling thread alone: on CUDA the backward runs on
    autograd's own threads.  A collective another thread issues in that
    window is recorded too (the updater probes at its first step,
    before its own communication starts).

    The JAX test of its primitive set (``test_guard_primitive_set_
    tracks_jax``) has no counterpart: the recorder names the port's own
    entry points and the ``torch.distributed`` calls, not a compiler's
    primitives."""
    allowed = set(allowed_axes)

    def bad(axes, raw=False):
        return raw or not (allowed and set(axes) <= allowed)

    found = set()
    rec = _Recorder()
    with rec.recording(entry_points=True):
        out = fn(*args)
    for name, axes in rec.calls:
        if bad(axes):
            found.add('%s over %s' % (name, '+'.join(axes)))
    outs = [o for o in _tensors(out) if o.requires_grad]
    for name, axes, raw in _graph_collectives(outs):
        if bad(axes, raw):
            found.add('%s over %s%s' % (name, '+'.join(axes),
                                         ' (a raw sum)' if raw else ''))
    if not found and outs:
        inputs = [t for t in _tensors(args) if t.requires_grad]
        rec = _Recorder()
        with rec.recording(entry_points=False):
            torch.autograd.grad(outs, inputs,
                                [torch.ones_like(o) for o in outs],
                                allow_unused=True)
        found = {'%s over %s (in the backward)' % (name, '+'.join(axes))
                 for name, axes in rec.calls if bad(axes)}
    if found:
        raise ValueError(
            '%s contains collective primitives %s: the 1f1b schedule '
            'differentiates it per device, where collective '
            'transposes are incorrect -- use the gpipe schedule (or '
            'make it collective-free)' % (what, sorted(found)))
