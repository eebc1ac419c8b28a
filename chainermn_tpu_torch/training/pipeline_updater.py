"""Training through the pipeline: GPipe and 1F1B updaters.

Counterpart of ``chainermn_tpu/training/pipeline_updater.py``.  The JAX
updater compiles the whole schedule, the gradient reductions and the
optimizer into one program over a ``(data, stage)`` mesh (or a plan's
``(data, model, pipe)`` one); here each process owns one stage of one
data replica (and one tensor-parallel shard of it) and runs the
schedule's tick loop of :mod:`chainermn_tpu_torch.parallel.pipeline`:

1. collate the global batch, keep this data replica's rows, cast its
   floating columns to the policy's compute dtype, and move them to the
   device (``shard_batch``);
2. stage 0 runs the prologue (embedding) on its rows; the stages run the
   schedule, handing micro-batch activations forward and their
   cotangents back; the last stage evaluates the loss (gpipe: once over
   the stacked outputs; 1F1B: once per micro-batch, averaged), and stage
   0 finishes the prologue's backward;
3. gradients: the stage body's are averaged over the data axis; the
   replicated ends' (``extra_params``: the head on the last stage, the
   prologue on stage 0) are summed over the stage axis and averaged over
   data, in one reduction over the ``(data, stage)`` plane; under 1F1B
   both reductions run in ``policy.reduce_dtype``, as the JAX 1F1B step
   does (gpipe reduces in the master dtype);
4. this process's ``torch.optim`` optimizer steps its own parameters
   (the stage's, then the ends'), with the sum of squares of a
   ``zero.clip_by_global_norm`` completed over the stages and the
   tensor-parallel shards, the ends counted once, and under gpipe the
   per-leaf norms of a trust ratio (``zero.lars`` / ``zero.lamb``)
   completed over each stacked leaf (1F1B refuses them at the first
   step, as the JAX updater does);
5. the loss and metrics are the last stage's, averaged over data and
   handed to every process.

Telemetry spans as ``StandardUpdater``'s (``host_batch_prep``, ``h2d``,
``jitted_step``, ``metrics_sync``), and the first step emits the JAX
updater's trace-time events, ``pipeline:schedule`` (what
``telemetry.report.pipeline_summary`` reads) and ``pipeline:ppermute``;
``trace_count`` counts them (1: there is one schedule a run).

What has no torch meaning here: ``donate`` (the updater copies the
parameters it is given into its own tensors; nothing is handed over)
and ``opt_state_specs`` (an optimizer's state lives beside its
parameter, on this process: there is no placement to state; ROADMAP.md
A5).  ``donate=`` is a ``TypeError``, as it is for ``StandardUpdater``,
and ``opt_state_specs=`` raises ``NotImplementedError``.
:meth:`PipelineUpdater.traceable_step` is the static analyser's view of
the step (``compiled_cost_analysis`` has no counterpart: no compiled
program exists; ``analysis.memtraffic.cost_summary`` counts the traced
step's FLOPs and bytes instead).
"""

import contextlib

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.communicators.base import join_default_group
from chainermn_tpu_torch.communicators import memory_utility
from chainermn_tpu_torch.models.flax_weights import (_leaves, gather_leaf,
                                                     shard_leaf)
from chainermn_tpu_torch.ops._common import resolve_device
from chainermn_tpu_torch.parallel import pipeline as _pl
from chainermn_tpu_torch.parallel import zero as zero_mod
from chainermn_tpu_torch.parallel.meshplan import ProcessMesh
from chainermn_tpu_torch.training.convert import concat_examples
from chainermn_tpu_torch.training.updater import (optimizer_state_by_index,
                                                  swapped_optimizer)

AXIS_DATA = 'data'
AXIS_STAGE = 'stage'
AXIS_TP = 'tp'


def pipeline_mesh(n_stages, n_tp=1, size=None, rank=None, device=None):
    """A ``(data, stage)`` mesh of processes, or ``(data, stage, tp)``
    when ``n_tp > 1``, over every process (the JAX ``pipeline_mesh``'s
    layout: the stage and tp axes minor).  The default group is joined,
    or made as ``MeshPlan.create`` makes it (``device``); with ``size``
    the mesh is shape-only.  The ``(data, stage)`` plane gets its group
    (the ends' gradients and the metrics are reduced over it)."""
    if n_tp < 1 or n_stages < 1:
        raise ValueError('n_stages and n_tp must be >= 1, got %d, %d'
                         % (n_stages, n_tp))
    groups = False
    if size is None:
        join_default_group(device)
        size, rank = dist.get_world_size(), dist.get_rank()
        groups = size > 1
    if size % (n_stages * n_tp):
        raise ValueError('%d devices not divisible into %d stages x '
                         '%d tp' % (size, n_stages, n_tp))
    if n_tp > 1:
        shape = (size // (n_stages * n_tp), n_stages, n_tp)
        names = (AXIS_DATA, AXIS_STAGE, AXIS_TP)
    else:
        shape, names = (size // n_stages, n_stages), (AXIS_DATA, AXIS_STAGE)
    return ProcessMesh(shape, names, rank=rank, groups=groups,
                       composites=((AXIS_DATA, AXIS_STAGE),))


def _is_spec(v):
    return isinstance(v, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in v)


def _lookup(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _unflatten(pairs):
    out = {}
    for path, v in pairs:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


class PipelineUpdater:
    """Drop-in updater (``StandardUpdater``'s surface) that runs a
    micro-batched pipeline-parallel step.

    Args:
      iterator: batch iterator yielding the GLOBAL batch on every process
        (each keeps its data replica's rows), or ``iter([])`` when
        driving :meth:`update_core` directly.
      optimizer: a callable ``params -> optimizer`` (a ``torch.optim``
        optimizer, or ``zero.chain(...)``), called once with this
        process's parameters: the stage's, then the ends'.  The JAX
        updater takes an optax transformation, which needs no
        parameters to exist.  The optimizer sees only this process's
        parameters under BOTH schedules (JAX's gpipe optimizer sees the
        whole stacked tree), so it must be elementwise unless
        ``schedule_check=False``; ``zero.chain(zero.clip_by_global_norm
        (c), ...)`` is admitted and completes its norm over the stages,
        and ``zero.lars`` / ``zero.lamb`` are admitted (gpipe completes
        their per-leaf norms over each stacked leaf; 1F1B refuses them
        at the first step).  The JAX ``donate`` has no counterpart (see
        the module docstring).
      stage_fn: ``stage_fn(stage_params, x) -> y``: ``stage_params`` this
        process's stage tree (the stacked leaves without their leading
        stage dim), ``y`` of ``x``'s shape and dtype.
      loss_on_last: ``loss_on_last(outputs, y_micro) -> (loss, metrics)``
        (with ``extra_params``: ``(extra, outputs, y_micro)``) over the
        last stage's stacked outputs ``(n_micro, micro_b, ...)``; runs on
        the last stage only.
      params_stacked: the FULL stacked tree (numpy arrays or tensors,
        leading dim ``n_stages``), the same on every process; each keeps
        its stage (and tensor-parallel shard) under ``param_specs``.
      mesh: a :class:`~chainermn_tpu_torch.parallel.ProcessMesh` binding
        ``data_axis`` and ``stage_axis`` (:func:`pipeline_mesh`).
      n_micro: micro-batches a step.
      remat: recompute the stage body in the backward (gpipe only;
        ``torch.utils.checkpoint``, non-reentrant).
      schedule: ``'gpipe'`` (default) or ``'1f1b'``.  1F1B runs a
        collective guard at its first step
        (:func:`~chainermn_tpu_torch.parallel.pipeline.
        assert_collective_free`): the stage body, the loss (without its
        metrics) and the prologue may communicate over ``tp_axis``
        only.  The guard runs them, forward and backward, once on one
        micro-batch's template inputs (and the prologue on the local
        batch), so the first step pays about one more micro-batch of
        work (at the LM's widths 13 LayerNorm, 6 of each flash kernel
        and 1 cross-entropy launch); the JAX guard only traces.  1F1B's
        loss is the mean of per-micro-batch losses, so nonlinear
        metrics (perplexity) differ from gpipe's by Jensen's
        inequality; the gradients do not.
      schedule_check: probe the optimizer for elementwise updates.
      prologue: ``prologue(extra, x) -> activations`` on stage 0's full
        local batch before micro-batching (embedding lookup); needs
        ``extra_params``.
      extra_params: the replicated ends' parameter tree (embedding,
        final norm, head), trained with the body on every process.
      param_specs: a spec tree leaf-exact over ``params_stacked``, each
        spec a tuple leading with ``stage_axis`` that may shard more
        dims over ``tp_axis`` (Megatron stages; the stage body then uses
        the conjugate pair, ``tp_copy`` / ``tp_reduce``, so that every
        process seeds its backward with its copy of the loss).
      policy: a :class:`~chainermn_tpu_torch.precision.Policy`: masters
        in ``param_dtype``, the stage body, loss and prologue on
        ``compute_dtype`` copies (gpipe casts once a step and adds the
        micro-batches' gradients in the compute dtype, as the JAX
        program's scan does; 1F1B casts at each micro-batch and adds in
        the master dtype), loss and metrics in f32.  A loss-scaled
        policy raises.
      device: this process's device (default: the current CUDA device).
      data_axis / stage_axis / tp_axis: the mesh axis names bound.
    """

    def __init__(self, iterator, optimizer, stage_fn, loss_on_last,
                 params_stacked, mesh, n_micro, remat=False,
                 schedule='gpipe', schedule_check=True,
                 prologue=None, extra_params=None, param_specs=None,
                 opt_state_specs=None, policy=None,
                 data_axis=AXIS_DATA, stage_axis=AXIS_STAGE,
                 tp_axis=None, device=None):
        if schedule not in ('gpipe', '1f1b'):
            raise ValueError("schedule must be 'gpipe' or '1f1b'")
        if policy is not None and policy.loss_scale is not None:
            raise ValueError(
                'PipelineUpdater does not support loss-scaled '
                'policies (use Policy.bf16(), whose f32-range '
                'exponent needs no scaling, or StandardUpdater for '
                'f16 with dynamic loss scaling)')
        if opt_state_specs is not None:
            raise NotImplementedError(
                'opt_state_specs has no torch meaning: an optimizer\'s '
                'state lives beside its parameter on this process '
                '(ROADMAP.md A5)')
        if param_specs is not None:
            spec_leaves = _pl.tree_leaves(param_specs)
            bad = [sp for sp in spec_leaves
                   if not (_is_spec(sp) and len(sp) >= 1
                           and sp[0] == stage_axis)]
            if bad:
                raise ValueError(
                    'every param spec must lead with the stage axis '
                    '((%r, ...)), got %r' % (stage_axis, bad[:3]))
            if schedule == '1f1b':
                stray = [sp for sp in spec_leaves
                         if any(e not in (None, tp_axis) for e in sp[1:])]
                if stray:
                    raise ValueError(
                        "param_specs under schedule='1f1b' may shard "
                        'non-stage dims only over a declared tp_axis '
                        '(the conjugate-discipline axis; got tp_axis='
                        '%r, stray specs %r).  Other axes need the '
                        'gpipe schedule.' % (tp_axis, stray[:3]))
            n_p = len(list(_leaves(params_stacked)))
            if len(spec_leaves) != n_p:
                raise ValueError(
                    'param_specs must be LEAF-EXACT (one spec per params '
                    'leaf): got %d specs for %d leaves'
                    % (len(spec_leaves), n_p))
        if prologue is not None and extra_params is None:
            raise ValueError('prologue requires extra_params (pass an '
                             'empty dict if it is parameter-free)')
        if schedule == '1f1b' and remat:
            raise ValueError(
                "remat=True has no effect under schedule='1f1b' "
                '(its backward recomputes by construction); drop '
                'the flag')
        _telemetry.maybe_enable_from_env()
        self.iterator = iterator
        self.stage_fn, self.loss_on_last = stage_fn, loss_on_last
        self.prologue = prologue
        self.mesh = mesh
        self.n_micro = int(n_micro)
        self.remat = bool(remat)
        self.schedule = schedule
        self.policy = policy
        self._axis_data, self._axis_stage = data_axis, stage_axis
        self._tp_axis = tp_axis
        self.n_stages = mesh.axis_size(stage_axis)
        self.n_data = mesh.axis_size(data_axis)
        self.device = resolve_device(device)
        self.iteration = 0
        #: schedule marks emitted (once: the JAX step's trace count)
        self.trace_count = 0
        self._guarded = False
        self._templates = {}
        self._metric_spec = None
        if param_specs is None:
            param_specs = _pl.tree_map(lambda _: (stage_axis,),
                                       params_stacked)
        self.param_specs = param_specs
        master = policy.param_dtype if policy is not None else None

        def own(value, spec=None):
            t = (value.detach().cpu() if isinstance(value, torch.Tensor)
                 else torch.from_numpy(np.array(value)))
            if spec is not None:        # this stage's (and shard's) block
                t = shard_leaf(t, spec, mesh)[0]
            if master is not None and t.is_floating_point():
                t = t.to(master)
            return torch.nn.Parameter(t.to(self.device).clone())

        self.stage_params = _pl.tree_map(own, params_stacked, param_specs)
        self.extra_params = None
        if extra_params is not None:
            self.extra_params = _pl.tree_map(own, extra_params)
        self._stage_list = _pl.tree_leaves(self.stage_params)
        self._extra_list = (_pl.tree_leaves(self.extra_params)
                            if self.extra_params is not None else [])
        self.optimizer = optimizer(self._stage_list + self._extra_list)
        if schedule_check:
            try:
                zero_mod.check_elementwise(self.optimizer)
            except ValueError as e:
                raise ValueError(
                    "schedule=%r requires an elementwise optimizer: the "
                    "optimizer sees each stage's local tree (under both "
                    'schedules here), so cross-element transforms compute '
                    "per-stage statistics and silently diverge from the "
                    "stacked-tree trajectory.  For global-norm clipping "
                    'use zero.chain(zero.clip_by_global_norm(c), ...) -- '
                    'its norm is completed across stages.  Trust ratios '
                    '(LARS/LAMB, incl. zero.lars and zero.lamb) are NOT '
                    'available under 1f1b: stage sharding admits no '
                    'per-leaf norm rule.  The gpipe schedule runs them, '
                    'with pipeline-native semantics: one ratio per STACKED '
                    'leaf (all stages sharing a layer name together), not '
                    'per layer of the unstacked model.  Probe result: %s  '
                    'Pass schedule_check=False to bypass.'
                    % (schedule, e)) from e
        # tensor-parallel shards of the stage leaves, for the global norm
        self._tp_sharded = set()
        if tp_axis is not None and mesh.axis_size(tp_axis) > 1:
            for (path, p) in _leaves(self.stage_params):
                if tp_axis in tuple(_lookup(param_specs, path))[1:]:
                    self._tp_sharded.add(p)

    # -- input ---------------------------------------------------------
    def shard_batch(self, batch):
        """Collate the global batch, keep this data replica's rows (the
        batch scattered over the data axis; floating columns cast to the
        policy's compute dtype on the host) and move them to the
        device."""
        with _telemetry.span('host_batch_prep', kind='host',
                             iteration=self.iteration):
            arrays = concat_examples(
                batch, dtype=(self.policy.compute_dtype
                              if self.policy is not None else None))
            if isinstance(arrays, dict):
                arrays = tuple(arrays.values())
            d = self.mesh.axis_index(self._axis_data)
            local = []
            for a in arrays:
                a = torch.as_tensor(a)
                if a.shape[0] % self.n_data:
                    raise ValueError('batch %d does not divide over %d data '
                                     'replicas' % (a.shape[0], self.n_data))
                k = a.shape[0] // self.n_data
                local.append(a[d * k:(d + 1) * k])
        with _telemetry.span('h2d', kind='h2d',
                             iteration=self.iteration) as sp:
            return sp.sync(tuple(t.to(self.device) for t in local))

    # -- pieces of the step --------------------------------------------
    def _line(self):
        return _pl.StageLine(self._axis_stage)

    def _from_stage(self, line, obj, stage):
        """``obj`` of ``stage`` on every process of the stage line (a
        broadcast of a Python object, once per shape)."""
        if line.n_stages == 1:
            return obj
        ax = self.mesh.axis(self._axis_stage)
        box = [obj]
        dist.broadcast_object_list(box, src=ax.ranks[stage], group=ax.group)
        return box[0]

    def _template(self, line, x, acts):
        """A zero tensor of one micro-batch's activations on every stage
        (stage 0 knows it; the others learn its shape and dtype once per
        input shape)."""
        key = (tuple(x.shape), x.dtype)
        if key not in self._templates:
            spec = None
            if line.stage == 0:
                spec = (tuple(acts.shape[1:]), acts.dtype)
            shape, dtype = self._from_stage(line, spec, 0)
            self._templates[key] = torch.zeros(shape, dtype=dtype,
                                               device=self.device)
        return self._templates[key]

    def _compute(self, tree):
        if self.policy is None:
            return tree
        return self.policy.cast_to_compute(tree)

    def _cast_leaves(self, tree):
        """The gpipe step's compute-dtype copies: leaves of their own,
        whose gradients the micro-batches add into in the compute dtype
        (without a policy, the parameters themselves)."""
        if self.policy is None or tree is None:
            return tree
        dt = self.policy.compute_dtype
        return _pl.tree_map(
            lambda p: (p.detach().to(dt).requires_grad_()
                       if p.is_floating_point() else p), tree)

    @staticmethod
    def _into_masters(masters, copies):
        if masters is None or copies is masters:
            return
        for p, c in zip(_pl.tree_leaves(masters), _pl.tree_leaves(copies)):
            if c.grad is not None:
                p.grad = c.grad.to(p.dtype)

    def _loss(self, extra, outs, ys):
        if self.extra_params is not None:
            return self.loss_on_last(extra, outs, ys)
        return self.loss_on_last(outs, ys)

    def _prologue(self, extra, x):
        return self.prologue(extra, x) if self.prologue is not None else x

    def _mark_schedule(self):
        if self.trace_count:
            return
        self.trace_count = 1
        if not _telemetry.enabled():
            return
        _telemetry.event(
            'pipeline:schedule', kind='pipeline', schedule=self.schedule,
            n_micro=self.n_micro, n_stages=self.n_stages,
            total_ticks=_pl.schedule_ticks(self.n_micro, self.n_stages,
                                           self.schedule),
            axes=[self._axis_stage])
        _telemetry.event('pipeline:ppermute', kind='collective_trace',
                         axes=[self._axis_stage])

    def _gpipe(self, x, y, train):
        """The gpipe forward (and, when ``train``, its backward): returns
        the last stage's ``(loss, metrics)`` (None elsewhere)."""
        line, M = self._line(), self.n_micro
        grad = contextlib.nullcontext() if train else torch.no_grad()
        with grad:
            p = self._cast_leaves(self.stage_params) if train else \
                self._compute(self.stage_params)
            e = self._cast_leaves(self.extra_params) if train else \
                self._compute(self.extra_params)
            acts = self._prologue(e, x) if line.stage == 0 else None
            template = self._template(line, x, _pl.microbatch(
                acts, M) if acts is not None else None)
            body = self.stage_fn
            if self.remat and train:
                def body(q, a):
                    return checkpoint(self.stage_fn, q, a,
                                      use_reentrant=False)
            run = _pl.gpipe_forward(
                body, p, _pl.microbatch(acts, M) if acts is not None
                else None, self._axis_stage, n_micro=M, template=template,
                grad=train, want_dx=train and self.prologue is not None)
            out = g = None
            if line.is_last:
                outs = run.outputs
                if train:
                    outs = outs.detach().requires_grad_()
                loss, metrics = self._loss(e, outs, _pl.microbatch(y, M))
                if train:
                    loss.backward()
                    g = outs.grad
                out = (loss, metrics)
            if train:
                dxs = run.backward(g)
                if acts is not None and self.prologue is not None:
                    torch.autograd.backward(
                        acts, torch.stack(dxs).reshape(acts.shape))
                self._into_masters(self.stage_params, p)
                self._into_masters(self.extra_params, e)
        return out

    def _1f1b(self, x, y):
        line, M = self._line(), self.n_micro
        compute = self._compute
        e = self.extra_params
        acts = None
        if line.stage == 0:
            acts = self._prologue(compute(e), x) if self.prologue \
                is not None else compute(x)
        acts_m = _pl.microbatch(acts, M) if acts is not None else None
        template = self._template(line, x, acts_m)
        if acts_m is None:
            acts_m = [template] * M
        y_m = _pl.microbatch(y, M)

        def stage_body(p, a):
            return self.stage_fn(compute(p), a)

        if e is None:
            def per_micro_loss(yy, ym):
                return self.loss_on_last(yy[None], ym[None])
        else:
            def per_micro_loss(ee, yy, ym):
                return self.loss_on_last(compute(ee), yy[None], ym[None])
        if not self._guarded:
            self._guard(stage_body, per_micro_loss, template, y_m[0], x)
            self._guarded = True
        out = _pl.pipeline_1f1b_grads(
            stage_body, per_micro_loss, self.stage_params, acts_m, y_m,
            axis=self._axis_stage, extra=e,
            collect_input_cotangents=self.prologue is not None)
        loss, metrics = out[0], out[1]
        if e is not None and self.prologue is not None and line.stage == 0:
            torch.autograd.backward(
                acts, torch.stack(out[4]).reshape(acts.shape))
        return (loss, metrics) if line.is_last else None

    def _guard(self, stage_body, per_micro_loss, template, ym, x):
        """The 1F1B guard's three probes (the JAX ``_assert_1f1b_safe``),
        run on every process."""
        allowed = (self._tp_axis,) if self._tp_axis else ()
        act = template.detach().clone().requires_grad_(
            template.is_floating_point())
        if self.extra_params is None:
            _pl.assert_collective_free(
                "loss_on_last under schedule='1f1b'",
                lambda yy, yym: per_micro_loss(yy, yym)[0], act, ym,
                allowed_axes=allowed)
        else:
            _pl.assert_collective_free(
                "loss_on_last under schedule='1f1b'",
                lambda ee, yy, yym: per_micro_loss(ee, yy, yym)[0],
                self.extra_params, act, ym, allowed_axes=allowed)
        _pl.assert_collective_free(
            "stage_fn under schedule='1f1b'", stage_body, self.stage_params,
            act, allowed_axes=allowed)
        if self.prologue is not None:
            _pl.assert_collective_free(
                "prologue under schedule='1f1b'",
                lambda ee, xx: self.prologue(self._compute(ee), xx),
                self.extra_params, x, allowed_axes=allowed)

    def _reduce(self, grads, axis, n_data):
        """Sum ``grads`` over ``axis`` in place, divided by ``n_data``
        (in ``policy.reduce_dtype`` under 1F1B)."""
        ax = self.mesh.axis(axis)
        if ax.size == 1 or not grads:
            return
        wire = (self.policy.reduce_dtype if self.policy is not None
                and self.schedule == '1f1b' else None)

        def reduce(buf):
            dist.all_reduce(buf, group=ax.group)
            return buf / n_data

        with torch.no_grad():
            for g, r in zip(grads, memory_utility.fused_reduce(
                    grads, reduce, dtype=wire)):
                g.copy_(r)

    def _gnorm_sq(self, tensors):
        """The global sum of squares of the gradients a mesh-aware
        transform is given: the stage leaves' over the stages (and the
        tensor-parallel shards), the replicated ends' once."""
        stage = {id(p.grad) for p in self._stage_list}
        sharded = {id(p.grad) for p in self._tp_sharded}
        dev = self.device
        sq = {k: torch.zeros((), device=dev) for k in ('tp', 'stage', 'end')}
        for t in tensors:
            key = ('tp' if id(t) in sharded else
                   'stage' if id(t) in stage else 'end')
            sq[key] = sq[key] + t.to(torch.float32).square().sum()
        if self._tp_sharded:
            dist.all_reduce(sq['tp'], group=self.mesh.axis(
                self._tp_axis).group)
        body = sq['tp'] + sq['stage']
        ax = self.mesh.axis(self._axis_stage)
        if ax.size > 1:
            dist.all_reduce(body, group=ax.group)
        return body + sq['end']

    def _leaf_sumsq(self, params, tensors):
        """gpipe's per-leaf rule: each tensor's sum of squares over its
        whole STACKED leaf -- a stage leaf's summed over the stages (and,
        when model-sharded, over the tensor-parallel shards), an end's
        local -- which is what the JAX gpipe optimizer, seeing the
        stacked tree, computes: one trust ratio per stacked leaf.  At
        most two all-reduces of one packed vector."""
        stage = {id(p) for p in self._stage_list}
        sharded = {id(p) for p in self._tp_sharded}
        local = zero_mod.leaf_sumsqs(tensors)
        is_tp = torch.tensor([id(p) in sharded for p in params],
                             device=local.device)
        is_stage = torch.tensor([id(p) in stage for p in params],
                                device=local.device)
        tp = torch.where(is_tp, local, torch.zeros_like(local))
        if self._tp_sharded:
            dist.all_reduce(tp, group=self.mesh.axis(self._tp_axis).group)
        body = tp + torch.where(is_stage & ~is_tp, local,
                                torch.zeros_like(local))
        ax = self.mesh.axis(self._axis_stage)
        if ax.size > 1:
            dist.all_reduce(body, group=ax.group)
        return torch.where(is_stage, body, local)

    def _metrics(self, line, out):
        """The last stage's loss and metrics, averaged over data, on
        every process (one reduction over the ``(data, stage)`` plane of
        the stacked values, zeros off the last stage)."""
        if self._metric_spec is None:
            spec = None
            if line.is_last:
                spec = [(k, tuple(torch.as_tensor(v).shape))
                        for k, v in out[1].items()]
            self._metric_spec = self._from_stage(line, spec,
                                                 line.n_stages - 1)
        spec = [('loss', ())] + self._metric_spec
        if line.is_last:
            loss, metrics = out
            vals = dict(metrics, loss=loss)
            flat = torch.cat([torch.as_tensor(vals[k], device=self.device)
                              .detach().to(torch.float32).reshape(-1)
                              for k, _ in spec])
        else:
            flat = torch.zeros(sum(int(np.prod(s)) for _, s in spec),
                               device=self.device)
        ax = self.mesh.axis((self._axis_data, self._axis_stage))
        if ax.size > 1:
            dist.all_reduce(flat, group=ax.group)
            flat = flat / self.n_data
        out, i = {}, 0
        for k, shape in spec:
            n = int(np.prod(shape))
            out[k] = flat[i:i + n].reshape(shape)
            i += n
        return out

    # -- the step ------------------------------------------------------
    def _step(self, arrays):
        x, y = arrays
        line = self._line()
        self._mark_schedule()
        for p in self._stage_list + self._extra_list:
            p.grad = None
        if self.schedule == 'gpipe':
            out = self._gpipe(x, y, train=True)
        else:
            out = self._1f1b(x, y)
        for p in self._stage_list + self._extra_list:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._reduce([p.grad for p in self._stage_list], self._axis_data,
                     self.n_data)
        self._reduce([p.grad for p in self._extra_list],
                     (self._axis_data, self._axis_stage), self.n_data)
        # 1F1B's stage sharding admits no per-leaf rule: a trust ratio
        # refuses there, as in the JAX package
        with zero_mod.mesh_norm_scope(
                self._gnorm_sq, leaf_sumsq=(self._leaf_sumsq
                                            if self.schedule == 'gpipe'
                                            else None)):
            self.optimizer.step()
        return self._metrics(line, out)

    def update_core(self, arrays):
        """One iteration on already-sharded arrays; returns the averaged
        metrics as 0-d tensors."""
        with _telemetry.span('jitted_step', kind='compute',
                             iteration=self.iteration) as sp:
            with self.mesh.bind():
                metrics = self._step(arrays)
            sp.sync(tuple(metrics.values()))
        self.iteration += 1
        return metrics

    def update(self, sync=True):
        """Advance one iteration; ``sync=False`` returns the 0-d device
        tensors (``Trainer(async_metrics=True)``)."""
        metrics = self.update_core(self.shard_batch(next(self.iterator)))
        if not sync:
            return dict(metrics)
        with _telemetry.span('metrics_sync', kind='host',
                             iteration=self.iteration - 1):
            return {k: float(v) for k, v in metrics.items()}

    def evaluate(self, arrays):
        """Forward-only metrics on already-sharded arrays: the gpipe
        schedule and the loss, no gradient and no optimizer step."""
        with self.mesh.bind():
            out = self._gpipe(arrays[0], arrays[1], train=False)
            metrics = self._metrics(self._line(), out)
        return {k: float(v) for k, v in metrics.items()}

    # -- static analysis -------------------------------------------------
    def _primed(self, arrays):
        """What the first step of an input shape exchanges once across
        the stage line (stage 0's micro-batch activation template, the
        last stage's metric shapes), computed on this process without
        communication (a traced step's fake world carries no data):
        ``(templates, metric_spec)``.  Returned, not kept: the updater's
        own first step still makes the exchanges on every rank."""
        x, y = arrays
        key = (tuple(x.shape), x.dtype)
        M = self.n_micro
        templates, spec = dict(self._templates), self._metric_spec
        with torch.no_grad(), self.mesh.bind():
            e = self._compute(self.extra_params)
            if key not in templates:
                acts = (self._prologue(e, x) if self.prologue is not None
                        else self._compute(x))
                templates[key] = torch.zeros_like(
                    _pl.microbatch(acts, M)[0])
            if spec is None:
                outs = torch.stack([templates[key]] * M)
                ys = _pl.microbatch(y, M)
                if self.schedule == '1f1b':
                    outs, ys = outs[:1], ys[:1]
                metrics = self._loss(e, outs, ys)[1]
                spec = [(k, tuple(torch.as_tensor(v).shape))
                        for k, v in metrics.items()]
        return templates, spec

    def traceable_step(self, arrays, iteration=None):
        """``(fn, args)``: the step :meth:`update_core` runs, over
        explicit tensors, for graph-level static analysis
        (:mod:`chainermn_tpu_torch.analysis`).  ``fn(params, buffers,
        opt_state, batch)`` runs :meth:`_step` -- the same body -- with
        this process's stage and end parameters swapped for ``params``
        (a list: the stage leaves, then the ends'), the optimizer's state
        for ``opt_state`` (by index), inside the mesh binding, and returns
        ``(params, buffers, opt_state, metrics)`` (``buffers`` is empty:
        the pipeline holds none).  The updater has no module to
        ``functional_call``: its trees are swapped leaf for leaf.  The
        set-up the first step of a shape makes (the 1F1B guard, the
        template and metric-shape exchanges, the schedule marks) is
        skipped inside ``fn``, on values computed here
        (:meth:`_primed`), so the graph is a later step's.  The
        updater's own state, those values included, is put back after
        each call."""
        primed = self._primed(arrays)
        leaves = self._stage_list + self._extra_list
        params = [p.detach().requires_grad_(p.requires_grad) for p in leaves]
        opt = self.optimizer
        it = self.iteration if iteration is None else int(iteration)

        def fn(params, buffers, opt_state, batch):
            swap = dict(zip(leaves, params))
            saved = (self.stage_params, self.extra_params,
                     self._stage_list, self._extra_list, self._tp_sharded,
                     self.iteration, self._guarded, self.trace_count,
                     self._templates, self._metric_spec)

            def rebind():
                for g in opt.param_groups:
                    g['params'] = [swap[p] for p in g['params']]

            try:
                self.stage_params = _pl.tree_map(swap.get, self.stage_params)
                if self.extra_params is not None:
                    self.extra_params = _pl.tree_map(swap.get,
                                                     self.extra_params)
                self._stage_list = [swap[p] for p in saved[2]]
                self._extra_list = [swap[p] for p in saved[3]]
                self._tp_sharded = {swap[p] for p in saved[4]}
                self.iteration, self._guarded, self.trace_count = it, True, 1
                self._templates, self._metric_spec = primed
                with swapped_optimizer(opt, rebind, opt_state) as state, \
                        self.mesh.bind():
                    metrics = self._step(tuple(batch))
                    return params, buffers, state(), metrics
            finally:
                (self.stage_params, self.extra_params, self._stage_list,
                 self._extra_list, self._tp_sharded, self.iteration,
                 self._guarded, self.trace_count, self._templates,
                 self._metric_spec) = saved

        return fn, (params, {}, optimizer_state_by_index(opt),
                    tuple(arrays))

    def declared_reduce_dtypes(self):
        """Dtype names this updater's reductions may narrow to."""
        if self.policy is None:
            return set()
        return set(self.policy.declared_dtypes())

    # -- state ---------------------------------------------------------
    @property
    def params(self):
        """The full stacked stage tree as numpy arrays, gathered over the
        stage (and tensor-parallel) axes: a collective, every process
        must read it."""
        return _unflatten(
            (path, gather_leaf(p.detach()[None], _lookup(
                self.param_specs, path), self.mesh, self.device)
             .float().cpu().numpy())
            for path, p in _leaves(self.stage_params))

    @property
    def extra(self):
        """The replicated ends as numpy arrays (None without them)."""
        if self.extra_params is None:
            return None
        return _pl.tree_map(lambda p: p.detach().float().cpu().numpy(),
                            self.extra_params)

    def snapshot_state(self):
        """The snapshot tree (``serializers.updater_state``): ``params``
        (the stacked body gathered, the JAX keys), ``extra``,
        ``opt_state`` (each parameter's optimizer state under its
        parameter's path, ``stages/...`` gathered like the parameter,
        ``extra/...``), ``iteration``, ``epoch``, ``epoch_detail``.  A
        collective: every process must call it."""
        opt = {}
        for group, tree in (('stages', self.stage_params),
                            ('extra', self.extra_params)):
            if tree is None:
                continue
            for path, p in _leaves(tree):
                spec = (_lookup(self.param_specs, path)
                        if group == 'stages' else ())
                for key, v in self.optimizer.state.get(p, {}).items():
                    if torch.is_tensor(v) and v.shape == p.shape \
                            and group == 'stages':
                        v = gather_leaf(v.detach()[None], spec, self.mesh,
                                        self.device)
                    opt[(group,) + path + (key,)] = (
                        v.detach().cpu().numpy() if torch.is_tensor(v)
                        else np.asarray(v))
        state = {'params': self.params, 'opt_state': _unflatten(
            opt.items()), 'iteration': self.iteration,
            'epoch': self.epoch, 'epoch_detail': float(self.epoch_detail)}
        if self.extra_params is not None:
            state['extra'] = self.extra
        cursor = getattr(self.iterator, 'stream_cursor', None)
        if cursor is not None:
            state['stream_cursor'] = int(cursor)
        return state

    def load_snapshot(self, by_key, path):
        """The inverse of :meth:`snapshot_state` at the same mesh shape,
        from ``serializers.read_npz``'s ``by_key``; every leaf is read
        and checked before anything is assigned."""
        from chainermn_tpu_torch.serializers import _corrupt, _fetch
        new = []
        opt = {}
        for group, tree in (('stages', self.stage_params),
                            ('extra', self.extra_params)):
            if tree is None:
                continue
            for leaf_path, p in _leaves(tree):
                name = '/'.join(leaf_path)
                if group == 'stages':
                    spec = _lookup(self.param_specs, leaf_path)
                    full = [self.n_stages] + list(p.shape)
                    for i, entry in enumerate(spec[1:]):
                        if entry is not None:
                            full[i + 1] *= self.mesh.axis_size(entry)
                    value = shard_leaf(torch.as_tensor(_fetch(
                        by_key, 'params/' + name, np.broadcast_to(
                            np.float32(0), full), path)), spec,
                        self.mesh)[0]
                else:
                    value = torch.as_tensor(_fetch(
                        by_key, 'extra/' + name,
                        p.detach().float().cpu().numpy(), path))
                if tuple(value.shape) != tuple(p.shape):
                    raise _corrupt('shape mismatch for %r: snapshot %r vs '
                                   'this process %r' % (
                                       name, tuple(value.shape),
                                       tuple(p.shape)), path, name, 'shape')
                new.append((p, value))
                prefix = 'opt_state/%s/%s/' % (group, name)
                state = {}
                for key, v in by_key.items():
                    if key.startswith(prefix) and '/' not in key[len(
                            prefix):]:
                        t = torch.as_tensor(v)
                        if group == 'stages' and t.dim() == p.dim() + 1:
                            t = shard_leaf(t, spec, self.mesh)[0]
                        if t.shape == p.shape:
                            t = t.to(p.device)
                        state[key[len(prefix):]] = t.clone()
                if state:
                    opt[p] = state
        with torch.no_grad():
            for p, v in new:
                p.copy_(v)
        for p, state in opt.items():
            self.optimizer.state[p] = state

    @property
    def epoch(self):
        return getattr(self.iterator, 'epoch', 0)

    @property
    def epoch_detail(self):
        return getattr(self.iterator, 'epoch_detail', 0.0)

    @property
    def is_new_epoch(self):
        return getattr(self.iterator, 'is_new_epoch', False)


class MeshPipelineUpdater(PipelineUpdater):
    """The plan-based pipeline path: :class:`PipelineUpdater` over a
    3-D :class:`~chainermn_tpu_torch.parallel.MeshPlan` ``(data, model,
    pipe)``: stage parameters on their ``pipe`` coordinate
    (``plan.stage_specs``, or ``models.pipeline_stage_specs`` with the
    Megatron ``model`` entries for tensor parallelism inside each
    stage), activations and their cotangents handed between neighbours
    on the ``pipe`` line, gradients averaged over ``data``.  Defaults
    to ``schedule='1f1b'``; the device is the plan's."""

    def __init__(self, iterator, optimizer, stage_fn, loss_on_last,
                 params_stacked, plan, n_micro, schedule='1f1b',
                 param_specs=None, **kw):
        if getattr(plan, 'pipe_axis', None) is None:
            raise ValueError(
                'MeshPipelineUpdater needs a plan with a pipeline '
                'axis: build it with MeshPlan.create(tp=..., pp=...)')
        if len(plan.data_axes) != 1:
            raise ValueError('the pipeline schedule expects a single '
                             'data axis, got %r' % (plan.data_axes,))
        tp_axis = (plan.model_axis if plan.model_axis is not None
                   and plan.model_size > 1 else None)
        self.plan = plan
        kw.setdefault('device', plan.device)
        super().__init__(
            iterator, optimizer, stage_fn, loss_on_last, params_stacked,
            plan.mesh, n_micro, schedule=schedule,
            param_specs=param_specs, data_axis=plan.data_axes[0],
            stage_axis=plan.pipe_axis, tp_axis=tp_axis, **kw)
