"""Lint-target construction for shardlint.

Counterpart of ``chainermn_tpu/analysis/targets.py``.  A
:class:`LintTarget` pairs a build function with the topology the rules
check against: ``build(rank)``, called inside a ``walker.fake_world`` of
the target's ``world_size`` as that rank, builds everything (communicator,
model, updater, engine) and returns the callable to trace, its
arguments and what the built objects declare (:class:`Built`).  The
runner builds and traces every rank on its own.  Everything is built
OUTSIDE the traced callable: a port communicator makes one all_reduce
over the default group when it is built, which must not enter the
stream.

:func:`strategy_targets` covers every communicator strategy's surface
(``allreduce_grad`` / ``broadcast_data`` / ``send_recv``) on a simulated
world of 8; :data:`STEP_FACTORIES` the port's counterparts of the JAX
registry's fourteen steps: the updaters' ``traceable_step`` (the step
``update()`` runs), the ZeRO cycle, the serving engines' calls.
"""

import numpy as np
import torch

from chainermn_tpu_torch.communicators import mesh_utility

#: the simulated world of the strategy and step sweeps (the JAX sweep's
#: eight virtual devices)
WORLD_SIZE = 8

#: the tiny transformer of the LM targets (the JAX targets' widths)
LM_CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
              max_len=64)


class Built:
    """What ``LintTarget.build(rank)`` returns: ``fn`` and ``args`` to
    trace; ``make_args(iteration)`` (the arguments iteration
    ``iteration`` would pass: the SL007 probe; None disables it); and
    what the built objects declare, each overriding the target's:
    ``mesh_axes``, ``reduction_axes``, ``declared_dtypes``."""

    def __init__(self, fn, args, make_args=None, **declared):
        self.fn, self.args, self.make_args = fn, tuple(args), make_args
        self.declared = declared


class LintTarget:
    """One analysable callable plus the metadata rules need.

    Attributes:
      name: stable display name (``strategy:xla:allreduce_grad``).
      build: ``build(rank) -> Built``, called inside the fake world.
      world_size: the simulated process count; every rank is traced.
      mesh_axes: ``{axis_name: size}`` of the processes' mesh (row-major
        over the ranks); a ``Built`` may declare it instead.
      reduction_axes: declared reduce topology of gradient-reduction
        targets (the communicator's ``reduction_axes``), else None.
      declared_dtypes: dtype names the target declares reductions may
        narrow to (``declared_reduce_dtypes``; SL004 allows these).
      compute_dtype: the dtype name the target's compute is DECLARED to
        run in; enables the SL008 audit when narrow.
      items: items (images / tokens) one step processes (memtraffic's
        bytes per item), None for non-step targets.
      overlap_check: run the SL009 overlap audit (train steps only).
      plan_axes: the MeshPlan axes the target declares it spans
        (enables SL010 / SL011).
      rank_addressed: ops declared rank-asymmetric (SL013 exempts them).
      staged_axes: axes whose reductions are staged on purpose (SL011's
        exemption for the slice plan's cross-slice leg).
    """

    def __init__(self, name, build, world_size, mesh_axes=None,
                 reduction_axes=None, declared_dtypes=None,
                 compute_dtype=None, items=None, overlap_check=False,
                 plan_axes=None, rank_addressed=None, staged_axes=None):
        self.name = name
        self.build = build
        self.world_size = int(world_size)
        self.mesh_axes = dict(mesh_axes or {})
        self.reduction_axes = reduction_axes
        self.declared_dtypes = (tuple(sorted(declared_dtypes))
                                if declared_dtypes else None)
        self.compute_dtype = compute_dtype
        self.items = items
        self.overlap_check = overlap_check
        self.plan_axes = tuple(plan_axes) if plan_axes is not None else None
        self.staged_axes = (tuple(staged_axes) if staged_axes is not None
                            else None)
        self.rank_addressed = tuple(rank_addressed or ())

    def __repr__(self):
        return 'LintTarget(%s)' % self.name


# ---------------------------------------------------------------------
# strategies

def strategy_mesh_shape(name, n):
    """The ``(inter, intra)`` shape a strategy is linted on: balanced
    (the JAX package's ``balanced_2d``, copied), ``(1, n)`` for
    ``single_node``."""
    if name == 'single_node':
        return (1, n)
    intra = int(np.sqrt(n))
    while n % intra:
        intra -= 1
    return (n // intra, intra)


def build_strategy(name, mesh_shape, reduce_dtype=None):
    """A port communicator on the CPU (inside a fake world)."""
    from chainermn_tpu_torch import communicators
    return communicators.create_communicator(
        name, device='cpu', mesh_shape=mesh_shape, reduce_dtype=reduce_dtype)


def _synthetic_grads():
    """Small mixed-shape f32 tensors standing in for gradients."""
    return [torch.zeros(13, 3), torch.zeros(5)]


def strategy_surface(comm):
    """``[(method, fn, args)]``: the collective surface of one built
    strategy -- ``allreduce_grad`` and ``broadcast_data`` of the
    synthetic gradients, ``send_recv`` of a ring over every rank."""
    size = comm.world_size
    perm = [(i, (i + 1) % size) for i in range(size)]
    return [
        ('allreduce_grad', lambda gs: comm.allreduce_grad(list(gs)),
         (_synthetic_grads(),)),
        ('broadcast_data', lambda gs: comm.broadcast_data(list(gs)),
         (_synthetic_grads(),)),
        ('send_recv', lambda x: comm.send_recv(x, perm),
         (torch.zeros(4, 4),)),
    ]


def strategy_targets(names=None, comm_factory=None, reduce_dtype=None,
                     world_size=WORLD_SIZE):
    """Lint targets for each strategy (default: all nine) x its three
    methods.  ``comm_factory(name, rank, world_size)`` overrides
    construction (the fixtures inject known-bad strategies through it);
    ``reduce_dtype`` builds each strategy with that gradient reduce
    dtype (the bf16-policy sweep)."""
    from chainermn_tpu_torch import communicators

    if names is None:
        names = sorted(communicators._COMMUNICATORS)
    out = []
    for name in names:
        mesh = strategy_mesh_shape(name, world_size)

        def build(rank, name=name, mesh=mesh, method=None):
            comm = (comm_factory(name, rank, world_size)
                    if comm_factory is not None
                    else build_strategy(name, mesh, reduce_dtype))
            fn, args = next((f, a) for m, f, a in strategy_surface(comm)
                            if m == method)
            declared = {}
            if method == 'allreduce_grad':
                declared = dict(
                    reduction_axes=tuple(comm.reduction_axes),
                    declared_dtypes=comm.declared_reduce_dtypes())
            return Built(fn, args, **declared)

        for method in ('allreduce_grad', 'broadcast_data', 'send_recv'):
            out.append(LintTarget(
                'strategy:%s:%s' % (name, method),
                lambda rank, b=build, m=method: b(rank, method=m),
                world_size, mesh_axes=dict(zip(mesh_utility.AXES, mesh))))
    return out


# ---------------------------------------------------------------------
# train-step targets

def _policy_compute(policy):
    """The compute dtype a policy declares (the SL008 scope), or None."""
    if policy is None:
        return None
    return str(policy.compute_dtype).replace('torch.', '')


def _policy_batch(policy, batch):
    """The batch dtypes the updater's host-side cast would ship."""
    if policy is None:
        return batch
    return tuple(t.to(policy.compute_dtype) if t.is_floating_point() else t
                 for t in batch)


def _comm_axes(comm):
    return dict(zip(mesh_utility.AXES, comm.mesh_shape))


def _updater_built(updater, batch, mesh_axes):
    """A ``Built`` over ``updater.traceable_step`` at iteration 1."""
    fn, args = updater.traceable_step(batch, iteration=1)
    return Built(fn, args,
                 make_args=lambda it: updater.traceable_step(
                     batch, iteration=it)[1],
                 mesh_axes=mesh_axes,
                 declared_dtypes=updater.declared_reduce_dtypes())


def _mlp_updater(comm, policy, zero=False):
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, training

    torch.manual_seed(0)
    model = models.MLP(n_units=16, n_out=10, device='cpu')
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    if not zero:
        opt = cmt.create_multi_node_optimizer(opt, comm)
    return training.StandardUpdater(iter([]), opt, models.Classifier(model),
                                    model, comm, zero=zero, policy=policy)


def _mlp_batch(policy, n=16):
    return _policy_batch(policy, (torch.zeros(n, 784),
                                  torch.zeros(n, dtype=torch.int64)))


def _step_target(name, build, policy, items, compute_dtype=None, **kw):
    return LintTarget('step:' + name, build, WORLD_SIZE,
                      compute_dtype=compute_dtype or _policy_compute(policy),
                      items=items, overlap_check=True, **kw)


def mlp_step_target(policy=None):
    """The mnist example's train step: MLP + multi-node Adam on the
    ``xla`` strategy, ``StandardUpdater``."""
    def build(rank):
        comm = build_strategy('xla', strategy_mesh_shape('xla', WORLD_SIZE),
                              None)
        return _updater_built(_mlp_updater(comm, policy), _mlp_batch(policy),
                              _comm_axes(comm))
    return _step_target('mlp_example', build, policy, 16)


def bucketed_overlap_step_target(policy=None):
    """The mnist-shaped step on the ``bucketed`` strategy with
    ``bucket_mb`` small enough that the MLP's gradients split into two
    buckets (the 784x16 first-layer weight, ~50 KB, overflows into its
    own): the SL009 clean state against the fused ``mlp_example``."""
    def build(rank):
        from chainermn_tpu_torch import communicators
        comm = communicators.create_communicator(
            'bucketed', device='cpu',
            mesh_shape=strategy_mesh_shape('bucketed', WORLD_SIZE),
            bucket_mb=0.01,
            reduce_dtype=policy.reduce_dtype if policy is not None else None)
        return _updater_built(_mlp_updater(comm, policy), _mlp_batch(policy),
                              _comm_axes(comm))
    return _step_target('bucketed_overlap', build, policy, 16)


def zero_step_target(policy=None):
    """The full ZeRO-1 train step (``StandardUpdater(zero=True)``)."""
    def build(rank):
        comm = build_strategy('xla', strategy_mesh_shape('xla', WORLD_SIZE),
                              None)
        return _updater_built(_mlp_updater(comm, policy, zero=True),
                              _mlp_batch(policy), _comm_axes(comm))
    return _step_target('zero', build, policy, 16)


def zero_core_target(policy=None):
    """The bare ZeRO-1 cycle (``parallel.zero.ZeroStep.step``: reduce-
    scatter, shard update, all-gather) over the synthetic tensors, with
    Adam."""
    def build(rank):
        from chainermn_tpu_torch.parallel import zero
        comm = build_strategy('xla', strategy_mesh_shape('xla', WORLD_SIZE),
                              None)
        ps = [torch.nn.Parameter(t) for t in _synthetic_grads()]
        opt = torch.optim.Adam(ps, lr=1e-3)
        engine = zero.ZeroStep(opt, ps, comm.size, comm.rank)
        shards = [p for g in opt.param_groups for p in g['params']]

        def fn(params, grads):
            try:
                for g in opt.param_groups:
                    g['params'] = list(params)
                step = engine.rebound(list(params))
                for p, g in zip(params, grads):
                    p.grad = g
                step.step()
                return params
            finally:
                opt.param_groups[0]['params'] = shards
                opt.state.clear()

        args = ([p.detach().requires_grad_() for p in ps],
                _synthetic_grads())
        return Built(fn, args, mesh_axes=_comm_axes(comm))
    return LintTarget('step:zero_core', build, WORLD_SIZE,
                      overlap_check=True)


def pipeline_updater(policy=None):
    """``(updater, batch)``: the pipeline updater's gpipe step on a
    (data, stage) mesh of 2 stages over the default group, and its
    batch."""
    from chainermn_tpu_torch.training.pipeline_updater import (
        PipelineUpdater, pipeline_mesh)
    d = 8
    mesh = pipeline_mesh(2, device='cpu')

    def stage_fn(p, x):
        return torch.tanh(x @ p['w'] + p['b'])

    def loss_on_last(outs, y_micro):
        loss = torch.mean((outs - y_micro) ** 2)
        return loss, {'mse': loss}

    stacked = {'w': np.zeros((2, d, d), np.float32),
               'b': np.zeros((2, d), np.float32)}
    upd = PipelineUpdater(
        iter([]), lambda ps: torch.optim.SGD(ps, lr=1e-2), stage_fn,
        loss_on_last, stacked, mesh, n_micro=2, policy=policy,
        device='cpu')
    n = 4
    return upd, _policy_batch(policy, (torch.zeros(n, d),
                                       torch.zeros(n, d)))


def pipeline_step_target(policy=None):
    """The pipeline updater's gpipe train step on a (data, stage)
    mesh."""
    def build(rank):
        upd, batch = pipeline_updater(policy)
        return _updater_built(upd, batch, dict(upd.mesh.shape))
    return _step_target('pipeline', build, policy, 4 * WORLD_SIZE // 2)


def _lm_batch(n):
    z = torch.zeros(n, 16, dtype=torch.int64)
    return (z, z.clone())


def transformer_tp_step_target(policy=None, tp=2):
    """The composed dp x tp train step: a tensor-parallel
    ``TransformerLM(tp_axis='model')`` over ``MeshPlan.create(tp=2)``
    with the plan communicator (gradients reduced over ``data`` only).
    Declares ``plan_axes=('data', 'model')`` for the SL010 family."""
    def build(rank):
        import chainermn_tpu_torch as cmt
        from chainermn_tpu_torch import models, training
        from chainermn_tpu_torch.parallel.meshplan import MeshPlan
        plan = MeshPlan.create(tp=tp, device='cpu')
        comm = plan.communicator(
            reduce_dtype=policy.reduce_dtype if policy is not None else None)
        with plan.bind():
            model = models.TransformerLM(tp_axis=plan.model_axis,
                                         device='cpu', **LM_CFG)
        opt = cmt.create_multi_node_optimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3), comm)
        upd = training.StandardUpdater(iter([]), opt, models.lm_loss(model),
                                       model, comm, policy=policy)
        return _updater_built(upd, _lm_batch(2), dict(plan.mesh.shape))
    return _step_target('transformer_tp', build, policy, 2 * 16,
                        compute_dtype='bfloat16',
                        plan_axes=('data', 'model'))


def _transformer_pp_built(policy, tp, pp):
    from chainermn_tpu_torch import models, training
    from chainermn_tpu_torch.parallel.meshplan import MeshPlan
    plan = MeshPlan.create(tp=tp, pp=pp, device='cpu')
    model = models.TransformerLM(device='cpu', **LM_CFG)
    tp_axis = plan.model_axis if plan.model_size > 1 else None
    stage_fn, prologue, loss_on_last, stacked, extra = models.pipeline_parts(
        model, None, n_stages=plan.pipe_size, local_loss=True,
        tp_axis=tp_axis)
    specs = models.pipeline_stage_specs(stacked, pipe_axis=plan.pipe_axis,
                                        tp_axis=tp_axis)
    upd = training.MeshPipelineUpdater(
        iter([]), lambda ps: torch.optim.SGD(ps, lr=1e-2), stage_fn,
        loss_on_last, stacked, plan, n_micro=2, prologue=prologue,
        extra_params=extra, param_specs=specs, policy=policy)
    return _updater_built(upd, _lm_batch(2), dict(plan.mesh.shape))


def transformer_pp_step_target(policy=None, pp=2):
    """The pipeline-parallel transformer step: dp x pp (tp = 1), 1F1B
    through ``MeshPipelineUpdater`` on ``MeshPlan.create(pp=2)``."""
    return _step_target(
        'transformer_pp', lambda rank: _transformer_pp_built(policy, 1, pp),
        policy, 2 * 16, compute_dtype='bfloat16',
        plan_axes=('data', 'model', 'pipe'))


def transformer_tp_pp_step_target(policy=None, tp=2, pp=2):
    """The fully composed dp x tp x pp step: Megatron sums inside each
    stage, the 1F1B exchange between stages, the data mean at the
    end."""
    return _step_target(
        'transformer_tp_pp',
        lambda rank: _transformer_pp_built(policy, tp, pp), policy, 2 * 16,
        compute_dtype='bfloat16', plan_axes=('data', 'model', 'pipe'))


def mlp_slice_step_target(policy=None, slices=2):
    """The multi-slice data-parallel step: the mnist-shaped step on
    ``MeshPlan.create(slices=2)``, whose gradient reduction is the
    deliberate two-stage hierarchy (a sum inside the slice, then across
    slices).  Declares ``staged_axes=('slice',)``: SL011's exemption
    for that chain."""
    def build(rank):
        from chainermn_tpu_torch.parallel.meshplan import MeshPlan
        plan = MeshPlan.create(slices=slices, device='cpu')
        comm = plan.communicator(
            reduce_dtype=policy.reduce_dtype if policy is not None else None)
        return _updater_built(_mlp_updater(comm, policy), _mlp_batch(policy,
                                                                     2),
                              dict(plan.mesh.shape))
    return _step_target('mlp_slice', build, policy, 2 * WORLD_SIZE,
                        plan_axes=('slice', 'data', 'model'),
                        staged_axes=('slice',))


def _serving_model(plan):
    from chainermn_tpu_torch import models
    with plan.bind():
        model = models.TransformerLM(tp_axis=plan.model_axis, device='cpu',
                                     **LM_CFG)
    full = models.to_flax_variables(models.tp_oracle(model))['params']
    return model, full, models.tp_param_specs(full, plan.model_axis)


def serve_forward_target(policy=None, tp=2):
    """The request-serving forward over the plan: a tensor-parallel
    ``TransformerLM`` behind ``serving.InferenceEngine(plan=)``, traced
    at its largest bucket (``InferenceEngine.traceable_forward``).
    Declares ``plan_axes=('data', 'model')``: the tensor-parallel sums
    run over ``model``, and the port's engine all-gathers each data
    replica's rows of the bucket over ``data`` (the JAX engine's
    shard_map leaves that gather to XLA, outside the traced program, and
    declares ``('model',)`` only)."""
    def build(rank):
        from chainermn_tpu_torch.parallel.meshplan import MeshPlan
        from chainermn_tpu_torch.precision import Policy
        from chainermn_tpu_torch.serving import InferenceEngine
        plan = MeshPlan.create(tp=tp, device='cpu')
        model, _full, _specs = _serving_model(plan)
        tree = {k: v.detach() for k, v in model.named_parameters()}
        eng = InferenceEngine(
            lambda p, t: torch.func.functional_call(model, p, (t,)), tree,
            np.zeros((16,), np.int64), max_batch=16,
            policy=policy or Policy.bf16(), plan=plan, device='cpu')
        bucket = eng.edges[-1]
        fn, args = eng.traceable_forward(bucket)
        return Built(fn, args,
                     make_args=lambda it: eng.traceable_forward(bucket)[1],
                     mesh_axes=dict(plan.mesh.shape))
    return LintTarget('step:serve_forward', build, WORLD_SIZE,
                      compute_dtype='bfloat16', items=16 * 16,
                      plan_axes=('data', 'model'))


def _generation_built(policy, tp, family, draft=False):
    from chainermn_tpu_torch import models
    from chainermn_tpu_torch.parallel.meshplan import MeshPlan
    from chainermn_tpu_torch.precision import Policy
    from chainermn_tpu_torch.serving import GenerationEngine
    plan = MeshPlan.create(tp=tp, device='cpu')
    model, full, specs = _serving_model(plan)
    kw = {}
    if draft:
        small = models.TransformerLM(device='cpu', **dict(LM_CFG,
                                                          n_layers=1))
        kw = dict(draft_model=small, spec_tokens=4,
                  draft_params=models.to_flax_variables(small)['params'])
    eng = GenerationEngine(model, full, n_slots=8, max_prompt_len=16,
                           policy=policy or Policy.bf16(), plan=plan,
                           param_specs=specs, device='cpu', **kw)
    key = (family, eng.n_slots)
    fn, args = eng.traceable_call(key)
    return Built(fn, args, make_args=lambda it: eng.traceable_call(key)[1],
                 mesh_axes=dict(plan.mesh.shape))


def decode_forward_target(policy=None, tp=2):
    """The decode step of a tensor-parallel ``TransformerLM`` as
    ``serving.GenerationEngine(plan=)`` runs it, at the full-slot bucket
    (``GenerationEngine.traceable_call``)."""
    return LintTarget('step:decode_forward',
                      lambda rank: _generation_built(policy, tp, 'decode'),
                      WORLD_SIZE, compute_dtype='bfloat16', items=8,
                      plan_axes=('model',))


def spec_verify_forward_target(policy=None, tp=2, spec_tokens=4):
    """The speculative engine's target verify pass (``spec_tokens``
    query rows a slot) over the plan, at the full-slot bucket."""
    return LintTarget(
        'step:spec_verify_forward',
        lambda rank: _generation_built(policy, tp, 'verify', draft=True),
        WORLD_SIZE, compute_dtype='bfloat16', items=8 * spec_tokens,
        plan_axes=('model',))


def resnet50_step_target(insize=32, batch=8, policy=None, fused_norm=False):
    """The imagenet example's train step: ResNet-50 with BatchNorm state
    (the buffers mean-synced every step), multi-node momentum SGD.
    ``fused_norm=True`` lints the ``batch_norm_act`` variant (on the CPU
    the kernel's plain version, which SL008 exempts)."""
    def build(rank):
        import chainermn_tpu_torch as cmt
        from chainermn_tpu_torch import models, training
        comm = build_strategy('xla', strategy_mesh_shape('xla', WORLD_SIZE),
                              None)
        model = models.ResNet50(num_classes=10, fused_norm=fused_norm,
                                device='cpu')
        opt = cmt.create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
        upd = training.StandardUpdater(
            iter([]), opt, models.StatefulClassifier(model).loss, model, comm,
            policy=policy)
        arrays = _policy_batch(policy, (
            torch.zeros(batch, insize, insize, 3),
            torch.zeros(batch, dtype=torch.int64)))
        return _updater_built(upd, arrays, _comm_axes(comm))
    return _step_target('resnet50_%s' % ('fused' if fused_norm
                                         else 'example'),
                        build, policy, batch, compute_dtype='bfloat16')


#: step name -> factory(policy): the CLI's ``--step`` catalogue, in sweep
#: order; the resnet50 pair sits last (the slowest traces, behind
#: ``--no-resnet50``)
STEP_FACTORIES = {
    'mlp_example': mlp_step_target,
    'zero_core': zero_core_target,
    'zero': zero_step_target,
    'bucketed_overlap': bucketed_overlap_step_target,
    'pipeline': pipeline_step_target,
    'transformer_tp': transformer_tp_step_target,
    'transformer_pp': transformer_pp_step_target,
    'transformer_tp_pp': transformer_tp_pp_step_target,
    'mlp_slice': mlp_slice_step_target,
    'serve_forward': serve_forward_target,
    'decode_forward': decode_forward_target,
    'spec_verify_forward': spec_verify_forward_target,
    'resnet50_example': lambda policy=None: resnet50_step_target(
        policy=policy),
    'resnet50_fused': lambda policy=None: resnet50_step_target(
        policy=policy, fused_norm=True),
}


def step_targets(include_resnet50=True, policy=None, names=None):
    """Step targets from :data:`STEP_FACTORIES`: ``names`` (registry
    keys) builds exactly those, in registry order (an unknown name raises
    ``ValueError``); else the full sweep, the resnet50 pair gated on
    ``include_resnet50``."""
    if names is not None:
        unknown = sorted(set(names) - set(STEP_FACTORIES))
        if unknown:
            raise ValueError('unknown step target(s): %s (valid: %s)'
                             % (', '.join(unknown), ', '.join(STEP_FACTORIES)))
        return [f(policy=policy) for n, f in STEP_FACTORIES.items()
                if n in set(names)]
    return [f(policy=policy) for n, f in STEP_FACTORIES.items()
            if include_resnet50 or not n.startswith('resnet50')]


# ---------------------------------------------------------------------
# the firing self-test: known-bad programs each rule family must catch

def _rank_branch(rank):
    """``if rank == 1: all_reduce(...)``: rank 1 issues an extra
    collective between two every rank issues."""
    import torch.distributed as dist

    def fn(x, y):
        dist.all_reduce(x)
        if rank == 1:
            dist.all_reduce(y)
        dist.barrier()
        return x, y
    return fn, (torch.zeros(4), torch.zeros(4))


def _lonely_send(rank):
    """Rank 0 sends (tag 9) to rank 1, which never receives."""
    import torch.distributed as dist

    def fn(x):
        if rank == 0:
            dist.send(x, 1, tag=9)
        return x
    return fn, (torch.zeros(4),)


def ring_exchange(rank, n, steps, broken=False):
    """``steps`` ring exchanges over ``n`` ranks, each rank sending to
    ``rank + 1`` and receiving from ``rank - 1`` in one
    ``batch_isend_irecv``; ``broken``: the last rank never sends, so the
    chain ``0 -> 1 -> ... -> n-1`` dead-ends and rank 0's receive never
    completes."""
    import torch.distributed as dist

    def fn(x):
        for _ in range(steps):
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.irecv, out, (rank - 1) % n)]
            if not (broken and rank == n - 1):
                ops.insert(0, dist.P2POp(dist.isend, x, (rank + 1) % n))
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            x = out
        return x
    return fn, (torch.zeros(4),)


def fixture_target(name, make, world_size, **kw):
    """A lint target over ``make(rank) -> (fn, args)`` on a one-axis
    mesh (``intra``) of ``world_size`` processes."""
    return LintTarget('fixture:%s' % name,
                      lambda rank: Built(*make(rank)), world_size,
                      mesh_axes={'intra': world_size}, **kw)


def self_test_targets():
    """The CLI's ``--self-test``: a rank-branched collective (SL013),
    an unmatched send and a broken ring (SL014); each must fire."""
    return [fixture_target('rank_branch', _rank_branch, 3),
            fixture_target('unmatched_send', _lonely_send, 2),
            fixture_target('broken_ring',
                           lambda r: ring_exchange(r, 4, 3, broken=True), 4)]


def default_targets(strategies=None, include_steps=True,
                    include_resnet50=True, policy=None, steps=None):
    """The strategy sweep (with the policy's reduce dtype) plus the step
    sweep (under the policy); ``steps`` names exactly the steps."""
    out = strategy_targets(
        strategies,
        reduce_dtype=policy.reduce_dtype if policy is not None else None)
    if steps is not None:
        out.extend(step_targets(policy=policy, names=steps))
    elif include_steps:
        out.extend(step_targets(include_resnet50=include_resnet50,
                                policy=policy))
    return out
