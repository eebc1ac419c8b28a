"""The 3-D plan and ``MeshPipelineUpdater`` against the JAX package's.

The counterparts of ``tests/test_mesh_pipeline.py`` and
``tests/test_meshplan.py:68-114``:

- ``MeshPlan.create(tp=, pp=)`` degrades as the JAX plan does (shape-only,
  every process count 1..8 and tp, pp 1..4; ``describe`` equal),
  ``stage_specs`` and ``models.pipeline_stage_specs`` give the JAX
  specs as tuples, and the constructor's plan checks;
- one spawn of four gloo processes: a tiny ``TransformerLM`` through
  ``MeshPipelineUpdater`` on the plans ``(2, 1, 2)``, ``(1, 2, 2)`` (tp
  inside the stages), ``(1, 1, 4)`` and the pp fallback ``(2, 2, 1)``,
  1F1B with the local loss, against the JAX ``MeshPipelineUpdater`` on
  four host devices and against the single-device oracle trajectory
  (losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-5); gpipe with the
  global loss and with ``remat`` against the oracle; ``Policy.bf16()``
  at rtol 5e-2; the plain ``PipelineUpdater`` over ``pipeline_mesh``
  against the plan's path; the stage tree cut by
  ``models.shard_variables`` and gathered back; a snapshot at tp x pp =
  2 x 2 resumed bit for bit; the 1F1B guard admitting the tensor-parallel
  sums and rejecting a data-axis one.

The JAX guard test on the ``(1, 2, 2)`` plan rejects a ``pmean`` over a
data axis of one device by its primitive; the port issues no collective
over an axis of one process, so its counterpart runs on ``(2, 1, 2)``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chainermn_tpu.models import (TransformerLM as JaxLM,
                                  lm_loss as jlm_loss,
                                  pipeline_parts as jpipeline_parts,
                                  pipeline_stage_specs as jstage_specs)
from chainermn_tpu.parallel.meshplan import MeshPlan as JaxMeshPlan
from chainermn_tpu.precision import Policy as JaxPolicy, cast_floating
from chainermn_tpu.training import MeshPipelineUpdater as JaxMPU
from chainermn_tpu_torch import models, training
from chainermn_tpu_torch.communicators import mesh_utility
from chainermn_tpu_torch.parallel import MeshPlan
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

SEQ, VOCAB, N_STEPS = 16, 64, 3
CFG = dict(vocab_size=VOCAB, d_model=32, n_heads=4, n_layers=4, d_ff=64,
           max_len=SEQ)
PLANS = {'dp2_pp2': (1, 2), 'tp2_pp2': (2, 2), 'pp4': (1, 4),
         'tp2_pp1': (2, 1)}


def _tuple(spec):
    return tuple(spec)


@pytest.mark.parametrize('n', range(1, 9))
def test_create_pp_degrades_as_jax(n):
    for tp in range(1, 5):
        for pp in range(1, 5):
            got = MeshPlan.create(tp=tp, pp=pp, size=n)
            want = JaxMeshPlan.create(tp=tp, pp=pp,
                                      devices=jax.devices()[:n])
            assert tuple(got.mesh.shape.values()) == tuple(
                want.mesh.shape.values()), (n, tp, pp)
            assert got.axis_names == want.axis_names
            assert (got.data_size, got.model_size, got.pipe_size) == (
                want.data_size, want.model_size, want.pipe_size)
            assert got.describe() == want.describe()
            assert mesh_utility.divisors_leq(n, (tp, pp)) == \
                jax_divisors(n, (tp, pp))


def jax_divisors(n, ks):
    from chainermn_tpu.communicators import mesh_utility as jmu
    return jmu.divisors_leq(n, ks)


def test_pp_plan_cases_of_the_jax_tests():
    plan = MeshPlan.create(tp=2, pp=2, size=8, rank=5)
    assert plan.axis_names == ('data', 'model', 'pipe')
    assert (plan.data_size, plan.model_size, plan.pipe_size) == (2, 2, 2)
    assert plan.pipe_axis == 'pipe' and plan.requested_pp == 2
    # the pipe axis minor: rank = (d * tp + m) * pp + p
    assert plan.mesh.coords == (1, 0, 1)
    assert MeshPlan.create(tp=2, size=8).axis_names == ('data', 'model')
    assert MeshPlan.create(tp=2, pp=1, size=8).axis_names == (
        'data', 'model', 'pipe')
    for kw in (dict(pp=0), dict(tp=0, pp=2)):
        with pytest.raises(ValueError) as got:
            MeshPlan.create(size=4, **dict(dict(tp=1), **kw))
        with pytest.raises(ValueError) as want:
            JaxMeshPlan.create(devices=jax.devices()[:4],
                               **dict(dict(tp=1), **kw))
        assert str(got.value) == str(want.value)
    for kw in (dict(ep=2), dict(slices=1)):
        with pytest.raises(NotImplementedError, match='item 8'):
            MeshPlan.create(tp=2, pp=2, size=4, **kw)
    # no data-parallel communicator over stages
    with pytest.raises(NotImplementedError, match='MeshPipelineUpdater'):
        MeshPlan.create(tp=1, pp=2, size=4).communicator()


def test_stage_specs_equal_jax():
    plan = MeshPlan.create(tp=1, pp=2, size=8)
    jplan = JaxMeshPlan.create(tp=1, pp=2)
    stacked = {'w': np.zeros((2, 4, 4)), 'b': np.zeros((2, 4))}
    want = jplan.stage_specs(stacked)
    assert plan.stage_specs(stacked) == jax.tree_util.tree_map(
        _tuple, want, is_leaf=lambda v: isinstance(v, P))
    body = {'w': (None, 'model'), 'b': (None,)}
    jbody = {'w': P(None, 'model'), 'b': P(None)}
    want = jplan.stage_specs(stacked, jbody)
    assert plan.stage_specs(stacked, body) == jax.tree_util.tree_map(
        _tuple, want, is_leaf=lambda v: isinstance(v, P))
    with pytest.raises(ValueError, match='pipeline axis'):
        MeshPlan.create(tp=2, size=4).stage_specs(stacked)


@functools.lru_cache(maxsize=None)
def _params():
    model = JaxLM(dtype=jnp.float32, **CFG)
    return jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros(
        (1, SEQ), jnp.int32))['params'])


def _data(n=8, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, VOCAB, (n, SEQ)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


@pytest.mark.parametrize('tp_axis', [None, 'model'])
def test_pipeline_stage_specs_equal_jax(tp_axis):
    model = JaxLM(dtype=jnp.float32, **CFG)
    _sf, _pro, _ll, stacked, _extra = jpipeline_parts(
        model, _params(), 2, local_loss=True, tp_axis=tp_axis)
    want = jstage_specs(stacked, pipe_axis='pipe', tp_axis=tp_axis)
    tmodel = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    _sf, _pro, _ll, tstacked, textra = models.pipeline_parts(
        tmodel, _params(), 2, local_loss=True, tp_axis=tp_axis)
    got = models.pipeline_stage_specs(tstacked, pipe_axis='pipe',
                                      tp_axis=tp_axis)
    assert got == jax.tree_util.tree_map(
        _tuple, want, is_leaf=lambda v: isinstance(v, P))
    # the same stacked tree and ends as the JAX split
    for k, v in flat_tree(jax.device_get(stacked)).items():
        np.testing.assert_array_equal(flat_tree(tstacked)[k], v)
    assert set(flat_tree(textra)) == set(flat_tree(jax.device_get(_extra)))
    plan = MeshPlan.create(tp=2, pp=2, size=4)
    for (k, v), spec in zip(flat_tree(tstacked).items(),
                            flat_tree(got).values()):
        plan.local_shape(v.shape, spec)
    # the model checks of the JAX function
    with pytest.raises(ValueError, match='split'):
        models.pipeline_parts(tmodel, _params(), 3)
    seq = models.TransformerLM(dtype=torch.float32, device='cpu',
                               sequence_axis='sp', **CFG)
    with pytest.raises(ValueError, match='sequence_axis'):
        models.pipeline_parts(seq, _params(), 2)


def test_plan_checks_of_the_updater():
    stacked = {'w': np.zeros((2, 8, 8), np.float32)}
    kw = dict(iterator=iter([]), optimizer=lambda ps: torch.optim.SGD(
        ps, lr=0.1), stage_fn=None, loss_on_last=None, params_stacked=stacked,
        n_micro=2, device='cpu')
    with pytest.raises(ValueError, match='pipeline axis'):
        training.MeshPipelineUpdater(plan=MeshPlan.create(tp=2, size=4),
                                     **kw)
    with pytest.raises(ValueError, match='tp_axis'):
        training.MeshPipelineUpdater(
            plan=MeshPlan.create(tp=1, pp=2, size=4),
            param_specs={'w': ('pipe', None, 'data')}, **kw)
    upd = training.MeshPipelineUpdater(
        plan=MeshPlan.create(tp=1, pp=2, size=4, rank=3), **kw)
    assert upd.schedule == '1f1b'
    assert (upd.n_stages, upd.n_data) == (2, 2)


# ---------------------------------------------------------------------
# the updater on four processes

_BODY = r'''
from chainermn_tpu_torch import models, serializers
from chainermn_tpu_torch.parallel import MeshPlan, resolve_axis, tensor
from chainermn_tpu_torch.precision import Policy
from chainermn_tpu_torch.training import (
    MeshPipelineUpdater, PipelineUpdater, pipeline_mesh)

params = load_tree(argv[0], 'params/')
with np.load(argv[0]) as f:
    toks, tgts = f['toks'], f['tgts']
cfg, plans, tmp = eval(argv[1]), eval(argv[2]), argv[3]
batch = [(toks[i], tgts[i]) for i in range(len(toks))]


def sgd(ps):
    return torch.optim.SGD(ps, lr=0.1, momentum=0.9)


def updater(plan, schedule='1f1b', local_loss=True, policy=None,
            remat=False, dtype=torch.float32):
    model = models.TransformerLM(dtype=dtype, device='cpu', **cfg)
    tp_axis = plan.model_axis if plan.model_size > 1 else None
    sf, pro, ll, st, ex = models.pipeline_parts(
        model, params, plan.pipe_size, local_loss=local_loss,
        tp_axis=tp_axis)
    specs = models.pipeline_stage_specs(st, pipe_axis=plan.pipe_axis,
                                        tp_axis=tp_axis)
    upd = MeshPipelineUpdater(iter([]), sgd, sf, ll, st, plan, n_micro=2,
                              prologue=pro, extra_params=ex,
                              param_specs=specs, schedule=schedule,
                              policy=policy, remat=remat)
    return upd, st, specs


def run(key, upd, n=3):
    res[key + '/loss'] = np.array(
        [float(upd.update_core(upd.shard_batch(batch))['loss'])
         for _ in range(n)])
    for k, v in flat_tree(upd.params).items():
        res[key + '/p/' + k] = v
    for k, v in flat_tree(upd.extra).items():
        res[key + '/e/' + k] = v


made = {}
for name, (tp, pp) in plans.items():
    plan = made[name] = MeshPlan.create(tp=tp, pp=pp, device='cpu')
    res[name + '/axes'] = np.array(list(plan.mesh.shape.values()))
    upd, st, specs = updater(plan)
    # the updater's stage is models.shard_variables' cut of the tree
    mine = models.shard_variables(st, specs, plan.mesh)
    res[name + '/cut_equal'] = np.array(all(
        np.array_equal(a[0], b.detach().numpy()) for a, b in zip(
            flat_tree(mine).values(), upd._stage_list)))
    back = models.gather_variables(mine, specs, plan.mesh)
    res[name + '/gather_equal'] = np.array(all(
        np.array_equal(a, b) for a, b in zip(
            flat_tree(back).values(), flat_tree(st).values())))
    run(name + '/1f1b', upd)
    if name in ('dp2_pp2', 'tp2_pp2'):
        for sched, remat in (('gpipe', False), ('gpipe', True)):
            upd, _, _ = updater(plan, sched, local_loss=False, remat=remat)
            run('%s/%s%s' % (name, sched, '_remat' if remat else ''), upd)

plan = made['tp2_pp2']
upd, _, _ = updater(plan, policy=Policy.bf16(), dtype=torch.bfloat16)
run('bf16', upd)

# the plain updater over pipeline_mesh is the plan's path
for sched in ('gpipe', '1f1b'):
    for key, mesh_or_plan in (('old', pipeline_mesh(2, device='cpu')),
                              ('new', made['dp2_pp2'])):
        rng = np.random.RandomState(0)
        stacked = {'w': (rng.randn(2, 8, 8) * 0.5).astype(np.float32),
                   'b': (rng.randn(2, 8) * 0.1).astype(np.float32)}
        x = rng.randn(8, 8).astype(np.float32)
        yv = rng.randn(8, 8).astype(np.float32)
        args = (iter([]), lambda ps: torch.optim.SGD(ps, lr=0.1),
                lambda p, a: torch.tanh(a @ p['w'] + p['b']),
                lambda o, t: (((o - t) ** 2).mean(), {}), stacked)
        if key == 'old':
            u = PipelineUpdater(*args, mesh_or_plan, n_micro=2,
                                schedule=sched, device='cpu')
        else:
            u = MeshPipelineUpdater(*args, mesh_or_plan, n_micro=2,
                                    schedule=sched)
        res['shim/%s/%s' % (sched, key)] = np.array(
            [float(u.update_core(u.shard_batch(
                [(x[i], yv[i]) for i in range(8)]))['loss'])
             for _ in range(3)])

# a snapshot at tp x pp = 2 x 2, resumed bit for bit
upd, _, _ = updater(plan)
for _ in range(2):
    upd.update_core(upd.shard_batch(batch))
path = serializers.save_npz('%s/snap_%d' % (tmp, rank),
                            serializers.updater_state(upd))
upd.update_core(upd.shard_batch(batch))
want = flat_tree(dict(p=upd.params, e=upd.extra))
fresh, _, _ = updater(plan)
serializers.resume_updater(path, fresh)
fresh.update_core(fresh.shard_batch(batch))
got = flat_tree(dict(p=fresh.params, e=fresh.extra))
res['resume_equal'] = np.array(all(np.array_equal(got[k], want[k])
                                   for k in want))
with np.load(path) as snap:
    res['snap_qkv_shape'] = np.array(snap['params/qkv/kernel'].shape)
    res['snap_mu_shape'] = np.array(
        snap['opt_state/stages/qkv/kernel/momentum_buffer'].shape)

# the guard: a data-axis sum in the stage is refused, on (2, 1, 2)
bad = MeshPipelineUpdater(
    iter([]), lambda ps: torch.optim.SGD(ps, lr=0.1),
    lambda p, a: torch.tanh(a @ p['w']) + tensor.psum(a, 'data') / 2,
    lambda o, t: (((o - t) ** 2).mean(), {}),
    {'w': np.zeros((2, 8, 8), np.float32)}, made['dp2_pp2'], n_micro=2)
try:
    bad.update_core(bad.shard_batch([(np.zeros(8, np.float32),
                                      np.zeros(8, np.float32))] * 4))
    res['guard'] = np.array('ok')
except ValueError as e:
    res['guard'] = np.array(str(e))
'''


@functools.lru_cache(maxsize=None)
def _oracle(policy_name=None):
    """The single-device full-batch SGD trajectory (the JAX test's
    ``_oracle_losses``) and its parameters after the steps."""
    policy = JaxPolicy.bf16() if policy_name else None
    model = JaxLM(dtype=jnp.bfloat16 if policy else jnp.float32, **CFG)
    toks, tgts = _data()
    loss_fn = jlm_loss(lambda p, t: model.apply({'params': p}, t))
    opt = optax.sgd(0.1, momentum=0.9)
    params = _params()
    if policy is not None:
        params = cast_floating(params, policy.param_dtype)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        def wrapped(pp):
            cp = policy.cast_to_compute(pp) if policy else pp
            loss, _ = loss_fn(cp, jnp.asarray(toks), jnp.asarray(tgts))
            return loss.astype(jnp.float32)
        loss, g = jax.value_and_grad(wrapped)(p)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    out = []
    for _ in range(N_STEPS):
        params, state, loss = step(params, state)
        out.append(float(loss))
    return np.array(out), jax.device_get(params)


@functools.lru_cache(maxsize=None)
def _jax_updater(name):
    tp, pp = PLANS[name]
    plan = JaxMeshPlan.create(tp=tp, pp=pp, devices=jax.devices()[:4])
    tp_axis = plan.model_axis if plan.model_size > 1 else None
    model = JaxLM(dtype=jnp.float32, **CFG)
    sf, pro, ll, st, ex = jpipeline_parts(model, _params(), plan.pipe_size,
                                          local_loss=True, tp_axis=tp_axis)
    specs = jstage_specs(st, pipe_axis=plan.pipe_axis, tp_axis=tp_axis)
    upd = JaxMPU(iter([]), optax.sgd(0.1, momentum=0.9), sf, ll, st, plan,
                 n_micro=2, prologue=pro, extra_params=ex,
                 param_specs=specs, donate=False)
    toks, tgts = _data()
    batch = [(toks[i], tgts[i]) for i in range(len(toks))]
    losses = [float(upd.update_core(upd.shard_batch(batch))['loss'])
              for _ in range(N_STEPS)]
    return np.array(losses), tuple(plan.mesh.shape.values())


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('mesh_pipeline')
    toks, tgts = _data()
    save_tree(tmp / 'in.npz', {'params': _params()}, toks=toks, tgts=tgts)
    return spawn(tmp, _BODY, 4, [tmp / 'in.npz', repr(CFG), repr(PLANS),
                                 tmp], deadline=400)


def _hold_params(res, key, oracle_params, n_stages):
    """The stage-stacked body ``(S, L/S, ...)`` against ``block_i`` and
    the ends against the oracle's tree."""
    n_per = CFG['n_layers'] // n_stages
    body = {k[len(key) + 3:]: v for k, v in res.items()
            if k.startswith(key + '/p/')}
    for i in range(CFG['n_layers']):
        s, j = divmod(i, n_per)
        for k, want in flat_tree(oracle_params['block_%d' % i]).items():
            np.testing.assert_allclose(body[k][s][j], want, rtol=1e-4,
                                       atol=1e-5, err_msg='%s %d' % (k, i))
    np.testing.assert_allclose(res[key + '/e/embedding'],
                               oracle_params['embed']['embedding'],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(res[key + '/e/lm_head/kernel'],
                               oracle_params['lm_head']['kernel'],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('name', list(PLANS))
def test_1f1b_matches_jax_and_the_oracle(ranks, name):
    oracle, oparams = _oracle()
    want, axes = _jax_updater(name)
    np.testing.assert_allclose(want, oracle, rtol=1e-5)
    for res in ranks:
        assert tuple(res[name + '/axes']) == axes
        assert bool(res[name + '/cut_equal'])
        assert bool(res[name + '/gather_equal'])
        np.testing.assert_allclose(res[name + '/1f1b/loss'], want,
                                   rtol=1e-5)
        _hold_params(res, name + '/1f1b', oparams, PLANS[name][1])


@pytest.mark.parametrize('name', ['dp2_pp2', 'tp2_pp2'])
@pytest.mark.parametrize('sched', ['gpipe', 'gpipe_remat'])
def test_gpipe_global_loss_matches_the_oracle(ranks, name, sched):
    oracle, oparams = _oracle()
    for res in ranks:
        np.testing.assert_allclose(res['%s/%s/loss' % (name, sched)],
                                   oracle, rtol=1e-5)
        _hold_params(res, '%s/%s' % (name, sched), oparams, 2)


def test_bf16_matches_the_oracle(ranks):
    oracle, _ = _oracle('bf16')
    for res in ranks:
        np.testing.assert_allclose(res['bf16/loss'], oracle, rtol=5e-2)


@pytest.mark.parametrize('sched', ['gpipe', '1f1b'])
def test_plain_updater_is_the_plan_path(ranks, sched):
    for res in ranks:
        np.testing.assert_allclose(res['shim/%s/old' % sched],
                                   res['shim/%s/new' % sched], rtol=1e-6)


def test_snapshot_at_tp_pp_resumes_bit_for_bit(ranks):
    for res in ranks:
        assert bool(res['resume_equal'])
        # the JAX stacked layout, full over the stages and the shards:
        # qkv (S, L/S, d, 3, H, d_head)
        assert tuple(res['snap_qkv_shape']) == (2, 2, 32, 3, 4, 8)
        assert tuple(res['snap_mu_shape']) == (2, 2, 32, 3, 4, 8)


def test_guard_refuses_a_data_axis_sum_in_the_stage(ranks):
    for res in ranks:
        msg = str(res['guard'])
        assert msg.startswith("stage_fn under schedule='1f1b' contains "
                              "collective primitives"), msg
        assert 'psum over data' in msg
