"""The port's mesh-aware trust ratios (LARS, LAMB) and ZeRO with a policy.

In this process: ``zero.lars`` / ``zero.lamb`` / ``zero.chain(zero.
scale_by_trust_ratio(), ...)`` stepped on the same parameters and
gradients as ``optax.lars`` / ``optax.lamb`` / ``optax.chain(optax.
scale_by_trust_ratio(), ...)`` (5 steps, 1e-5), the refusal inside a
scope without a per-leaf rule, and the loss-scaled skip of a ZeRO step
against the JAX ZeRO updater.  One spawn of four gloo processes trains
the JAX ZeRO tests' MLP (odd widths: shard padding) with LARS and LAMB
both ways -- ``zero=False`` (the multi-node wrapper, local norms of the
reduced gradients) and ``zero=True`` (norms completed over the data
group) -- against the JAX ``StandardUpdater(zero=False)`` with
``optax.lars`` / ``optax.lamb`` on 4 host devices (losses and parameters
at atol 1e-5 over 4 steps), and ``zero=True`` with ``Policy.bf16()``
against JAX ``test_bf16_policy_zero_path``'s construction (rel 5e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import precision as jprecision, training as jtraining
from chainermn_tpu.models import MLP as JaxMLP, Classifier as JaxClassifier
from chainermn_tpu_torch import precision, training
from chainermn_tpu_torch.parallel import zero
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

STEPS = 4
LARS_KW = dict(learning_rate=0.5, weight_decay=1e-4, trust_coefficient=0.1,
               momentum=0.9)
LAMB_KW = dict(learning_rate=1e-2, weight_decay=1e-4)


# ------------------------------------------------ the optimizers alone
def _sched(count):
    return 0.5 / (1.0 + count)


CASES = {
    'lars': (lambda ps: zero.lars(ps, **LARS_KW), optax.lars(**LARS_KW)),
    'lars_nesterov': (
        lambda ps: zero.lars(ps, nesterov=True, **LARS_KW),
        optax.lars(nesterov=True, **LARS_KW)),
    'lars_schedule': (
        lambda ps: zero.lars(ps, _sched, eps=1e-3, momentum=0.5),
        optax.lars(_sched, eps=1e-3, momentum=0.5)),
    'lamb': (lambda ps: zero.lamb(ps, **LAMB_KW), optax.lamb(**LAMB_KW)),
    'lamb_eps_root': (
        lambda ps: zero.lamb(ps, 1e-2, b1=0.8, eps_root=1e-8),
        optax.lamb(1e-2, b1=0.8, eps_root=1e-8)),
    'lamb_schedule': (lambda ps: zero.lamb(ps, _sched, weight_decay=0.1),
                      optax.lamb(_sched, weight_decay=0.1)),
    'trust_then_sgd': (
        lambda ps: zero.chain(zero.scale_by_trust_ratio(
            trust_coefficient=0.2, eps=1e-4), torch.optim.SGD(ps, lr=0.1)),
        optax.chain(optax.scale_by_trust_ratio(trust_coefficient=0.2,
                                               eps=1e-4), optax.sgd(0.1))),
}


def _leaves(seed):
    rng = np.random.RandomState(seed)
    shapes = [(5, 3), (7,), (2, 2, 3), (4,)]
    params = [rng.randn(*s).astype(np.float32) for s in shapes]
    params[3][:] = 0.0          # a zero-norm leaf: the ratio is 1
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(5)]
    return params, grads


@pytest.mark.parametrize('name', sorted(CASES))
def test_optimizer_matches_optax(name):
    make, tx = CASES[name]
    params, grads = _leaves(0)
    ps = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = make(ps)
    zero.check_elementwise(opt)            # admitted under zero=True
    jps = [jnp.asarray(p) for p in params]
    state = tx.init(jps)
    for g in grads:
        for p, gg in zip(ps, g):
            p.grad = torch.from_numpy(gg.copy())
        opt.step()
        u, state = tx.update([jnp.asarray(gg) for gg in g], state, jps)
        jps = optax.apply_updates(jps, u)
        for p, jp in zip(ps, jps):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp),
                                       rtol=0, atol=1e-5)
    moved = max(float((p.detach() - torch.from_numpy(q)).abs().max())
                for p, q in zip(ps, params))
    assert moved > 1e-3


def test_trust_ratio_refuses_without_a_leaf_rule():
    ps = [torch.nn.Parameter(torch.ones(3))]
    ps[0].grad = torch.ones(3)
    opt = zero.lars(ps, 0.1)
    # a sharded context that gives a global rule and no per-leaf one (the
    # 1F1B schedule's)
    with zero.mesh_norm_scope(zero.tree_sumsq):
        with pytest.raises(ValueError, match='per-leaf norm rule'):
            opt.step()
        with pytest.raises(ValueError, match='per-leaf norm rule'):
            zero.scale_by_trust_ratio()(ps)
    # a per-leaf rule is what the ratios read: doubling every norm
    # squared leaves the ratio (p over u) as it was
    with torch.no_grad():
        ref = zero.trust_ratios(ps, [torch.full((3,), 2.0)])
        with zero.mesh_norm_scope(
                zero.tree_sumsq,
                leaf_sumsq=lambda _, ts: 2 * zero.leaf_sumsqs(ts)):
            got = zero.trust_ratios(ps, [torch.full((3,), 2.0)])
    torch.testing.assert_close(got, ref)
    assert float(ref[0]) == pytest.approx(0.5)


class _Dot(torch.nn.Module):
    """``(w * x).sum()``: the JAX precision test's loss, as a module."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def loss(self, x):
        return (self.w * x).sum(), {}


def test_zero_loss_scaled_step_skips_on_the_shards():
    """ZeRO under a loss-scaled policy, against the JAX ZeRO updater: the
    first call broadcasts (kept even on a non-finite batch), a non-finite
    step leaves the parameters and the sharded state as they were, the
    scale backs off, the next finite step steps."""
    kw = dict(initial_scale=4.0, growth_interval=2)
    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jpol = jprecision.Policy(param_dtype=jnp.float32,
                             compute_dtype=jnp.float32,
                             loss_scale=jprecision.DynamicLossScale(**kw))
    jup = jtraining.StandardUpdater(
        iter([]), optax.sgd(0.1, momentum=0.9),
        lambda p, x: ((p['w'] * x).sum(), {}), {'w': jnp.ones((4,))}, jcomm,
        has_aux=True, policy=jpol, donate=False, zero=True)
    comm = cmt.create_communicator('xla', device='cpu')
    pol = precision.Policy(loss_scale=precision.DynamicLossScale(**kw))
    model = _Dot()
    inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    up = training.StandardUpdater(iter([]), inner, model.loss, model, comm,
                                  policy=pol, zero=True)
    bad = np.ones((8, 4), np.float32)
    bad[0, 0] = np.inf
    good = np.ones((8, 4), np.float32)
    for batch, finite in ((bad, 0.0), (good, 1.0), (bad, 0.0),
                          (good, 1.0)):
        shard = up._zero.shards[model.w]
        before = (model.w.detach().clone(),
                  {k: v.clone() for k, v in inner.state[shard].items()})
        got = {k: float(v) for k, v in up.update_core(
            (torch.from_numpy(batch),)).items()}
        want = {k: float(v) for k, v in jup.update_core(
            jup.shard_batch((batch,))).items()}
        assert (got['loss_scale'], got['grads_finite']) == \
            (want['loss_scale'], want['grads_finite'])
        assert got['grads_finite'] == finite
        np.testing.assert_allclose(model.w.detach().numpy(),
                                   np.asarray(jup.params['w']), rtol=1e-6)
        if not finite:
            assert torch.equal(model.w.detach(), before[0])
            for k, v in before[1].items():
                assert torch.equal(inner.state[shard][k], v)
    assert float(up.scale_state.scale) == float(jup.scale_state.scale)


# ----------------------------------------------- the spawned updaters
N_EX, N_IN, N_UNITS, N_OUT = 32, 6, 17, 3

_BODY = r'''
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import models, precision, training
from chainermn_tpu_torch.parallel import zero

f = np.load(argv[0])
steps = int(argv[1])
lars_kw, lamb_kw = eval(argv[2]), eval(argv[3])
comm = cmt.create_communicator('xla', device='cpu')
OPT = {'lars': lambda ps: zero.lars(ps, **lars_kw),
       'lamb': lambda ps: zero.lamb(ps, **lamb_kw),
       'adam': lambda ps: torch.optim.Adam(ps, lr=1e-2)}


def make(opt, on, prefix, n_units, n_out, n_in, policy=None):
    model = models.MLP(n_units=n_units, n_out=n_out, n_in=n_in,
                       device='cpu')
    models.load_flax_variables(model, {'params': load_tree(argv[0],
                                                           prefix)})
    inner = OPT[opt](model.parameters())
    x, y = f[prefix[:-1] + '_x'], f[prefix[:-1] + '_y']
    per = len(x) // comm.size
    mine = [(x[i], y[i]) for i in range(comm.rank * per,
                                        (comm.rank + 1) * per)]
    return training.StandardUpdater(
        training.SerialIterator(mine, per, shuffle=False),
        inner if on else cmt.create_multi_node_optimizer(inner, comm),
        models.Classifier(model), model, comm, zero=bool(on),
        policy=policy), model


def record(key, up, model, n):
    res[key + '/losses'] = np.array([up.update()['loss'] for _ in range(n)])
    for name, v in flat_tree(models.to_flax_variables(model)[
            'params']).items():
        res[key + '/p/' + name] = v.copy()


for opt in ('lars', 'lamb'):
    for on in (0, 1):
        record('%s/%d' % (opt, on),
               *make(opt, on, 'mlp/', 17, 3, 6), steps)
for tag, policy in (('f32', None), ('bf16', precision.Policy.bf16())):
    up, model = make('adam', 1, 'pol/', 16, 10, 784, policy=policy)
    record('policy/' + tag, up, model, 10)
    res['policy/%s/dtypes' % tag] = np.array(sorted(
        str(p.dtype) for p in model.parameters()))
'''


def _mlp(seed, n_ex, n_in, n_units, n_out, label):
    rng = np.random.RandomState(0)
    x = rng.rand(n_ex, n_in).astype(np.float32)
    if label == 'argmax':
        w = rng.rand(n_in, n_out).astype(np.float32)
        y = np.argmax(x @ w, axis=1).astype(np.int32)
    else:
        y = rng.randint(0, n_out, n_ex).astype(np.int32)
    jm = JaxMLP(n_units=n_units, n_out=n_out)
    params = jax.device_get(jm.init(jax.random.PRNGKey(seed),
                                    jnp.zeros((1, n_in)))['params'])
    return jm, params, x, y


def _inputs():
    return {'mlp/': _mlp(0, N_EX, N_IN, N_UNITS, N_OUT, 'argmax'),
            'pol/': _mlp(0, 64, 784, 16, 10, 'random')}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('trust_ratio')
    tree, extra = {}, {}
    for prefix, (_, params, x, y) in _inputs().items():
        tree[prefix[:-1]] = params
        extra[prefix[:-1] + '_x'], extra[prefix[:-1] + '_y'] = x, y
    save_tree(tmp / 'in.npz', tree, **extra)
    return spawn(tmp, _BODY, 4, [tmp / 'in.npz', STEPS, repr(LARS_KW),
                                 repr(LAMB_KW)])


def _jax_run(prefix, opt, n, zero_on=False, policy=None, devices=4):
    jm, params, x, y = _inputs()[prefix]
    comm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:devices])
    if not zero_on:
        opt = chainermn_tpu.create_multi_node_optimizer(opt, comm)
    up = jtraining.StandardUpdater(
        iter([]), opt, JaxClassifier(lambda p, v: jm.apply({'params': p}, v)),
        params, comm, has_aux=True, zero=zero_on, policy=policy,
        donate=False)
    batch = up.shard_batch([(x[i], y[i]) for i in range(len(x))])
    losses = [float(up.update_core(batch)['loss']) for _ in range(n)]
    return np.array(losses), flat_tree(jax.device_get(up.params)), params


def _params(res, key):
    return {k[len(key + '/p/'):]: v for k, v in res.items()
            if k.startswith(key + '/p/')}


@pytest.mark.parametrize('opt', ['lars', 'lamb'])
def test_replicated_run_matches_optax(ranks, opt):
    tx = {'lars': optax.lars(**LARS_KW), 'lamb': optax.lamb(**LAMB_KW)}[opt]
    losses, want, _ = _jax_run('mlp/', tx, STEPS)
    for res in ranks:
        np.testing.assert_allclose(res[opt + '/0/losses'], losses,
                                   rtol=0, atol=1e-5)
        got = _params(res, opt + '/0')
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize('opt', ['lars', 'lamb'])
def test_zero_run_matches_the_replicated_run(ranks, opt):
    start = flat_tree(_inputs()['mlp/'][1])
    for res in ranks:
        np.testing.assert_allclose(res[opt + '/1/losses'],
                                   res[opt + '/0/losses'], rtol=0, atol=1e-5)
        got, want = _params(res, opt + '/1'), _params(res, opt + '/0')
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=1e-5, err_msg=name)
        # the optimizer moved the parameters
        assert max(np.abs(got[k] - start[k]).max() for k in start) > 1e-3
    # every process holds the same parameters
    for res in ranks[1:]:
        for name, v in _params(res, opt + '/1').items():
            np.testing.assert_array_equal(v, _params(ranks[0],
                                                     opt + '/1')[name])


def test_zero_with_bf16_policy_tracks_jax_and_f32(ranks):
    # JAX test_bf16_policy_zero_path: xla communicator on every device
    jl32, _, _ = _jax_run('pol/', optax.adam(1e-2), 10, zero_on=True,
                          devices=len(jax.devices()))
    jlbf, _, _ = _jax_run('pol/', optax.adam(1e-2), 10, zero_on=True,
                          policy=jprecision.Policy.bf16(),
                          devices=len(jax.devices()))
    assert jlbf[-1] == pytest.approx(jl32[-1], rel=5e-2)
    for res in ranks:
        lbf, l32 = res['policy/bf16/losses'], res['policy/f32/losses']
        assert lbf[-1] == pytest.approx(l32[-1], rel=5e-2)
        assert lbf[-1] == pytest.approx(jlbf[-1], rel=5e-2)
        np.testing.assert_allclose(l32, jl32, rtol=1e-4)
        assert set(res['policy/bf16/dtypes']) == {'torch.float32'}
        # the bf16 run is not the f32 run
        assert not np.array_equal(lbf, l32)
