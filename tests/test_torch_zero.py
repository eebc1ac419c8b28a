"""The port's ZeRO-1 (``StandardUpdater(zero=True)``).

One spawn of four gloo processes trains an MLP with SGD, momentum SGD
and Adam both ways, ``zero=True`` (the raw optimizer, its state 1/N) and
``zero=False`` (the multi-node wrapper), from the same flax weights and
batches: the trajectories agree at rtol 1e-5 (the reduce-scatter sums
in another order than the allreduce), and the Adam one equals the JAX
package's ``zero=True`` updater on 4 host devices.  The same spawn holds
``zero.chain(zero.clip_by_global_norm(c), ...)`` against the replicated
clip, ``zero_reduce_dtype=bfloat16`` near f32 (5e-2, the bf16
tolerance), ZeRO with ``accum_steps=2``, ZeRO over the data axis of a
``(2, 2)`` plan (its state 1/2), and an npz snapshot resumed at the
same N (also for AdamW over two parameter groups that interleave
the model's order).  Single-process cases: the refusals (a non-elementwise
optimizer by either probe, the multi-node wrapper, model-sharded specs,
``zero_reduce_dtype`` without ``zero``) and ``zero_check=False``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import MLP as JaxMLP, Classifier as JaxClassifier
from chainermn_tpu_torch import models, training
from chainermn_tpu_torch.parallel import zero
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

N_IN, N_UNITS, N_OUT, N_EX, STEPS = 8, 15, 4, 32, 4
OPTS = ['sgd', 'momentum', 'adam']

_BODY = r'''
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import models, serializers, training
from chainermn_tpu_torch.parallel import MeshPlan, zero

params = load_tree(argv[0], 'params/')
with np.load(argv[0]) as f:
    x, y = f['x'], f['y']
tmp, steps = argv[1], int(argv[2])
examples = [(x[i], y[i]) for i in range(len(x))]
comm = cmt.create_communicator('xla', device='cpu')
plan = MeshPlan.create(tp=2, device='cpu')
pcomm = plan.communicator()
OPT = {'sgd': lambda ps: torch.optim.SGD(ps, lr=0.1),
       'momentum': lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
       'adam': lambda ps: torch.optim.Adam(ps, lr=1e-2),
       'groups': lambda ps: torch.optim.AdamW(_groups(list(ps)), lr=1e-2)}


def _groups(ps):
    # two groups that interleave the model's order: Dense_0's and
    # Dense_1's biases (equal shard shapes) swap places
    k0, b0, k1, b1, k2, b2 = ps
    return [{'params': [k0, b1, k1], 'weight_decay': 0.01},
            {'params': [b0, k2, b2], 'weight_decay': 0.0}]


def make(name, on, comm=comm, clip=None, **kw):
    model = models.MLP(n_units=15, n_out=4, n_in=8, device='cpu')
    models.load_flax_variables(model, {'params': params})
    inner = OPT[name](model.parameters())
    if clip is not None:
        inner = zero.chain(zero.clip_by_global_norm(clip), inner)
    opt = inner if on else cmt.create_multi_node_optimizer(inner, comm)
    per = len(examples) // comm.size
    mine = examples[comm.rank * per:(comm.rank + 1) * per]
    up = training.StandardUpdater(
        training.SerialIterator(mine, per, shuffle=False), opt,
        models.Classifier(model), model, comm, zero=bool(on), **kw)
    return up, model, inner


def record(key, up, model, inner, n=steps):
    res[key + '/losses'] = np.array([up.update()['loss'] for _ in range(n)])
    for name, v in flat_tree(models.to_flax_variables(model)[
            'params']).items():
        res[key + '/p/' + name] = v.copy()
    res[key + '/state'] = np.array(sorted(
        v.numel() for s in inner.state.values() for v in s.values()
        if torch.is_tensor(v) and v.dim()))


for name in ('sgd', 'momentum', 'adam'):
    for on in (0, 1):
        record('%s/%d' % (name, on), *make(name, on))
for on in (0, 1):
    record('groups/%d' % on, *make('groups', on))
    record('clip/%d' % on, *make('momentum', on, clip=0.05))
    record('accum/%d' % on, *make('adam', on, accum_steps=2))
    record('plan/%d' % on, *make('adam', on, comm=pcomm))
record('bf16', *make('adam', 1, zero_reduce_dtype=torch.bfloat16))
# snapshot at step 2 (every process gathers, rank 0 writes), resume
for name, key in (('adam', 'resumed'), ('groups', 'resumed_groups')):
    up, model, inner = make(name, 1)
    for _ in range(2):
        up.update()
    assert up.collective_state
    state = serializers.updater_state(up)
    res[key + '/saved_shapes'] = np.array(
        [v.shape for k, v in state['opt_state']['actual_state']['0'].items()
         if hasattr(v, 'dim') and v.dim()])
    if rank == 0:
        serializers.save_npz(tmp + '/%s.npz' % name, state)
    dist.barrier()
    fresh, fmodel, finner = make(name, 1)
    serializers.resume_updater(tmp + '/%s.npz' % name, fresh)
    assert fresh.iteration == 2
    record(key, fresh, fmodel, finner, n=2)
'''


def _setup_arrays():
    rng = np.random.RandomState(5)
    x = rng.randn(N_EX, N_IN).astype(np.float32)
    y = rng.randint(0, N_OUT, N_EX).astype(np.int32)
    jm = JaxMLP(n_units=N_UNITS, n_out=N_OUT)
    params = jax.device_get(jm.init(jax.random.PRNGKey(2),
                                    jnp.zeros((1, N_IN)))['params'])
    return jm, params, x, y


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('zero')
    _, params, x, y = _setup_arrays()
    save_tree(tmp / 'in.npz', {'params': params}, x=x, y=y)
    return spawn(tmp, _BODY, 4, [tmp / 'in.npz', tmp, STEPS])


def _params(res, key):
    return {k[len(key + '/p/'):]: v for k, v in res.items()
            if k.startswith(key + '/p/')}


def _sizes():
    # the MLP's three Dense layers: kernels and biases
    return sorted([N_IN * N_UNITS, N_UNITS, N_UNITS * N_UNITS, N_UNITS,
                   N_UNITS * N_OUT, N_OUT])


def _same(res, a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(res[a + '/losses'], res[b + '/losses'],
                               rtol=rtol)
    pa, pb = _params(res, a), _params(res, b)
    assert sorted(pa) == sorted(pb)
    for name in pa:
        np.testing.assert_allclose(pa[name], pb[name], rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize('name', OPTS)
def test_zero_matches_replicated_with_a_quarter_of_the_state(ranks, name):
    for res in ranks:
        _same(res, name + '/1', name + '/0')
        # the first call broadcasts and does not step
        assert res[name + '/1/losses'][0] == res[name + '/1/losses'][1]
        assert res[name + '/1/losses'][3] < res[name + '/1/losses'][1]
        per_param = {'sgd': 0, 'momentum': 1, 'adam': 2}[name]
        shard = sorted(-(-s // 4) for s in _sizes()) * per_param
        assert list(res[name + '/1/state']) == sorted(shard)
        full = sorted(_sizes() * per_param)
        assert list(res[name + '/0/state']) == full
    # every process holds the same parameters
    for res in ranks[1:]:
        for k, v in _params(res, name + '/1').items():
            np.testing.assert_array_equal(v, _params(ranks[0],
                                                     name + '/1')[k])


def test_zero_adam_matches_the_jax_zero_updater(ranks):
    jm, params, x, y = _setup_arrays()
    comm = chainermn_tpu.create_communicator('xla',
                                             devices=jax.devices()[:4])
    up = jtraining.StandardUpdater(
        iter([]), optax.adam(1e-2),
        JaxClassifier(lambda p, v: jm.apply({'params': p}, v)), params,
        comm, has_aux=True, zero=True, donate=False)
    data = [(x[i], y[i]) for i in range(N_EX)]
    losses = [float(up.update_core(up.shard_batch(data))['loss'])
              for _ in range(STEPS)]
    np.testing.assert_allclose(ranks[0]['adam/1/losses'], losses, rtol=1e-5)
    got = _params(ranks[0], 'adam/1')
    want = flat_tree(jax.device_get(up.params))
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize('case', ['clip', 'accum', 'plan'])
def test_zero_composes(ranks, case):
    for res in ranks:
        _same(res, case + '/1', case + '/0')
    if case == 'plan':       # ZeRO over the 2 data replicas of the plan
        shard = sorted(-(-s // 2) for s in _sizes()) * 2
        assert list(ranks[0]['plan/1/state']) == sorted(shard)
    if case == 'clip':       # the clip is active: it changes the run
        assert not np.allclose(ranks[0]['clip/1/losses'][2:],
                               ranks[0]['momentum/1/losses'][2:])


def test_zero_reduce_dtype_stays_near_f32(ranks):
    for res in ranks:
        np.testing.assert_allclose(res['bf16/losses'], res['adam/1/losses'],
                                   rtol=5e-2)
        pa, pb = _params(res, 'bf16'), _params(res, 'adam/1')
        for name in pa:
            np.testing.assert_allclose(pa[name], pb[name], rtol=5e-2,
                                       atol=5e-2, err_msg=name)


def test_zero_snapshot_resumes_at_the_same_n(ranks):
    for res in ranks:
        # (N, k) stacks in the snapshot, as the JAX package saves them
        assert all(s[0] == 4 for s in res['resumed/saved_shapes'])
        np.testing.assert_allclose(res['resumed/losses'],
                                   res['adam/1/losses'][2:], rtol=1e-6)
        pa, pb = _params(res, 'resumed'), _params(res, 'adam/1')
        for name in pa:
            np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


def test_zero_snapshot_resume_follows_the_param_groups(ranks):
    # AdamW over two groups that do not follow the model's order: each
    # parameter gets its own moments back, also where two shards have
    # the same shape
    for res in ranks:
        _same(res, 'groups/1', 'groups/0')
        np.testing.assert_allclose(res['resumed_groups/losses'],
                                   res['groups/1/losses'][2:], rtol=1e-6)
        pa, pb = _params(res, 'resumed_groups'), _params(res, 'groups/1')
        for name in pa:
            np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)


# ------------------------------------------------------- refusals
class _NormalizedSGD(torch.optim.Optimizer):
    """Steps by the gradient over its global norm: not elementwise."""

    def __init__(self, params, lr=0.1):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            ps = [p for p in group['params'] if p.grad is not None]
            norm = torch.sqrt(sum((p.grad ** 2).sum() for p in ps))
            for p in ps:
                p.sub_(group['lr'] * p.grad / norm)


class _RowSGD(torch.optim.Optimizer):
    """Scales a 2-D gradient by its row means: reads the leaf's shape."""

    def __init__(self, params, lr=0.1):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group['params']:
                g = p.grad
                if g.dim() == 2:
                    g = g * g.mean(1, keepdim=True)
                p.sub_(group['lr'] * g)


def _one(opt_fn, **kw):
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=4, n_out=2, n_in=3, device='cpu')
    return training.StandardUpdater(iter([]), opt_fn(model.parameters()),
                                    models.Classifier(model), model, comm,
                                    **kw)


def test_zero_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match='moved updates at'):
        _one(_NormalizedSGD, zero=True)
    with pytest.raises(ValueError, match='reads leaf shape'):
        _one(_RowSGD, zero=True)
    with pytest.raises(ValueError, match='not the multi-node wrapper'):
        comm = cmt.create_communicator('xla', device='cpu')
        _one(lambda ps: cmt.create_multi_node_optimizer(
            torch.optim.SGD(ps, lr=0.1), comm), zero=True)
    with pytest.raises(ValueError, match='requires zero=True'):
        _one(lambda ps: torch.optim.SGD(ps, lr=0.1),
             zero_reduce_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match='model-sharded'):
        _one(lambda ps: torch.optim.SGD(ps, lr=0.1), zero=True,
             param_specs={'Dense_0': {'kernel': ('model', None),
                                      'bias': ()}})
    with pytest.raises(ValueError, match='moved updates at'):
        zero.chain(zero.clip_by_global_norm(1.0),
                   _NormalizedSGD([torch.nn.Parameter(torch.ones(2))]))
    # a false positive can be waved through, and the elementwise ones pass
    up = _one(_RowSGD, zero=True, zero_check=False)
    assert up._zero is not None
    for fn in (lambda ps: torch.optim.SGD(ps, lr=0.1, momentum=0.9),
               lambda ps: torch.optim.Adam(ps, lr=1e-3),
               lambda ps: torch.optim.AdamW(ps, lr=1e-3),
               lambda ps: cmt.ops.FusedMomentumSGD(ps, 0.1, 0.9),
               lambda ps: zero.chain(zero.clip_by_global_norm(1.0),
                                     torch.optim.Adam(ps, lr=1e-3))):
        _one(fn, zero=True)


def test_clip_by_global_norm_is_optax_clip():
    rng = np.random.RandomState(0)
    grads = [rng.randn(3, 4).astype(np.float32),
             rng.randn(5).astype(np.float32)]
    for max_norm in (0.5, 100.0):
        ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in grads]
        for p, g in zip(ps, grads):
            p.grad = torch.from_numpy(g.copy())
        zero.clip_by_global_norm(max_norm)(ps)
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], optax.EmptyState())
        for p, w in zip(ps, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w),
                                       rtol=1e-6)
