"""The port's ``PipelineUpdater`` against the JAX package's.

The counterparts of ``tests/test_pipeline_training.py``.  One spawn of
four gloo processes on a ``(data, stage) = (2, 2)`` mesh runs every
case; the JAX updater runs here on ``pipeline_mesh(2,
devices=jax.devices()[:4])``, the same layout:

- one step under ``gpipe``, ``gpipe`` with ``remat`` and ``1f1b``
  (losses and parameters at the JAX tests' rtol 1e-5 / atol 1e-6), three
  Adam steps of each, the ``prologue`` / ``extra_params`` ends under both
  schedules, ``zero.chain(zero.clip_by_global_norm(c), ...)`` under
  both schedules against JAX's gpipe with ``optax.clip_by_global_norm``
  (with and without the ends; the unclipped run must differ), the gpipe
  garbage-loss case (non-last stages never evaluate the loss), and
  ``models.pipeline_parts`` on a ``TransformerLM`` (``evaluate`` against
  ``lm_loss``, one SGD step, the global loss under uneven padding);
- snapshot and resume (``serializers``), continuing bit-identically,
  with the JAX keys; ``Trainer`` with and without ``async_metrics``;
- the 1F1B guard's four cases (``:891`` a loss that sums over data,
  ``:916`` a collective in a custom backward, ``:947`` a clean custom
  backward, ``:1018`` collective metrics), decided as JAX decides them.

Constructor checks run in this process on a shape-only mesh.

No counterpart: the JAX tests of optax state placement
(``:164,404,444,483``: an optimizer's state lives beside its parameter
here, and ``opt_state_specs`` raises), of donation (``:505``; ``donate=``
is a ``TypeError`` here) and of the
guard's primitive set (``:996``: the port's guard records its own entry
points and ``torch.distributed`` calls).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.models import (TransformerLM as JaxLM,
                                  lm_loss as jlm_loss,
                                  pipeline_parts as jpipeline_parts)
from chainermn_tpu.parallel.pipeline import stack_stage_params
from chainermn_tpu.training.pipeline_updater import (
    PipelineUpdater as JaxPipelineUpdater, pipeline_mesh as jpipeline_mesh)
from chainermn_tpu_torch import training
from chainermn_tpu_torch.parallel import zero
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

S, DIM, C = 2, 16, 0.05
LM = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64,
          max_len=64)
SCHEDULES = [('gpipe', False), ('gpipe', True), ('1f1b', False)]


def make_params(seed=0):
    rng = np.random.RandomState(seed)
    return [{'w': (rng.randn(DIM, DIM) * 0.5).astype(np.float32),
             'b': (rng.randn(DIM) * 0.1).astype(np.float32)}
            for _ in range(S)]


def _data():
    rng = np.random.RandomState(3)
    return (rng.randn(32, DIM).astype(np.float32),
            rng.randint(0, DIM, 32).astype(np.int32))


def _ends():
    rng = np.random.RandomState(7)
    return ({'We': (rng.randn(8, DIM) * 0.4).astype(np.float32),
             'Wh': (rng.randn(DIM, DIM) * 0.4).astype(np.float32)},
            rng.randn(32, 8).astype(np.float32),
            rng.randint(0, DIM, 32).astype(np.int32))


def _lm_batch():
    rng = np.random.RandomState(5)
    toks = rng.randint(0, LM['vocab_size'], (8, 16)).astype(np.int32)
    tgts = np.roll(toks, -1, axis=1)
    pad = tgts.copy()
    pad[:2, 4:] = 0            # uneven padding: rows of data replica 0
    return toks, tgts, pad


@functools.lru_cache(maxsize=None)
def _lm_params():
    model = JaxLM(dtype=jnp.float32, **LM)
    return jax.device_get(model.init(jax.random.PRNGKey(1), jnp.zeros(
        (1, 16), jnp.int32))['params'])


_BODY = r'''
import torch.nn.functional as F
from chainermn_tpu_torch import models, serializers, training
from chainermn_tpu_torch.datasets.mnist import TupleDataset
from chainermn_tpu_torch.parallel import resolve_axis, tensor, zero
from chainermn_tpu_torch.training import PipelineUpdater, pipeline_mesh

f = np.load(argv[0])
tmp = argv[1]
stacked = load_tree(argv[0], 'stacked/')
garbage = load_tree(argv[0], 'garbage/')
ends = load_tree(argv[0], 'ends/')
lm_params = load_tree(argv[0], 'lm/')
mesh = pipeline_mesh(2, device='cpu')
x, y, xe, ye = f['x'], f['y'], f['xe'], f['ye']
batch = [(x[i], y[i]) for i in range(32)]
batch_e = [(xe[i], ye[i]) for i in range(32)]
DIM = 16


def stage_fn(p, x):
    return torch.tanh(x @ p['w'] + p['b'])


def loss_on_last(outs, ym):
    logits = outs.reshape(-1, DIM)
    yy = ym.reshape(-1).long()
    return F.cross_entropy(logits, yy), {
        'accuracy': (logits.argmax(-1) == yy).float().mean()}


def prologue(e, xx):
    return torch.tanh(xx @ e['We'])


def loss_with_head(e, outs, ym):
    logits = outs.reshape(-1, DIM) @ e['Wh']
    yy = ym.reshape(-1).long()
    return F.cross_entropy(logits, yy), {
        'accuracy': (logits.argmax(-1) == yy).float().mean()}


def sgd(ps):
    return torch.optim.SGD(ps, lr=0.1, momentum=0.9)


def adam(ps):
    return torch.optim.Adam(ps, lr=1e-2)


def clip_sgd(ps):
    return zero.chain(zero.clip_by_global_norm(0.05), sgd(ps))


def make(sched, remat=False, opt=sgd, with_ends=False, **kw):
    if with_ends:
        kw.update(prologue=prologue, extra_params=ends)
    return PipelineUpdater(
        iter([]), opt, stage_fn, loss_with_head if with_ends else
        loss_on_last, stacked, mesh, n_micro=4, remat=remat,
        schedule=sched, device='cpu', **kw)


def record(key, upd, losses):
    res[key + '/loss'] = np.array(losses)
    for k, v in flat_tree(upd.params).items():
        res[key + '/p/' + k] = v
    if upd.extra is not None:
        for k, v in flat_tree(upd.extra).items():
            res[key + '/e/' + k] = v


def steps(upd, b, n):
    return [float(upd.update_core(upd.shard_batch(b))['loss'])
            for _ in range(n)]


for sched, remat in (('gpipe', False), ('gpipe', True), ('1f1b', False)):
    tag = sched + ('_remat' if remat else '')
    upd = make(sched, remat)
    record('one/' + tag, upd, steps(upd, batch, 1))
    upd = make(sched, remat, opt=adam)
    record('adam/' + tag, upd, steps(upd, batch, 3))
    if not remat:
        upd = make(sched, with_ends=True)
        record('ends/' + tag, upd, steps(upd, batch_e, 1))
        for ends_on in (False, True):
            upd = make(sched, opt=clip_sgd, with_ends=ends_on)
            record('clip%d/%s' % (ends_on, tag), upd,
                   steps(upd, batch_e if ends_on else batch, 3))
upd = make('1f1b')
record('plain/1f1b', upd, steps(upd, batch, 3))

# the gpipe garbage-loss case: stage 0's output overflows exp
lin = PipelineUpdater(
    iter([]), lambda ps: torch.optim.SGD(ps, lr=0.1),
    lambda p, xx: xx @ p['w'], lambda o, ym: (torch.exp(o).mean(), {}),
    garbage, mesh, n_micro=4, device='cpu')
xa = np.abs(x)
record('garbage', lin, steps(lin, [(xa[i], y[i]) for i in range(32)], 1))

# snapshot and resume, bit for bit
for with_ends in (False, True):
    b = batch_e if with_ends else batch
    upd = make('gpipe', opt=adam, with_ends=with_ends)
    steps(upd, b, 2)
    path = serializers.save_npz('%s/snap%d_%d' % (tmp, with_ends, rank),
                                serializers.updater_state(upd))
    steps(upd, b, 1)
    want = flat_tree(dict(p=upd.params, e=upd.extra or {}))
    fresh = make('gpipe', opt=adam, with_ends=with_ends)
    serializers.resume_updater(path, fresh)
    res['resume%d/iteration' % with_ends] = np.array(fresh.iteration)
    steps(fresh, b, 1)
    got = flat_tree(dict(p=fresh.params, e=fresh.extra or {}))
    res['resume%d/equal' % with_ends] = np.array(all(
        np.array_equal(got[k], want[k]) for k in want))
    with np.load(path) as snap:
        for k in snap.files:
            if k.startswith(('params/', 'extra/')):
                res['resume%d/shape/%s' % (with_ends, k)] = np.array(
                    snap[k].shape)

# Trainer, with and without async metrics
rng = np.random.RandomState(0)
xs = rng.randn(128, DIM).astype(np.float32)
ys = rng.randint(0, DIM, 128).astype(np.int32)
for async_metrics in (False, True):
    upd = PipelineUpdater(
        training.SerialIterator(TupleDataset(xs, ys), 32), adam, stage_fn,
        loss_on_last, stacked, mesh, n_micro=4, device='cpu')
    if async_metrics:
        m = upd.update(sync=False)
        res['async/tensors'] = np.array(all(
            isinstance(v, torch.Tensor) for v in m.values()))
    tr = training.Trainer(upd, (2, 'epoch'), out=None,
                          async_metrics=async_metrics, sync_interval=2)
    log = training.extensions.LogReport()
    tr.extend(log)
    tr.run()
    res['trainer%d/epoch' % async_metrics] = np.array(upd.epoch)
    res['trainer%d/loss' % async_metrics] = np.array(
        [e['loss'] for e in log.log])

# the transformer through pipeline_parts (JAX's test_transformer_
# pipeline_parts on (data, stage) = (2, 2), two layers a stage)
model = models.TransformerLM(dtype=torch.float32, device='cpu',
                             **eval(argv[2]))
toks, tgts, pad = f['toks'], f['tgts'], f['pad']
for tag, targets, pad_id in (('lm', tgts, -1), ('lm_pad', pad, 0)):
    sf, pro, ll, st, ex = models.pipeline_parts(model, lm_params, 2,
                                                pad_id=pad_id)
    upd = PipelineUpdater(iter([]), lambda ps: torch.optim.SGD(ps, lr=0.1),
                          sf, ll, st, mesh, n_micro=2, prologue=pro,
                          extra_params=ex, device='cpu')
    arrays = upd.shard_batch([(toks[i], targets[i]) for i in range(8)])
    res[tag + '/eval'] = np.array(upd.evaluate(arrays)['loss'])
    if tag == 'lm':
        record(tag, upd, [float(upd.update_core(arrays)['loss'])])

# the 1F1B guard's four cases


class Sneaky(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=resolve_axis('data').group)
        return g / 2


class Clean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.tanh(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * (1 - torch.tanh(x) ** 2)


def collective_loss(e, outs, ym):
    loss = F.cross_entropy(outs.reshape(-1, DIM) @ e['Wh'],
                           ym.reshape(-1).long())
    return tensor.psum(loss, 'data') / 2, {}


def psum_metrics(outs, ym):
    loss, m = loss_on_last(outs, ym)
    return loss, {'acc_global': tensor.psum(m['accuracy'], 'data') / 2}


cases = {
    'loss': dict(loss=collective_loss, extra_params={'Wh': ends['Wh']}),
    'custom_bwd': dict(stage=lambda p, xx: Sneaky.apply(stage_fn(p, xx))),
    'clean_bwd': dict(stage=lambda p, xx: Clean.apply(
        xx @ p['w'] + p['b'])),
    'metrics': dict(loss=psum_metrics),
}
for name, case in cases.items():
    upd = PipelineUpdater(
        iter([]), lambda ps: torch.optim.SGD(ps, lr=0.1),
        case.get('stage', stage_fn), case.get('loss', loss_on_last),
        stacked, mesh, n_micro=4, schedule='1f1b', device='cpu',
        extra_params=case.get('extra_params'))
    try:
        m = upd.update_core(upd.shard_batch(batch))
        res['guard/' + name] = np.array('ok %r' % bool(np.isfinite(
            float(m['loss']))))
    except ValueError as e:
        res['guard/' + name] = np.array(str(e))
'''


def _jax_stage(p, x):
    return jnp.tanh(x @ p['w'] + p['b'])


def _jax_loss(outs, ym):
    logits = outs.reshape(-1, DIM)
    y = ym.reshape(-1)
    loss = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                           y).mean()
    return loss, {'accuracy': jnp.mean((jnp.argmax(logits, -1) == y)
                                       .astype(jnp.float32))}


def _jax_prologue(e, xx):
    return jnp.tanh(xx @ e['We'])


def _jax_loss_with_head(e, outs, ym):
    return _jax_loss(outs.reshape(-1, DIM) @ e['Wh'], ym)


def _jmesh():
    return jpipeline_mesh(S, devices=jax.devices()[:4])


@functools.lru_cache(maxsize=None)
def _jax_run(tag, opt_name, n_steps, with_ends=False, clip=False):
    sched, remat = {'gpipe': ('gpipe', False), 'gpipe_remat':
                    ('gpipe', True), '1f1b': ('1f1b', False)}[tag]
    opt = {'sgd': optax.sgd(0.1, momentum=0.9),
           'adam': optax.adam(1e-2)}[opt_name]
    if clip:
        opt = optax.chain(optax.clip_by_global_norm(C), opt)
    kw = {}
    if with_ends:
        ends, xe, ye = _ends()
        kw = dict(prologue=_jax_prologue, extra_params=jax.tree_util.tree_map(
            jnp.asarray, ends))
        batch = [(xe[i], ye[i]) for i in range(32)]
    else:
        x, y = _data()
        batch = [(x[i], y[i]) for i in range(32)]
    upd = JaxPipelineUpdater(
        iter([]), opt, _jax_stage, _jax_loss_with_head if with_ends
        else _jax_loss, stack_stage_params(make_params()), _jmesh(),
        n_micro=4, remat=remat, donate=False, schedule=sched, **kw)
    losses = [float(upd.update_core(upd.shard_batch(batch))['loss'])
              for _ in range(n_steps)]
    out = {'loss': np.array(losses)}
    out.update({'p/' + k: v for k, v in flat_tree(
        jax.device_get(upd.params)).items()})
    if with_ends:
        out.update({'e/' + k: v for k, v in flat_tree(
            jax.device_get(upd.extra)).items()})
    return out


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pipeline_training')
    x, y = _data()
    ends, xe, ye = _ends()
    toks, tgts, pad = _lm_batch()
    garbage = [{'w': 100.0 * np.eye(DIM, dtype=np.float32)},
               {'w': -0.01 * np.eye(DIM, dtype=np.float32)}]
    save_tree(tmp / 'in.npz', {
        'stacked': stack_stage_params(make_params()),
        'garbage': stack_stage_params(garbage), 'ends': ends,
        'lm': _lm_params()}, x=x, y=y, xe=xe, ye=ye, toks=toks, tgts=tgts,
        pad=pad)
    return spawn(tmp, _BODY, 4, [tmp / 'in.npz', tmp, repr(LM)],
                 deadline=400)


def _hold(res, key, want, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(res[key + '/loss'], want['loss'],
                               rtol=1e-5)
    for k, v in want.items():
        if k != 'loss':
            np.testing.assert_allclose(res[key + '/' + k], v, rtol=rtol,
                                       atol=atol, err_msg=key + k)


@pytest.mark.parametrize('sched,remat', SCHEDULES)
def test_one_step_matches_jax_and_the_sequential_step(ranks, sched, remat):
    tag = sched + ('_remat' if remat else '')
    want = _jax_run(tag, 'sgd', 1)
    # the JAX updater's own pin: the unpipelined loss
    x, y = _data()
    h = x
    for p in make_params():
        h = np.tanh(h @ p['w'] + p['b'])
    seq = float(optax.softmax_cross_entropy_with_integer_labels(h, y).mean())
    assert abs(want['loss'][0] - seq) < 1e-5
    for res in ranks:
        _hold(res, 'one/' + tag, want)


@pytest.mark.parametrize('sched,remat', SCHEDULES)
def test_three_adam_steps_match_jax(ranks, sched, remat):
    tag = sched + ('_remat' if remat else '')
    want = _jax_run(tag, 'adam', 3)
    for res in ranks:
        _hold(res, 'adam/' + tag, want)
        # remat and 1f1b change no numerics
        np.testing.assert_allclose(res['adam/' + tag + '/p/w'],
                                   res['adam/gpipe/p/w'], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize('sched', ['gpipe', '1f1b'])
def test_heterogeneous_ends_match_jax(ranks, sched):
    want = _jax_run(sched, 'sgd', 1, with_ends=True)
    for res in ranks:
        _hold(res, 'ends/' + sched, want)


@pytest.mark.parametrize('sched', ['gpipe', '1f1b'])
@pytest.mark.parametrize('with_ends', [False, True])
def test_mesh_aware_clip_matches_jax_gpipe_clip(ranks, sched, with_ends):
    want = _jax_run('gpipe', 'sgd', 3, with_ends=with_ends, clip=True)
    for res in ranks:
        _hold(res, 'clip%d/%s' % (with_ends, sched), want)
    # the clip engaged: the unclipped trajectory differs
    assert np.max(np.abs(ranks[0]['clip0/1f1b/p/w']
                         - ranks[0]['plain/1f1b/p/w'])) > 1e-4


def test_gpipe_grads_finite_when_garbage_loss_overflows(ranks):
    x, _ = _data()
    x = np.abs(x)
    eye = np.eye(DIM, dtype=np.float32)
    plist = [{'w': 100.0 * eye}, {'w': -0.01 * eye}]
    # the garbage really overflows: the loss on stage 0's output
    with np.errstate(over='ignore'):
        assert not np.all(np.isfinite(np.exp(x @ plist[0]['w'])))
    upd = JaxPipelineUpdater(
        iter([]), optax.sgd(0.1), lambda p, xx: xx @ p['w'],
        lambda o, ym: (jnp.mean(jnp.exp(o)), {}),
        stack_stage_params([jax.tree_util.tree_map(jnp.asarray, p)
                            for p in plist]), _jmesh(), n_micro=4,
        donate=False)
    y = np.zeros(32, np.int32)
    m = upd.update_core(upd.shard_batch([(x[i], y[i]) for i in range(32)]))
    want = jax.device_get(upd.params)['w']
    for res in ranks:
        assert np.isfinite(res['garbage/loss']).all()
        assert np.isfinite(res['garbage/p/w']).all()
        np.testing.assert_allclose(res['garbage/loss'], float(m['loss']),
                                   rtol=1e-5)
        np.testing.assert_allclose(res['garbage/p/w'], want, rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize('with_ends', [0, 1])
def test_snapshot_resume_continues_bit_identically(ranks, with_ends):
    want = _jax_run('gpipe', 'adam', 1, with_ends=bool(with_ends))
    for res in ranks:
        assert int(res['resume%d/iteration' % with_ends]) == 2
        assert bool(res['resume%d/equal' % with_ends])
        # the body gathered over the stages in the JAX stacked layout
        shapes = {k[len('resume%d/shape/' % with_ends):]: tuple(v)
                  for k, v in res.items()
                  if k.startswith('resume%d/shape/' % with_ends)}
        expect = {'params/' + k[2:]: v.shape for k, v in want.items()
                  if k.startswith('p/')}
        expect.update({'extra/' + k[2:]: v.shape for k, v in want.items()
                       if k.startswith('e/')})
        assert shapes == expect


@pytest.mark.parametrize('async_metrics', [0, 1])
def test_pipeline_updater_drives_trainer(ranks, async_metrics):
    for res in ranks:
        assert int(res['trainer%d/epoch' % async_metrics]) == 2
        loss = res['trainer%d/loss' % async_metrics]
        assert len(loss) == 2 and np.isfinite(loss).all()
        assert loss[-1] < loss[0] * 1.2
    if async_metrics:
        assert all(bool(r['async/tensors']) for r in ranks)


def test_transformer_pipeline_parts_matches_lm_loss_and_jax(ranks):
    params = _lm_params()
    model = JaxLM(dtype=jnp.float32, **LM)
    toks, tgts, pad = _lm_batch()
    apply_fn = lambda p, t: model.apply({'params': p}, t)  # noqa: E731
    ref, _ = jlm_loss(apply_fn)(params, toks, tgts)
    ref_pad, _ = jlm_loss(apply_fn, pad_id=0)(params, toks, pad)
    parts = jpipeline_parts(model, params, S)
    upd = JaxPipelineUpdater(
        iter([]), optax.sgd(0.1), parts[0], parts[2], parts[3], _jmesh(),
        n_micro=2, donate=False, prologue=parts[1], extra_params=parts[4])
    m = upd.update_core(upd.shard_batch([(toks[i], tgts[i])
                                         for i in range(8)]))
    got_p = flat_tree(jax.device_get(upd.params))
    got_e = flat_tree(jax.device_get(upd.extra))
    for res in ranks:
        np.testing.assert_allclose(res['lm/eval'], float(ref), rtol=1e-5)
        np.testing.assert_allclose(res['lm_pad/eval'], float(ref_pad),
                                   rtol=1e-5)
        np.testing.assert_allclose(res['lm/loss'], [float(m['loss'])],
                                   rtol=1e-5)
        for k, v in got_p.items():
            np.testing.assert_allclose(res['lm/p/' + k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        for k, v in got_e.items():
            np.testing.assert_allclose(res['lm/e/' + k], v, rtol=1e-4,
                                       atol=1e-5, err_msg=k)


def _jax_guard(case):
    """The JAX updater's verdict on one of its four guard cases."""
    x, y = _data()
    batch = [(x[i], y[i]) for i in range(32)]
    stage, loss, kw = _jax_stage, _jax_loss, {}
    if case == 'loss':
        def loss(e, outs, ym):
            logits = outs.reshape(-1, DIM) @ e['Wh']
            return jax.lax.pmean(
                optax.softmax_cross_entropy_with_integer_labels(
                    logits, ym.reshape(-1)).mean(), 'data'), {}
        kw = dict(extra_params={'Wh': jnp.zeros((DIM, DIM))})
    elif case in ('custom_bwd', 'clean_bwd'):
        @jax.custom_vjp
        def op(v):
            return v if case == 'custom_bwd' else jnp.tanh(v)

        def fwd(v):
            return op(v), v

        def bwd(v, g):
            if case == 'custom_bwd':
                return (jax.lax.pmean(g, 'data'),)
            return (g * (1.0 - jnp.tanh(v) ** 2),)
        op.defvjp(fwd, bwd)

        def stage(p, xx):
            h = xx @ p['w'] + p['b']
            return op(jnp.tanh(h) if case == 'custom_bwd' else h)
    else:
        def loss(outs, ym):
            value, m = _jax_loss(outs, ym)
            return value, {'acc_global': jax.lax.pmean(m['accuracy'],
                                                       'data')}
    upd = JaxPipelineUpdater(iter([]), optax.sgd(0.1), stage, loss,
                             stack_stage_params(make_params()), _jmesh(),
                             n_micro=4, donate=False, schedule='1f1b', **kw)
    try:
        upd.update_core(upd.shard_batch(batch))
        return None
    except ValueError as e:
        return str(e)


@pytest.mark.parametrize('case,word', [('loss', 'collective'),
                                       ('custom_bwd', 'backward'),
                                       ('clean_bwd', None),
                                       ('metrics', None)])
def test_1f1b_guard_decides_the_jax_cases(ranks, case, word):
    want = _jax_guard(case)
    assert (want is None) == (word is None)
    for res in ranks:
        got = str(res['guard/' + case])
        if word is None:
            assert got == 'ok True', got
        else:
            assert word in got and word in want, (got, want)
            assert got.startswith("loss_on_last under schedule='1f1b'"
                                  if case == 'loss' else
                                  "stage_fn under schedule='1f1b'")


# ---------------------------------------------------------------------
# constructor checks, on a shape-only mesh in this process

def _local_mesh():
    return training.pipeline_mesh(S, size=4, rank=0)


def _ctor(**kw):
    args = dict(iterator=iter([]), optimizer=lambda ps: torch.optim.SGD(
        ps, lr=0.1), stage_fn=None, loss_on_last=None,
        params_stacked=stack_stage_params(make_params()), mesh=_local_mesh(),
        n_micro=4, device='cpu')
    args.update(kw)
    return training.PipelineUpdater(**args)


def _plain_clip(params):
    torch.nn.utils.clip_grad_norm_(params, 1.0)


def test_constructor_rejections():
    with pytest.raises(ValueError, match='remat'):
        _ctor(remat=True, schedule='1f1b')
    for sched in ('gpipe', '1f1b'):
        with pytest.raises(ValueError, match='elementwise') as e:
            _ctor(schedule=sched, optimizer=lambda ps: zero.Chain(
                [_plain_clip], torch.optim.SGD(ps, lr=0.1)))
        assert 'ROADMAP.md item 8' in str(e.value)
        # the bypass, and the mesh-aware clip, are admitted
        _ctor(schedule=sched, schedule_check=False,
              optimizer=lambda ps: zero.Chain(
                  [_plain_clip], torch.optim.SGD(ps, lr=0.1)))
        _ctor(schedule=sched, optimizer=lambda ps: zero.chain(
            zero.clip_by_global_norm(1.0), torch.optim.SGD(ps, lr=0.1)))
    with pytest.raises(ValueError, match='extra_params'):
        _ctor(prologue=lambda e, x: x)
    from chainermn_tpu_torch.precision import Policy
    with pytest.raises(ValueError, match='loss-scaled'):
        _ctor(policy=Policy.f16())
    with pytest.raises(NotImplementedError, match='A5'):
        _ctor(opt_state_specs={})
    # donation has no torch meaning: refused, as StandardUpdater does
    with pytest.raises(TypeError, match='donate'):
        _ctor(donate=False)
    with pytest.raises(ValueError, match="'gpipe' or '1f1b'"):
        _ctor(schedule='zb')
    specs = {'w': ('stage',), 'b': ('stage',)}
    with pytest.raises(ValueError, match='stage axis'):
        _ctor(param_specs={'w': ('data',), 'b': ('stage',)})
    with pytest.raises(ValueError, match='LEAF-EXACT'):
        _ctor(param_specs={'w': specs['w'], 'b': specs['b'],
                           'c': ('stage',)})
    with pytest.raises(ValueError, match='gpipe'):
        _ctor(schedule='1f1b', param_specs={'w': ('stage', 'data'),
                                            'b': ('stage',)})
    upd = _ctor(param_specs=specs)
    # this process (stage 0 of data replica 0) holds stage 0's rows
    np.testing.assert_array_equal(upd.stage_params['w'].detach().numpy(),
                                  make_params()[0]['w'])
    with pytest.raises(ValueError, match='not divisible'):
        training.pipeline_mesh(3, size=4)
