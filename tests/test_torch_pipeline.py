"""The port's pipeline primitives against the JAX package's.

- the bubble arithmetic (``schedule_ticks``, ``bubble_fraction``,
  ``bubble_fractions_per_stage``) on a grid of ``(n_micro, n_stages,
  schedule)``, ``microbatch`` and ``stack_stage_params``;
- one spawn of four gloo processes, one stage each (the counterparts of
  ``tests/test_parallel.py``'s pipeline tests): the GPipe forward of
  ``Pipeline`` against the JAX ``Pipeline`` under ``shard_map`` on four
  host devices and the sequential oracle, its reversed-schedule
  backward against ``jax.grad`` through the JAX pipeline, and
  ``pipeline_1f1b_grads`` (plain, and with ``extra`` ends and the input
  cotangents) against the JAX function; f32 at rtol 1e-5, gradients at
  the JAX tests' 1e-4 / 1e-5;
- ``telemetry.report.pipeline_summary`` on the same events gives the
  JAX rows, and a pipeline step emits ``host_batch_prep``, ``h2d`` and
  ``jitted_step`` (the counterparts of ``tests/test_telemetry.py:364,
  805``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.parallel import pipeline as jpipe
from chainermn_tpu.telemetry import report as jreport
from chainermn_tpu_torch.parallel import pipeline as pl
from chainermn_tpu_torch.telemetry import report
from torch_spawn import save_tree, spawn

torch.set_num_threads(2)

S = 4


@pytest.mark.parametrize('schedule', ['gpipe', '1f1b'])
def test_bubble_arithmetic_equals_jax(schedule):
    for m in range(1, 13):
        for s in range(1, 9):
            assert pl.schedule_ticks(m, s, schedule) == \
                jpipe.schedule_ticks(m, s, schedule)
            assert pl.bubble_fraction(m, s, schedule) == \
                jpipe.bubble_fraction(m, s, schedule)
            assert pl.bubble_fractions_per_stage(m, s, schedule) == \
                jpipe.bubble_fractions_per_stage(m, s, schedule)
    # strictly decreasing in the micro-batch count at fixed stages
    b = [pl.bubble_fraction(m, 4, schedule) for m in range(1, 10)]
    assert all(x > y for x, y in zip(b, b[1:]))
    for bad in ((0, 2), (2, 0)):
        with pytest.raises(ValueError) as got:
            pl.bubble_fraction(*bad, schedule)
        with pytest.raises(ValueError) as want:
            jpipe.bubble_fraction(*bad, schedule)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match='gpipe'):
        pl.schedule_ticks(4, 2, 'zb')


def test_microbatch_and_stack_equal_jax():
    x = np.arange(48, dtype=np.float32).reshape(12, 4)
    np.testing.assert_array_equal(
        pl.microbatch(torch.from_numpy(x), 3).numpy(),
        np.asarray(jpipe.microbatch(jnp.asarray(x), 3)))
    with pytest.raises(ValueError, match='not divisible'):
        pl.microbatch(torch.from_numpy(x), 5)
    trees = [{'w': np.full((2, 2), i, np.float32),
              'n': {'b': np.full((3,), -i, np.float32)}} for i in range(3)]
    got = pl.stack_stage_params(trees)
    want = jax.device_get(jpipe.stack_stage_params(trees))
    np.testing.assert_array_equal(got['w'], want['w'])
    np.testing.assert_array_equal(got['n']['b'], want['n']['b'])
    t = pl.stack_stage_params([{'w': torch.ones(2)}, {'w': torch.zeros(2)}])
    assert t['w'].shape == (2, 2) and isinstance(t['w'], torch.Tensor)


# ---------------------------------------------------------------------
# the schedules on four processes

_BODY = r'''
import torch.nn.functional as F
from chainermn_tpu_torch.parallel import ProcessMesh
from chainermn_tpu_torch.parallel import pipeline as pl

f = np.load(argv[0])
mesh = ProcessMesh((4,), ('stage',))


def tanh_stage(p, x):
    return torch.tanh(x @ p['w'] + p.get('b', 0.0))


with mesh.bind():
    me = mesh.axis_index('stage')
    # forward and backward (test_parallel.py:88,121)
    for name in ('fwd', 'bwd'):
        p = {'w': torch.from_numpy(f[name + '_w'][me]).requires_grad_()}
        xm = torch.from_numpy(f[name + '_x'])
        pipe = pl.Pipeline(tanh_stage, 4)
        out = pipe(p, xm)
        res[name + '/is_none'] = np.array(out is None)
        if out is not None:
            res[name + '/out'] = out.detach().numpy()
        pipe.backward(None if out is None else 2 * out.detach())
        res[name + '/grad'] = p['w'].grad.numpy()
    # 1F1B (test_parallel.py:164)
    p = {'w': torch.from_numpy(f['f1_w'][me]).requires_grad_(),
         'b': torch.from_numpy(f['f1_b'][me]).requires_grad_()}
    xm, ym = torch.from_numpy(f['f1_x']), torch.from_numpy(f['f1_y'])

    def per_micro_loss(out, y):
        return F.cross_entropy(out, y.long()), {'n': torch.tensor(1.0)}

    loss, metrics, grads = pl.pipeline_1f1b_grads(
        tanh_stage, per_micro_loss, p, xm, ym, 4)
    res['f1/loss'] = loss.detach().numpy()
    res['f1/metrics_none'] = np.array(metrics is None)
    res['f1/gw'], res['f1/gb'] = grads['w'].numpy(), grads['b'].numpy()
    # 1F1B with extra ends and the input cotangents
    p = {'w': torch.from_numpy(f['f1_w'][me]).requires_grad_(),
         'b': torch.from_numpy(f['f1_b'][me]).requires_grad_()}
    e = {'Wh': torch.from_numpy(f['wh']).requires_grad_()}

    def head_loss(ee, out, y):
        return F.cross_entropy(out @ ee['Wh'], y.long()), {}

    loss, _, grads, eg, dx = pl.pipeline_1f1b_grads(
        tanh_stage, head_loss, p, xm, ym, 4, extra=e)
    res['ex/loss'] = loss.detach().numpy()
    res['ex/gw'], res['ex/gWh'] = grads['w'].numpy(), eg['Wh'].numpy()
    res['ex/dx_none'] = np.array(dx[0] is None)
    if dx[0] is not None:
        res['ex/dx'] = torch.stack(dx).numpy()
'''


def _mesh(n):
    return Mesh(np.asarray(jax.devices()[:n]), ('stage',))


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.RandomState(2)
    out = {'fwd_w': (rng.randn(S, 8, 8) * 0.5).astype(np.float32),
           'fwd_x': rng.randn(4, 2, 8).astype(np.float32)}
    rng = np.random.RandomState(3)
    out.update(bwd_w=(rng.randn(S, 4, 4) * 0.5).astype(np.float32),
               bwd_x=rng.randn(2, 2, 4).astype(np.float32))
    rng = np.random.RandomState(0)
    out.update(f1_w=(rng.randn(S, 16, 16) * 0.5).astype(np.float32),
               f1_b=(rng.randn(S, 16) * 0.1).astype(np.float32),
               f1_x=rng.randn(8, 4, 16).astype(np.float32),
               f1_y=rng.randint(0, 16, (8, 4)).astype(np.int32),
               wh=(rng.randn(16, 16) * 0.4).astype(np.float32))
    return out


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('pipeline')
    save_tree(tmp / 'in.npz', {}, **_inputs())
    return spawn(tmp, _BODY, 4, [tmp / 'in.npz'], deadline=120)


def _tanh_stage(p, x):
    return jnp.tanh(x @ p['w'] + p.get('b', 0.0))


def _jax_pipeline(name):
    """The JAX ``Pipeline``'s last-stage outputs and ``jax.grad`` of
    ``sum(out ** 2)`` through it."""
    f = _inputs()
    pipe = jpipe.Pipeline(_tanh_stage, S, axis='stage')
    stacked = {'w': jnp.asarray(f[name + '_w'])}
    xm = jnp.asarray(f[name + '_x'])

    def dev(p, x):
        out = pipe(jax.tree_util.tree_map(lambda a: a[0], p), x)
        return out[None]

    out = jax.shard_map(dev, mesh=_mesh(S), in_specs=(P('stage'), P()),
                        out_specs=P('stage'), check_vma=False)

    def loss(p):
        def f_(p, x):
            o = pipe(jax.tree_util.tree_map(lambda a: a[0], p), x)
            me = jax.lax.axis_index('stage')
            return jax.lax.psum(jnp.sum(o ** 2) * (me == S - 1), 'stage')
        return jax.shard_map(f_, mesh=_mesh(S), in_specs=(P('stage'), P()),
                             out_specs=P(), check_vma=False)(p, xm)

    return (np.asarray(jax.jit(out)(stacked, xm))[-1],
            np.asarray(jax.jit(jax.grad(loss))(stacked)['w']))


@pytest.mark.parametrize('name', ['fwd', 'bwd'])
def test_gpipe_forward_and_backward_match_jax(ranks, name):
    out, grad = _jax_pipeline(name)
    f = _inputs()
    # the sequential oracle
    h = f[name + '_x'].reshape(-1, f[name + '_w'].shape[-1])
    for w in f[name + '_w']:
        h = np.tanh(h @ w)
    np.testing.assert_allclose(out.reshape(h.shape), h, rtol=1e-5,
                               atol=1e-6)
    for r, res in enumerate(ranks):
        assert bool(res[name + '/is_none']) == (r != S - 1)
        np.testing.assert_allclose(res[name + '/grad'], grad[r], rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(ranks[-1][name + '/out'], out, rtol=1e-5,
                               atol=1e-6)


def _jax_1f1b(extra):
    f = _inputs()
    stacked = {'w': jnp.asarray(f['f1_w']), 'b': jnp.asarray(f['f1_b'])}
    xm, ym = jnp.asarray(f['f1_x']), jnp.asarray(f['f1_y'])
    e = {'Wh': jnp.asarray(f['wh'])}

    def ce(logits, y):
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()

    def dev(p, x, y):
        p = jax.tree_util.tree_map(lambda a: a[0], p)
        if extra:
            out = jpipe.pipeline_1f1b_grads(
                _tanh_stage, lambda ee, o, t: (ce(o @ ee['Wh'], t), {}),
                p, x, y, S, axis='stage', extra=e)
            loss, _, g, eg, dx = out
            return (loss[None], jax.tree_util.tree_map(
                lambda a: a[None], g), eg['Wh'][None], dx[None])
        loss, _, g = jpipe.pipeline_1f1b_grads(
            _tanh_stage, lambda o, t: (ce(o, t), {}), p, x, y, S,
            axis='stage')
        return loss[None], jax.tree_util.tree_map(lambda a: a[None], g)

    n_out = 4 if extra else 2
    return jax.device_get(jax.jit(jax.shard_map(
        dev, mesh=_mesh(S), in_specs=(P('stage'), P(), P()),
        out_specs=(P('stage'),) * n_out, check_vma=False))(stacked, xm, ym))


def test_1f1b_grads_match_jax(ranks):
    loss, g = _jax_1f1b(False)
    f = _inputs()
    # the sequential oracle's loss
    x, y = f['f1_x'].reshape(-1, 16), f['f1_y'].reshape(-1)
    h = x
    for w, b in zip(f['f1_w'], f['f1_b']):
        h = np.tanh(h @ w + b)
    ref = float(optax.softmax_cross_entropy_with_integer_labels(
        h, y).mean())
    np.testing.assert_allclose(loss[-1], ref, rtol=1e-5)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res['f1/loss'], loss[r], rtol=1e-5,
                                   atol=1e-7)
        assert bool(res['f1/metrics_none']) == (r != S - 1)
        np.testing.assert_allclose(res['f1/gw'], g['w'][r], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(res['f1/gb'], g['b'][r], rtol=1e-4,
                                   atol=1e-5)


def test_1f1b_extra_ends_and_input_cotangents_match_jax(ranks):
    loss, g, gwh, dx = _jax_1f1b(True)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res['ex/loss'], loss[r], rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(res['ex/gw'], g['w'][r], rtol=1e-4,
                                   atol=1e-5)
        # head gradients on the last stage, zeros elsewhere
        np.testing.assert_allclose(res['ex/gWh'], gwh[r], rtol=1e-4,
                                   atol=1e-5)
        # the input cotangents on stage 0 only
        assert bool(res['ex/dx_none']) == (r != 0)
    np.testing.assert_allclose(ranks[0]['ex/dx'], dx[0], rtol=1e-4,
                               atol=1e-5)


# ---------------------------------------------------------------------
# telemetry

def test_pipeline_summary_equals_jax():
    events = [
        {'kind': 'pipeline', 'name': 'pipeline:schedule',
         'schedule': 'gpipe', 'n_micro': 4, 'n_stages': 2,
         'total_ticks': 5, 'axes': ['pipe']},
        {'kind': 'pipeline', 'name': 'pipeline:schedule',
         'schedule': '1f1b', 'n_micro': 8, 'n_stages': 4,
         'total_ticks': 15, 'axes': ['stage']},
        # a repeat, a malformed row and another kind are skipped
        {'kind': 'pipeline', 'name': 'pipeline:schedule',
         'schedule': 'gpipe', 'n_micro': 4, 'n_stages': 2},
        {'kind': 'pipeline', 'name': 'pipeline:schedule',
         'n_micro': 'x', 'n_stages': 2},
        {'kind': 'collective_trace', 'name': 'pipeline:ppermute'},
    ]
    assert report.pipeline_summary(events) == \
        jreport.pipeline_summary(events)
    assert report.pipeline_summary([]) is None
    assert report.pipeline_summary(events[4:]) is None


def test_pipeline_step_emits_the_updater_spans_and_schedule_event():
    from chainermn_tpu_torch import telemetry, training
    mesh = training.pipeline_mesh(1, device='cpu')
    rng = np.random.RandomState(0)
    stacked = {'w': (rng.randn(1, 8, 8) * 0.5).astype(np.float32)}
    data = [(rng.randn(8).astype(np.float32), np.int32(i % 8))
            for i in range(16)]

    def loss_on_last(outs, y):
        return torch.nn.functional.cross_entropy(
            outs.reshape(-1, 8), y.reshape(-1).long()), {}

    upd = training.PipelineUpdater(
        training.SerialIterator(data, 8), lambda ps: torch.optim.SGD(
            ps, lr=0.1), lambda p, x: torch.tanh(x @ p['w']), loss_on_last,
        stacked, mesh, n_micro=2, device='cpu')
    rec = telemetry.enable()
    try:
        for _ in range(2):
            upd.update()
        events = list(rec.events)
    finally:
        telemetry.disable()
    names = [e.get('name') for e in events]
    for name in ('host_batch_prep', 'h2d', 'jitted_step', 'metrics_sync'):
        assert names.count(name) == 2, (name, names)
    assert upd.trace_count == 1
    rows = report.pipeline_summary(events)
    assert rows == jreport.pipeline_summary(events)
    assert rows[0]['schedule'] == 'gpipe' and rows[0]['n_stages'] == 1
    assert rows[0]['axis'] == 'stage'
    assert [e for e in events if e.get('name') == 'pipeline:ppermute']
