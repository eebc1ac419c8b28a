"""The port's mixed-precision policy against the JAX package's.

Case for case with ``tests/test_precision.py``: the policy's casts and
registry, ``all_finite``, the loss scales, ``concat_examples(dtype=)``,
the reduce dtype through every strategy; then the updater under a policy
against the JAX ``StandardUpdater`` on a one-device mesh, from the same
flax weights (``models.load_flax_variables``) and numpy batches: the MLP
under ``Policy.bf16()`` at rtol 5e-2, a loss-scaled f32 run against the
unscaled trajectory at rtol 1e-5, ``Policy.f16()`` with its dynamic
scale, and a forced non-finite step (its ``loss_scale`` and
``grads_finite`` equal, parameters and optimizer state unchanged).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import precision as jprecision
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import MLP as JaxMLP, Classifier as JaxClassifier
from chainermn_tpu.models import StatefulClassifier as JaxStatefulClassifier
from chainermn_tpu.models.resnet50 import ResNet as JaxResNet
from chainermn_tpu_torch import models, precision, training
from chainermn_tpu_torch.training.convert import concat_examples

torch.set_num_threads(2)

ALL_NAMES = ('xla', 'hierarchical', 'two_dimensional', 'flat', 'naive',
             'single_node', 'non_cuda_aware', 'dummy', 'bucketed')


# ------------------------------------------------------------- Policy
def test_policy_cast_round_trip():
    pol = precision.Policy.bf16()
    tree = {'w': torch.ones(3, 2), 'idx': torch.arange(3, dtype=torch.int32)}
    comp = pol.cast_to_compute(tree)
    assert comp['w'].dtype == torch.bfloat16
    assert comp['idx'].dtype == torch.int32  # ints untouched
    back = pol.cast_to_param(comp)
    assert back['w'].dtype == torch.float32
    np.testing.assert_allclose(back['w'].numpy(), 1.0)
    assert pol.cast_to_output(comp)['w'].dtype == torch.float32
    assert pol.cast_to_reduce([tree['w']])[0].dtype == torch.bfloat16
    up = pol.upcast_from_reduce({'w': comp['w']}, {'w': tree['w']})
    assert up['w'].dtype == torch.float32
    assert precision.Policy().upcast_from_reduce(comp, tree) is comp


def test_policy_registry():
    assert precision.Policy.from_string('bf16') == precision.Policy.bf16()
    assert precision.Policy.from_string('f32') == precision.Policy()
    f16 = precision.Policy.from_string('float16')
    assert f16.compute_dtype == torch.float16
    assert f16.reduce_dtype == torch.float16
    assert isinstance(f16.loss_scale, precision.DynamicLossScale)
    with pytest.raises(ValueError) as got:
        precision.Policy.from_string('int8')
    with pytest.raises(ValueError) as want:
        jprecision.Policy.from_string('int8')
    assert str(got.value) == str(want.value)
    # the same table, the same printed form as the JAX package's
    for name in ('f32', 'float32', 'bf16', 'BFloat16', 'f16', 'float16'):
        assert repr(precision.Policy.from_string(name)) == repr(
            jprecision.Policy.from_string(name))
    assert hash(precision.Policy.bf16()) == hash(precision.Policy.bf16())
    scale = precision.StaticLossScale(8.0)
    assert precision.Policy.f16(scale) == precision.Policy.f16(scale)
    assert precision.Policy.f16() != precision.Policy.f16()  # own scales
    assert cmt.Policy is precision.Policy


def test_policy_declared_dtypes():
    for name in ('bf16', 'f32', 'f16'):
        assert precision.Policy.from_string(name).declared_dtypes() == \
            jprecision.Policy.from_string(name).declared_dtypes()
    assert precision.Policy.bf16().declared_dtypes() == {'bfloat16'}
    assert precision.Policy().declared_dtypes() == {'float32'}


def test_all_finite():
    assert bool(precision.all_finite(
        {'a': torch.ones(3), 'i': torch.arange(2)}))
    assert not bool(precision.all_finite(
        {'a': torch.tensor([1.0, np.inf])}))
    assert not bool(precision.all_finite({'a': torch.tensor([np.nan])}))
    assert bool(precision.all_finite({'i': torch.arange(2)}))  # no floats
    assert not bool(precision.all_finite(
        [torch.ones(2), torch.tensor([-np.inf], dtype=torch.bfloat16)]))


def test_tree_select():
    a = {'w': torch.ones(2), 'b': [torch.zeros(1)]}
    b = {'w': torch.full((2,), 3.0), 'b': [torch.ones(1)]}
    out = precision.tree_select(torch.tensor(False), a, b)
    assert torch.equal(out['w'], b['w']) and torch.equal(out['b'][0],
                                                         b['b'][0])
    out = precision.tree_select(torch.tensor(True), a, b)
    assert torch.equal(out['w'], a['w'])


# --------------------------------------------------------- loss scale
def _state(st):
    return float(st.scale), int(st.growth_count)


def test_dynamic_loss_scale_grow_backoff_clamp():
    kw = dict(initial_scale=8.0, growth_interval=2, growth_factor=2.0,
              backoff_factor=0.5, min_scale=1.0)
    ls, jls = precision.DynamicLossScale(**kw), \
        jprecision.DynamicLossScale(**kw)
    st, jst = ls.init(), jls.init()
    assert st.scale.dtype == torch.float32
    assert st.growth_count.dtype == torch.int32
    scaled = ls.scale({'g': torch.ones(2)}, st)
    np.testing.assert_allclose(scaled['g'].numpy(), 8.0)
    unscaled = ls.unscale(scaled, st)
    np.testing.assert_allclose(unscaled['g'].numpy(), 1.0)
    # two finite steps -> growth, counter reset
    st = ls.adjust(st, torch.tensor(True))
    assert _state(st) == (8.0, 1)
    st = ls.adjust(st, torch.tensor(True))
    assert _state(st) == (16.0, 0)
    # non-finite -> backoff, counter reset
    st = ls.adjust(st, torch.tensor(False))
    assert _state(st) == (8.0, 0)
    # repeated backoff clamps at min_scale
    for _ in range(10):
        st = ls.adjust(st, torch.tensor(False))
    assert _state(st) == (1.0, 0)
    # a verdict sequence step for step against the JAX scale
    st = ls.init()
    for finite in (True, True, True, False, True, False, False, True,
                   True, True):
        st = ls.adjust(st, torch.tensor(finite))
        jst = jls.adjust(jst, jnp.asarray(finite))
        assert _state(st) == (float(jst.scale), int(jst.growth_count))


def test_static_loss_scale_is_fixed():
    ls = precision.StaticLossScale(128.0)
    st = ls.adjust(ls.init(), torch.tensor(False))
    assert float(st.scale) == 128.0


def test_loss_scale_validation():
    for cls, kw in ((precision.StaticLossScale, dict(scale=0.0)),
                    (precision.DynamicLossScale, dict(backoff_factor=1.5)),
                    (precision.DynamicLossScale, dict(growth_factor=1.0)),
                    (precision.DynamicLossScale, dict(growth_interval=0))):
        with pytest.raises(ValueError) as got:
            cls(**kw)
        with pytest.raises(ValueError) as want:
            getattr(jprecision, cls.__name__)(**kw)
        assert str(got.value) == str(want.value)


# ------------------------------------------------------- concat dtype
def test_concat_examples_dtype_casts_floats_only():
    batch = [(np.ones((3,), np.float32), 1),
             (np.zeros((3,), np.float32), 2)]
    x, y = concat_examples(batch, dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16
    assert not y.is_floating_point()
    # the validity mask stays f32 (metric averages are f32)
    x, y, mask = concat_examples(batch, padding=(4, 0),
                                 dtype=torch.bfloat16)
    assert x.dtype == torch.bfloat16 and x.shape == (4, 3)
    assert mask.dtype == torch.float32
    np.testing.assert_array_equal(mask.numpy(), [1, 1, 0, 0])
    # pre-collated column arrays cast too
    cols = concat_examples((np.ones((4, 3), np.float32), np.arange(4)),
                           dtype=torch.bfloat16)
    assert cols[0].dtype == torch.bfloat16
    assert not cols[1].is_floating_point()
    # a numpy dtype keeps numpy arrays
    x, _ = concat_examples(batch, dtype=np.float16)
    assert x.dtype == np.float16


# ------------------------------------------- strategy reduce dtype
@pytest.mark.parametrize('strategy', ALL_NAMES)
def test_reduce_dtype_round_trips_every_strategy(strategy):
    """Every strategy takes reduce_dtype: the gradients' own dtype comes
    back, and bf16-exact values survive the narrow round trip."""
    comm = cmt.create_communicator(strategy, device='cpu',
                                   reduce_dtype=torch.bfloat16)
    grads = [torch.full((13, 3), 0.5), torch.full((5,), -2.0)]
    comm.allreduce_grad(grads)
    assert [g.dtype for g in grads] == [torch.float32] * 2
    np.testing.assert_array_equal(grads[0].numpy(), 0.5)
    np.testing.assert_array_equal(grads[1].numpy(), -2.0)


# --------------------------------------- StandardUpdater + policies
N_IN, N_UNITS = 784, 16


def _data(n=64, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, N_IN).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.int32)
    return [(x[i], y[i]) for i in range(n)]


def _jax_updater(policy, data, name='xla', tx=None, seed=0):
    comm = chainermn_tpu.create_communicator(
        name, devices=jax.devices()[:1], mesh_shape=(1, 1))
    model = JaxMLP(n_units=N_UNITS, n_out=10,
                   dtype=policy.compute_dtype if policy else None)
    params = jax.device_get(model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, N_IN)))['params'])
    clf = JaxClassifier(lambda p, x: model.apply({'params': p}, x))
    opt = chainermn_tpu.create_multi_node_optimizer(
        tx if tx is not None else optax.adam(1e-2), comm)
    upd = jtraining.StandardUpdater(iter([]), opt, clf, params, comm,
                                    has_aux=True, policy=policy,
                                    donate=False)
    return upd, upd.shard_batch(data), params


def _port_updater(policy, data, params, name='xla', make_opt=None):
    comm = cmt.create_communicator(name, device='cpu')
    model = models.MLP(n_units=N_UNITS, device='cpu',
                       dtype=policy.compute_dtype if policy else None)
    models.load_flax_variables(model, {'params': params})
    inner = (make_opt(model.parameters()) if make_opt is not None
             else torch.optim.Adam(model.parameters(), lr=1e-2))
    opt = cmt.create_multi_node_optimizer(inner, comm)
    upd = training.StandardUpdater(iter([]), opt, models.Classifier(model),
                                   model, comm, policy=policy)
    return upd, upd.shard_batch(data)


def _host(metrics):
    return {k: float(v) for k, v in metrics.items()}


def test_bf16_policy_loss_matches_f32_and_jax_on_mlp():
    """Policy.bf16() on the MLP: the batch ships bf16, the masters stay
    f32, the metrics are f32, and the losses track both the f32 run and
    the JAX bf16 run within rtol 5e-2 over 20 steps."""
    data = _data()
    pol = precision.Policy.bf16()
    jup, jarrays, params = _jax_updater(jprecision.Policy.bf16(), data)
    up, arrays = _port_updater(pol, data, params)
    u32, a32 = _port_updater(None, data, params)
    assert arrays[0].dtype == torch.bfloat16     # host-side compute cast
    assert a32[0].dtype == torch.float32
    assert up.comm.reduce_dtype == torch.bfloat16  # the policy imposed
    for _ in range(20):
        got = up.update_core(arrays)
        want = _host(jup.update_core(jarrays))
        l32 = float(u32.update_core(a32)['loss'])
        assert float(got['loss']) == pytest.approx(want['loss'], rel=5e-2)
    assert float(got['loss']) == pytest.approx(l32, rel=5e-2)
    for p in up.model.parameters():
        assert p.dtype == torch.float32
    metrics = up.update_core(arrays)
    assert all(v.dtype == torch.float32 for v in metrics.values())


def test_bf16_policy_reduces_gradients_in_bf16():
    """The gradients reach the strategy's reduction in bf16 (the
    policy's reduce dtype on the communicator) and come back f32."""
    data = _data(8)
    _, _, params = _jax_updater(None, data)
    up, arrays = _port_updater(precision.Policy.bf16(), data, params,
                               name='naive')
    seen = []
    impl = up.comm._allreduce_impl
    up.comm._allreduce_impl = lambda ts: seen.extend(
        t.dtype for t in ts) or impl(ts)
    up.update_core(arrays)          # the broadcast call: no reduction
    assert not seen
    up.update_core(arrays)
    assert seen and set(seen) == {torch.bfloat16}
    assert {p.grad.dtype for p in up.model.parameters()} == {torch.float32}
    # a communicator's own reduce dtype wins
    comm = cmt.create_communicator('xla', device='cpu',
                                   reduce_dtype=torch.float16)
    model = models.MLP(n_units=4, device='cpu')
    training.StandardUpdater(iter([]), torch.optim.SGD(
        model.parameters(), 0.1), models.Classifier(model), model, comm,
        policy=precision.Policy.bf16())
    assert comm.reduce_dtype == torch.float16


def test_policy_with_zero_is_not_ported():
    """``zero=True`` with a policy is ported now (its trajectories:
    ``tests/test_torch_trust_ratio.py``): construction builds the ZeRO
    step with the policy's reduce dtype and f32 masters, and
    ``zero_reduce_dtype`` beside a policy is refused as in JAX."""
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=4, device='cpu')
    up = training.StandardUpdater(
        iter([]), torch.optim.SGD(model.parameters(), 0.1),
        models.Classifier(model), model, comm, zero=True,
        policy=precision.Policy.bf16())
    assert up._zero.reduce_dtype == torch.bfloat16
    assert comm.reduce_dtype is None
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    with pytest.raises(ValueError, match='subsumed'):
        training.StandardUpdater(
            iter([]), torch.optim.SGD(model.parameters(), 0.1),
            models.Classifier(model), model, comm, zero=True,
            zero_reduce_dtype=torch.bfloat16,
            policy=precision.Policy.bf16())


class _Dot(torch.nn.Module):
    """``(w * x).sum()``: the JAX test's loss, as a module."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(4))

    def loss(self, x):
        return (self.w * x).sum(), {}


def test_loss_scale_skips_nonfinite_step_and_backs_off():
    """One inf in the batch: the step is skipped (parameters and the
    optimizer untouched), the scale backs off, the metrics say so --
    equal to the JAX updater's, and the next finite step steps."""
    kw = dict(initial_scale=4.0, growth_interval=2)
    jcomm = chainermn_tpu.create_communicator(
        'naive', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jpol = jprecision.Policy(
        param_dtype=jnp.float32, compute_dtype=jnp.float32,
        loss_scale=jprecision.DynamicLossScale(**kw))
    jopt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(0.1, momentum=0.9), jcomm, broadcast_first=False)
    jup = jtraining.StandardUpdater(
        iter([]), jopt, lambda p, x: ((p['w'] * x).sum(), {}),
        {'w': jnp.ones((4,))}, jcomm, has_aux=True, policy=jpol,
        donate=False)
    comm = cmt.create_communicator('naive', device='cpu')
    pol = precision.Policy(loss_scale=precision.DynamicLossScale(**kw))
    model = _Dot()
    inner = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
    opt = cmt.create_multi_node_optimizer(inner, comm,
                                          broadcast_first=False)
    up = training.StandardUpdater(iter([]), opt, model.loss, model, comm,
                                  policy=pol)
    bad = np.ones((8, 4), np.float32)
    bad[0, 0] = np.inf
    good = np.ones((8, 4), np.float32)
    for batch, finite in ((good, 1.0), (bad, 0.0), (good, 1.0)):
        before = (model.w.detach().clone(),
                  {k: v.clone() for k, v in inner.state[model.w].items()})
        got = _host(up.update_core((torch.from_numpy(batch),)))
        want = _host(jup.update_core(jup.shard_batch((batch,))))
        assert (got['loss_scale'], got['grads_finite']) == \
            (want['loss_scale'], want['grads_finite'])
        assert got['grads_finite'] == finite
        assert _state(up.scale_state) == (float(jup.scale_state.scale),
                                          int(jup.scale_state.growth_count))
        np.testing.assert_allclose(model.w.detach().numpy(),
                                   np.asarray(jup.params['w']), rtol=1e-6)
        if finite:
            assert not torch.equal(model.w.detach(), before[0])
        else:
            assert torch.equal(model.w.detach(), before[0])
            assert inner.state[model.w].keys() == before[1].keys()
            for k, v in before[1].items():
                assert torch.equal(inner.state[model.w][k], v)
    assert _state(up.scale_state) == (2.0, 1)


def test_nonfinite_step_keeps_a_pending_broadcast_and_the_buffers():
    """A skip at step 0 keeps the first broadcast pending (the JAX
    package retries it next step too), and keeps the step's BatchNorm
    running statistics as the JAX updater does (its ``new_state``):
    parameters and buffers held against the JAX ``StandardUpdater`` from
    the same flax weights after the skipped step and after the next."""
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.ResNet(stage_sizes=[1], width=4, num_classes=3,
                          dtype=torch.float32, device='cpu')
    jmodel = JaxResNet(stage_sizes=[1], width=4, num_classes=3,
                       dtype=jnp.float32)
    variables = jax.device_get(jmodel.init(
        {'params': jax.random.PRNGKey(0)}, jnp.zeros((1, 16, 16, 3)),
        train=False))
    models.load_flax_variables(model, variables)
    clf = models.StatefulClassifier(model)
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    up = training.StandardUpdater(
        iter([]), opt, clf.loss, model, comm,
        policy=precision.Policy(loss_scale=precision.StaticLossScale(2.0)))
    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jup = jtraining.StandardUpdater(
        iter([]), chainermn_tpu.create_multi_node_optimizer(
            optax.sgd(0.1), jcomm),
        JaxStatefulClassifier(jmodel).loss, variables['params'], jcomm,
        model_state={'batch_stats': variables['batch_stats']},
        policy=jprecision.Policy(
            loss_scale=jprecision.StaticLossScale(2.0)), donate=False)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 16, 16, 3).astype(np.float32)
    y = np.array([0, 1, 2, 0], np.int32)
    bad = x.copy()
    bad[1, 2, 3, 0] = np.inf
    params = [p.detach().clone() for p in model.parameters()]
    for step, batch in enumerate((bad, x)):
        m = _host(up.update_core((torch.from_numpy(batch),
                                  torch.from_numpy(y).long())))
        jm = _host(jup.update_core(jup.shard_batch(
            [(batch[i], y[i]) for i in range(4)])))
        assert (m['grads_finite'], m['loss_scale']) == \
            (jm['grads_finite'], jm['loss_scale']) == (1.0 * step, 2.0)
        got = models.to_flax_variables(model)
        want = {'params': jax.device_get(jup.params),
                'batch_stats': jax.device_get(
                    jup.model_state['batch_stats'])}
        for coll in ('params', 'batch_stats'):
            w = dict(jax.tree_util.tree_leaves_with_path(want[coll]))
            for path, leaf in jax.tree_util.tree_leaves_with_path(
                    got[coll]):
                # the inf in the batch makes the statistics non-finite
                # in both packages: the same entries, the rest close
                a, b = np.asarray(leaf), np.asarray(w[path])
                msg = '%s %s step %d' % (coll, path, step)
                np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                              err_msg=msg)
                np.testing.assert_array_equal(np.isinf(a), np.isinf(b),
                                              err_msg=msg)
                fin = np.isfinite(a)
                np.testing.assert_allclose(a[fin], b[fin], rtol=1e-4,
                                           atol=1e-5, err_msg=msg)
        if step == 0:
            assert opt.needs_broadcast
            assert all(torch.equal(a, b)
                       for a, b in zip(model.parameters(), params))
    assert not opt.needs_broadcast   # the finite step broadcast


def test_loss_scaled_trajectory_matches_unscaled():
    """Scaling by a power of two is exact: a loss-scaled f32 run takes
    the unscaled trajectory (rtol 1e-5), as the JAX one does."""
    data = _data()
    _, _, params = _jax_updater(None, data)
    pol = precision.Policy(loss_scale=precision.StaticLossScale(1024.0))
    u_plain, a = _port_updater(None, data, params, name='naive')
    u_scaled, a_s = _port_updater(pol, data, params, name='naive')
    for _ in range(5):
        lp = u_plain.update_core(a)
        ls = u_scaled.update_core(a_s)
        assert float(ls['loss']) == pytest.approx(float(lp['loss']),
                                                  rel=1e-5)
        assert float(ls['loss_scale']) == 1024.0
    for p, q in zip(u_plain.model.parameters(), u_scaled.model.parameters()):
        np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_f16_policy_against_jax():
    """Policy.f16() with a dynamic scale small enough to grow in the
    run: the loss-scale state and every skip decision equal the JAX
    updater's step for step, the losses within rtol 5e-2."""
    data = _data(32)
    kw = dict(initial_scale=2.0 ** 10, growth_interval=3)
    jpol = jprecision.Policy.f16(jprecision.DynamicLossScale(**kw))
    pol = precision.Policy.f16(precision.DynamicLossScale(**kw))
    jup, jarrays, params = _jax_updater(jpol, data)
    up, arrays = _port_updater(pol, data, params)
    assert arrays[0].dtype == torch.float16
    assert up.comm.reduce_dtype == torch.float16
    for _ in range(8):
        got = _host(up.update_core(arrays))
        want = _host(jup.update_core(jarrays))
        assert (got['loss_scale'], got['grads_finite']) == \
            (want['loss_scale'], want['grads_finite'])
        assert got['loss'] == pytest.approx(want['loss'], rel=5e-2)
        assert _state(up.scale_state) == (float(jup.scale_state.scale),
                                          int(jup.scale_state.growth_count))
    assert float(up.scale_state.scale) == 2.0 ** 12   # grew twice
    for p in up.model.parameters():
        assert p.dtype == torch.float32


def test_snapshot_keeps_the_loss_scale_state(tmp_path):
    """A resumed loss-scaled run goes on at its adapted scale, as the
    JAX package's snapshot keeps ``scale_state``."""
    from chainermn_tpu_torch import serializers
    data = _data(8)
    _, _, params = _jax_updater(None, data)
    kw = dict(initial_scale=2.0 ** 10, growth_interval=1)
    pol = precision.Policy(loss_scale=precision.DynamicLossScale(**kw))
    up, arrays = _port_updater(pol, data, params)
    for _ in range(3):
        up.update_core(arrays)
    assert _state(up.scale_state) == (2.0 ** 13, 0)
    path = serializers.save_npz(str(tmp_path / 'snap'),
                                serializers.updater_state(up))
    fresh, _ = _port_updater(
        precision.Policy(loss_scale=precision.DynamicLossScale(**kw)),
        data, params)
    serializers.resume_updater(path, fresh)
    assert _state(fresh.scale_state) == (2.0 ** 13, 0)
    assert fresh.scale_state.scale.dtype == torch.float32
    assert fresh.scale_state.growth_count.dtype == torch.int32
