"""Two faults of the port held against the JAX package.

C3: a double-buffered run resumed from an npz snapshot keeps the reduced
gradients it had not applied yet, so it equals the uninterrupted run and
the JAX package's own resume (rtol 1e-5): an MLP 5 -> 16 -> 2, SGD lr
0.1, ``double_buffering=True``, batch 32.

C4: a loss-scaled step skipped for a gradient that is non-finite while
the forward is finite keeps the step's BatchNorm running statistics, as
the JAX ``StandardUpdater`` keeps its ``new_state`` (rtol 1e-4, the
tolerance of ``test_torch_training.py``'s slice): ``ResNet(stage_sizes=
[1, 1], width=8)`` under ``StaticLossScale(1.0)``, the classifier's loss
plus ``0 * sqrt(sum(b) - sum(b))`` over the fc bias.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import ops as jops
from chainermn_tpu import precision as jprecision
from chainermn_tpu import serializers as jserializers
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import MLP as JaxMLP, Classifier as JaxClassifier
from chainermn_tpu.models import StatefulClassifier as JaxStatefulClassifier
from chainermn_tpu.models.resnet50 import ResNet as JaxResNet
from chainermn_tpu_torch import models, ops, precision, serializers, training

torch.set_num_threads(2)

N_IN, N_UNITS, N_OUT, BATCH, LR = 5, 16, 2, 32, 0.1


def _mlp_data(steps=4):
    rng = np.random.RandomState(3)
    x = rng.randn(steps * BATCH, N_IN).astype(np.float32)
    y = rng.randint(0, N_OUT, steps * BATCH).astype(np.int32)
    return [(x[i], y[i]) for i in range(len(x))]


def _flax_mlp():
    jm = JaxMLP(n_units=N_UNITS, n_out=N_OUT)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, N_IN)))['params'])
    return jm, params


def _port_run(params, data, steps):
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=N_UNITS, n_out=N_OUT, n_in=N_IN,
                       device='cpu')
    models.load_flax_variables(model, {'params': params})
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=LR), comm,
        double_buffering=True)
    up = training.StandardUpdater(
        training.SerialIterator(data, BATCH, shuffle=False), opt,
        models.Classifier(model), model, comm)
    for _ in range(steps):
        up.update()
    return up


def _jax_run(jm, params, data, steps):
    comm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(LR), comm, double_buffering=True)
    up = jtraining.StandardUpdater(
        jtraining.SerialIterator(data, BATCH, shuffle=False), opt,
        JaxClassifier(lambda p, x: jm.apply({'params': p}, x)), params,
        comm, has_aux=True, donate=False)
    for _ in range(steps):
        up.update()
    return up


def _params_of(up):
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(up.params)}


def test_double_buffered_resume_keeps_the_pending_gradients(tmp_path):
    jm, params = _flax_mlp()
    data = _mlp_data()
    straight = _port_run(params, data, 4)
    first = _port_run(params, data, 2)
    assert first.optimizer.pending is not None
    path = str(tmp_path / 'port.npz')
    serializers.save_npz(path, serializers.updater_state(first))
    resumed = _port_run(params, data, 0)
    assert resumed.optimizer.pending is None
    serializers.resume_updater(path, resumed)
    assert resumed.optimizer.pending is not None
    assert not resumed.optimizer.needs_broadcast
    for _ in range(2):
        resumed.update()
    # the JAX package: straight, and its own resume
    jstraight = _jax_run(jm, params, data, 4)
    jfirst = _jax_run(jm, params, data, 2)
    jpath = str(tmp_path / 'jax.npz')
    jserializers.save_npz(jpath, jserializers.updater_state(jfirst))
    jresumed = _jax_run(jm, params, data, 0)
    jserializers.resume_updater(jpath, jresumed)
    for _ in range(2):
        jresumed.update()
    got, want = _params_of(resumed), _params_of(jresumed)
    ref, jref = _params_of(straight), _params_of(jstraight)
    assert sorted(got) == sorted(want) == sorted(ref)
    moved = 0.0
    for name in got:
        np.testing.assert_allclose(got[name], ref[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        np.testing.assert_allclose(want[name], jref[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        moved = max(moved, np.abs(got[name] - params[name.split('/')[0]][
            name.split('/')[1]]).max())
    assert moved > 1e-3          # the run did step


def test_snapshot_without_a_pending_reduction_restores_none(tmp_path):
    """Right after the broadcast call nothing is pending: the snapshot
    says so, and a resume leaves ``pending`` empty."""
    _, params = _flax_mlp()
    up = _port_run(params, _mlp_data(), 1)
    assert up.optimizer.pending is None
    state = serializers.updater_state(up)
    assert not state['opt_state']['have_pending']
    assert 'pending' not in state['opt_state']
    path = str(tmp_path / 's.npz')
    serializers.save_npz(path, state)
    fresh = _port_run(params, _mlp_data(), 0)
    serializers.resume_updater(path, fresh)
    assert fresh.optimizer.pending is None
    assert not fresh.optimizer.needs_broadcast


def _bias_nan(loss, bias):
    """``loss + 0 * sqrt(sum(b) - sum(b))``: the value is the loss, the
    gradient of ``b`` is NaN (the root's slope at 0 is infinite)."""
    return loss + 0.0 * torch.sqrt(bias.sum() - bias.sum())


def test_backward_only_nan_step_keeps_the_running_statistics():
    rng = np.random.RandomState(7)
    data = [(rng.randn(32, 32, 3).astype(np.float32),
             np.int32(rng.randint(10))) for _ in range(4)]
    jmodel = JaxResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                       dtype=jnp.float32)
    variables = jax.device_get(jmodel.init(
        {'params': jax.random.PRNGKey(3)}, jnp.zeros((1, 32, 32, 3)),
        train=False))
    jclf = JaxStatefulClassifier(jmodel)

    def jloss(params, model_state, rng, x, y):
        loss, aux = jclf.loss(params, model_state, rng, x, y)
        b = params['fc']['bias']
        return loss + 0.0 * jnp.sqrt(jnp.sum(b) - jnp.sum(b)), aux

    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jup = jtraining.StandardUpdater(
        iter([]), chainermn_tpu.create_multi_node_optimizer(
            jops.fused_momentum_sgd(0.1, 0.9), jcomm,
            broadcast_first=False),
        jloss, variables['params'], jcomm,
        model_state={'batch_stats': variables['batch_stats']},
        policy=jprecision.Policy(
            loss_scale=jprecision.StaticLossScale(1.0)), donate=False)
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                          dtype=torch.float32, fused_norm=False,
                          device='cpu')
    models.load_flax_variables(model, variables)
    clf = models.StatefulClassifier(model)

    def loss(x, y):
        value, metrics = clf.loss(x, y)
        return _bias_nan(value, model.fc.bias), metrics

    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm,
        broadcast_first=False)
    up = training.StandardUpdater(
        iter([]), opt, loss, model, comm,
        policy=precision.Policy(loss_scale=precision.StaticLossScale(1.0)))
    before = jax.tree_util.tree_map(   # copies: the leaves share memory
        np.array, models.to_flax_variables(model)['batch_stats'])
    x = np.stack([d[0] for d in data])
    y = np.array([d[1] for d in data], np.int32)
    m = up.update_core((torch.from_numpy(x), torch.from_numpy(y).long()))
    jm = jup.update_core(jup.shard_batch(data))
    assert float(m['grads_finite']) == float(jm['grads_finite']) == 0.0
    got = models.to_flax_variables(model)
    want = {'params': jax.device_get(jup.params),
            'batch_stats': jax.device_get(jup.model_state['batch_stats'])}
    moved = 0.0
    for coll in ('params', 'batch_stats'):
        w = dict(jax.tree_util.tree_leaves_with_path(want[coll]))
        for path, leaf in jax.tree_util.tree_leaves_with_path(got[coll]):
            np.testing.assert_allclose(leaf, np.asarray(w[path]), rtol=1e-4,
                                       atol=1e-6, err_msg='%s %s'
                                       % (coll, path))
    # the statistics took the step's update; the parameters did not move
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            got['batch_stats']):
        old = dict(jax.tree_util.tree_leaves_with_path(before))[path]
        moved = max(moved, float(np.abs(leaf - old).max()))
    assert moved > 1e-3
    for path, leaf in jax.tree_util.tree_leaves_with_path(got['params']):
        want0 = dict(jax.tree_util.tree_leaves_with_path(
            variables['params']))[path]
        np.testing.assert_array_equal(leaf, np.asarray(want0))
