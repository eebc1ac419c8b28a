"""The ImageNet slice of the port against the JAX package.

The learning-rate recipes against their optax originals, momentum SGD
on a schedule, the whole step under ``hierarchical`` with
``FusedMomentumSGD(distributed_sgd_schedule(...))`` against the JAX
updater with ``optax.sgd(schedule, momentum=0.9)``, the prefetching
iterators against the JAX ones, ``get_arch`` and ResNet-101 against
the JAX model, and the torchrun twin of
``examples/imagenet/train_imagenet.py`` on two gloo ranks.
"""

import copy
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import models as jmodels
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import StatefulClassifier as JaxClassifier
from chainermn_tpu.models.resnet50 import ResNet as JaxResNet
from chainermn_tpu.training.iterators import (
    MultiprocessIterator as JaxMultiprocessIterator)
from chainermn_tpu.utils import schedules as jschedules
from chainermn_tpu_torch import models, ops, serializers, training
from chainermn_tpu_torch.examples.imagenet import (
    compute_mean, train_imagenet)
from chainermn_tpu_torch.utils import schedules

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------
# schedules

def _optax_values(sched, n):
    """optax evaluates a schedule at the optimizer's int32 count."""
    return np.array([float(sched(jnp.asarray(k, jnp.int32)))
                     for k in range(n)])


RECIPES = [
    # global_batch, steps_per_epoch, base_lr, base_batch, warmup, total
    (8, 5, 0.1, 4, 2, 10),
    (64, 20, 0.01, 32, 1, 1),     # the twin's --epoch 1 run
    (256, 1, 0.1, 256, 5, 90),
]


@pytest.mark.parametrize('decay', ['cosine', 'step'])
@pytest.mark.parametrize('recipe', RECIPES)
def test_distributed_sgd_schedule_matches_optax(recipe, decay):
    gb, spe, lr, bb, warm, total = recipe
    kw = dict(global_batch=gb, steps_per_epoch=spe, base_lr=lr,
              base_batch=bb, warmup_epochs=warm, total_epochs=total,
              decay=decay)
    n = total * spe + 5
    want = _optax_values(jschedules.distributed_sgd_schedule(**kw), n)
    got = np.array([schedules.distributed_sgd_schedule(**kw)(k)
                    for k in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    if decay == 'step' and total >= 60:   # /10 at epoch 30
        assert want[30 * spe] == pytest.approx(want[30 * spe - 1] * 0.1)


@pytest.mark.parametrize('make', [
    lambda m: m.linear_schedule(0.5, 0.05, 7, transition_begin=3),
    lambda m: m.linear_schedule(0.5, 0.05, 0),
    lambda m: m.cosine_decay_schedule(0.3, 9, alpha=0.1, exponent=2.0),
    lambda m: m.piecewise_constant_schedule(1.0, {3: 0.5, 6: 0.1}),
    lambda m: m.join_schedules([m.constant_schedule(0.2),
                                m.cosine_decay_schedule(0.2, 5)], [4]),
])
def test_schedule_primitives_match_optax(make):
    n = 16
    want = _optax_values(make(optax), n)
    got = np.array([make(schedules)(k) for k in range(n)])
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)


def test_schedule_argument_checks():
    with pytest.raises(ValueError):
        schedules.cosine_decay_schedule(0.1, 0)
    with pytest.raises(ValueError):
        schedules.piecewise_constant_schedule(0.1, {3: -1.0})
    with pytest.raises(ValueError):
        schedules.distributed_sgd_schedule(8, 1, decay='linear')
    with pytest.raises(ValueError):
        schedules.linear_scaled_lr(0.1, 0)


def test_fused_momentum_sgd_reads_the_schedule_at_its_update_count():
    seen = []

    def sched(step):
        seen.append(step)
        return 0.1 * (step + 1)

    p = torch.ones(3, requires_grad=True)
    opt = ops.FusedMomentumSGD([p], sched, momentum=0.9)
    v, want = np.zeros(3), np.ones(3)
    for k in range(3):
        p.grad = torch.full((3,), 1.0)
        opt.step()
        v = 0.9 * v + 1.0
        want = want - np.float32(0.1 * (k + 1)) * v
    assert seen == [0, 1, 2] and opt.state[p]['step'] == 3
    np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6)
    with pytest.raises(ValueError):
        ops.FusedMomentumSGD([p], -0.1)


# ---------------------------------------------------------------------
# the slice: hierarchical + FusedMomentumSGD on a schedule

def _dataset(n=4, size=32, classes=10):
    rng = np.random.RandomState(11)
    return [(rng.randn(size, size, 3).astype(np.float32),
             np.int32(rng.randint(classes))) for _ in range(n)]


def test_training_slice_matches_jax(tmp_path):
    """One broadcast call and 3 updates at counts 0, 1 (warmup) and 2
    (the first cosine step)."""
    kw = dict(global_batch=4, steps_per_epoch=1, base_lr=0.1, base_batch=4,
              warmup_epochs=2, total_epochs=6)
    data = _dataset()
    jmodel = JaxResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                       dtype=jnp.float32)
    variables = jax.device_get(jmodel.init(
        {'params': jax.random.PRNGKey(4)}, jnp.zeros((1, 32, 32, 3)),
        train=False))
    jcomm = chainermn_tpu.create_communicator(
        'hierarchical', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jopt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(jschedules.distributed_sgd_schedule(**kw), momentum=0.9),
        jcomm)
    jup = jtraining.StandardUpdater(
        jtraining.SerialIterator(data, 4, shuffle=False), jopt,
        JaxClassifier(jmodel).loss, variables['params'], jcomm,
        model_state={'batch_stats': variables['batch_stats']})

    comm = cmt.create_communicator('hierarchical', device='cpu')
    model = models.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                          dtype=torch.float32, device='cpu')
    models.load_flax_variables(model, variables)
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(),
                             schedules.distributed_sgd_schedule(**kw), 0.9),
        comm)
    up = training.StandardUpdater(
        training.SerialIterator(data, 4, shuffle=False), opt,
        models.StatefulClassifier(model).loss, model, comm)
    trainer = training.Trainer(up, (4, 'iteration'), out=str(tmp_path))
    losses = []

    def compare(tr):
        jm = jup.update()
        losses.append(tr.observation['loss'])
        np.testing.assert_allclose(tr.observation['loss'], jm['loss'], **F32)
        got = models.to_flax_variables(model)
        want = {'params': jax.device_get(jup.params),
                'batch_stats': jax.device_get(
                    jup.model_state['batch_stats'])}
        for coll in ('params', 'batch_stats'):
            g = jax.tree_util.tree_leaves_with_path(got[coll])
            w = dict(jax.tree_util.tree_leaves_with_path(want[coll]))
            assert len(g) == len(w)
            for path, leaf in g:
                np.testing.assert_allclose(
                    leaf, np.asarray(w[path]), **F32,
                    err_msg='%s %s iteration %d' % (coll, path, len(losses)))

    trainer.extend(compare, trigger=(1, 'iteration'))
    trainer.run()
    assert len(losses) == 4 and losses[0] == losses[1] != losses[2]
    inner = opt.actual_optimizer
    assert {inner.state[p]['step'] for p in model.parameters()} == {3}


# ---------------------------------------------------------------------
# iterators

def _items(n=10):
    rng = np.random.RandomState(3)
    return [(rng.randn(2, 3).astype(np.float32), np.int32(i))
            for i in range(n)]


def test_multiprocess_iterator_matches_jax():
    data = _items()
    ours = training.MultiprocessIterator(data, 4, seed=5, n_prefetch=2)
    theirs = JaxMultiprocessIterator(data, 4, seed=5, n_prefetch=2)
    serial = training.SerialIterator(data, 4, seed=5)
    try:
        while ours.epoch < 2:
            a, b, c = next(ours), next(theirs), next(serial)
            for x, y, z in zip(a, b, c):
                np.testing.assert_array_equal(x[0], y[0])
                np.testing.assert_array_equal(x[0], z[0])
                assert x[1] == y[1] == z[1]
            assert ours.epoch_detail == theirs.epoch_detail \
                == serial.epoch_detail
            assert (ours.epoch, ours.is_new_epoch) == (
                theirs.epoch, theirs.is_new_epoch)
        assert theirs.epoch == 2 and ours.iteration == theirs.iteration
    finally:
        ours.finalize()
        theirs.finalize()
    assert not ours._thread.is_alive()


def test_multiprocess_iterator_restores_and_ends():
    data = _items()
    it = training.MultiprocessIterator(data, 4, seed=1)
    ref = training.SerialIterator(data, 4, seed=1)
    ref.restore_position(1.2)
    it.restore_position(1.2)
    assert it.epoch_detail == pytest.approx(1.2)
    for _ in range(3):
        assert [x[1] for x in next(it)] == [x[1] for x in next(ref)]
    it.finalize()
    once = training.MultiprocessIterator(data, 4, repeat=False,
                                         shuffle=False)
    assert sum(len(b) for b in once) == len(data)
    with pytest.raises(StopIteration):
        next(once)   # the terminal item is remembered
    once.reset()
    assert len(next(once)) == 4
    once.finalize()


def test_device_prefetch_keeps_the_consumers_epoch_accounting():
    data = _items()
    placed = []

    def place(batch):
        out = tuple(torch.from_numpy(np.stack([b[i] for b in batch]))
                    for i in range(2))
        placed.append(out)
        return out

    it = training.DevicePrefetchIterator(
        training.SerialIterator(data, 4, seed=2), place, depth=3)
    ref = training.SerialIterator(data, 4, seed=2)
    try:
        for _ in range(6):
            x, y = next(it)
            want = next(ref)
            assert y.tolist() == [int(b[1]) for b in want]
            assert (it.epoch, it.epoch_detail, it.is_new_epoch) == (
                ref.epoch, ref.epoch_detail, ref.is_new_epoch)
        assert len(placed) > 6   # the worker ran ahead of the consumer
        it.restore_position(0.4)
        ref.restore_position(0.4)
        assert next(it)[1].tolist() == [int(b[1]) for b in next(ref)]
    finally:
        it.finalize()
    with pytest.raises(ValueError):
        training.DevicePrefetchIterator(iter([]), place, depth=0)


def test_updater_device_prefetch_trains_as_without():
    data = _dataset(8)
    out = []
    for prefetch in (0, 2):
        model = models.ResNet(stage_sizes=[1], width=4, num_classes=10,
                              dtype=torch.float32, device='cpu')
        comm = cmt.create_communicator('xla', device='cpu')
        opt = cmt.create_multi_node_optimizer(
            ops.FusedMomentumSGD(model.parameters(), 0.1), comm)
        up = training.StandardUpdater(
            training.SerialIterator(data, 4, seed=0), opt,
            models.StatefulClassifier(model).loss, model, comm,
            device_prefetch=prefetch)
        out.append([up.update()['loss'] for _ in range(3)]
                   + [up.epoch_detail])
        if prefetch:
            assert isinstance(up.iterator, training.DevicePrefetchIterator)
            host = up.collate_pinned(data[:4])
            assert host[0].shape == (4, 32, 32, 3) and not host[0].is_pinned()
            up.iterator.finalize()
    assert out[0] == out[1]


# ---------------------------------------------------------------------
# the registry

def test_get_arch_resnet101_matches_jax():
    assert list(jmodels.ResNet101().stage_sizes) == [3, 4, 23, 3]
    assert list(jmodels.ResNet152().stage_sizes) == [3, 8, 36, 3]
    jmodel = JaxResNet(stage_sizes=[3, 4, 23, 3], width=4, num_classes=10,
                       dtype=jnp.float32)
    variables = jax.device_get(jmodel.init(
        {'params': jax.random.PRNGKey(2)}, jnp.zeros((1, 64, 64, 3)),
        train=False))
    # 64 px at batch 4: the last stage's batch statistics average 16
    # values (at 32 px and batch 2 only 2, and their rounding dominates)
    rng = np.random.RandomState(0)
    x = rng.randn(4, 64, 64, 3).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)

    def jloss(params):
        logits, _ = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x), train=True, mutable=['batch_stats'])
        return optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean(), logits

    (jl, jlogits), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables['params'])
    model = models.get_arch('resnet101', width=4, num_classes=10,
                            dtype=torch.float32, device='cpu')
    assert model.insize == 224 and len(model.block_names) == 33
    models.load_flax_variables(model, variables)
    logits = model(torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)
                                             .long())
    loss.backward()
    tol = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_resnet.py's f32
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **tol)
    np.testing.assert_allclose(loss.item(), float(jl), **tol)
    grad_model = copy.deepcopy(model)
    with torch.no_grad():
        for (_, p), q in zip(model.named_parameters(),
                             grad_model.parameters()):
            q.copy_(p.grad)
    got = dict(jax.tree_util.tree_leaves_with_path(
        models.to_flax_variables(grad_model)['params']))
    want = jax.tree_util.tree_leaves_with_path(jax.device_get(jgrads))
    assert len(got) == len(want)
    for path, leaf in want:
        np.testing.assert_allclose(got[path], np.asarray(leaf), **tol,
                                   err_msg=jax.tree_util.keystr(path))
    assert len(models.get_arch('resnet152', width=2, device='cpu')
               .block_names) == 50


# ---------------------------------------------------------------------
# the twin

def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def test_imagenet_twin_two_gloo_ranks(tmp_path, monkeypatch):
    """One epoch of the quick set on 2 gloo ranks under torchrun's
    environment, with ``hierarchical`` on a (1, 2) mesh; then, in this
    process, a resume from its snapshot and an ``--initmodel``."""
    out = tmp_path / 'result'
    args = ['--cpu', '--quick', '--dtype', 'float32', '--communicator',
            'hierarchical', '--mesh', '1x2', '--batchsize', '32',
            '--val_batchsize', '32', '--out', str(out)]
    port = _free_port()
    script = REPO / 'chainermn_tpu_torch' / 'examples' / 'imagenet' / \
        'train_imagenet.py'
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                   WORLD_SIZE='2', LOCAL_WORLD_SIZE='2',
                   MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                   OMP_NUM_THREADS='2')
        procs.append(subprocess.Popen(
            [sys.executable, str(script)] + args, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        log, _ = p.communicate(timeout=600)
        logs.append(log.decode())
        assert p.returncode == 0, logs[-1]
    assert 'Num processes: 2 (mesh 1x2)' in logs[0]
    assert 'final observation' in logs[0]
    snaps = sorted(os.listdir(out))
    # 512 images / 32 a global batch: 16 iterations
    assert 'snapshot_iter_16.npz' in snaps and 'log' in snaps
    by_key, _ = serializers.read_npz(str(out / 'snapshot_iter_16.npz'))
    assert int(by_key['iteration']) == 16
    # momentum SGD stepped 15 times (the first call broadcasts)
    assert int(by_key['opt_state/actual_state/0/step']) == 15
    assert not bool(by_key['opt_state/needs_broadcast'])

    # in one process, the runs themselves left out: --initmodel, then
    # --resume
    params = {k[len('params/'):]: v for k, v in by_key.items()
              if k.startswith('params/')}
    tree = {}
    for k, v in params.items():
        node = tree
        parts = k.split('/')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = 0.5 * v
    init = tmp_path / 'init.npz'
    serializers.save_npz(str(init), tree)
    common = ['--cpu', '--quick', '--dtype', 'float32', '--batchsize', '16',
              '--out', str(tmp_path / 'again')]
    monkeypatch.setattr(training.Trainer, 'run', lambda self: None)
    trainer = train_imagenet.main(common + ['--initmodel', str(init)])
    train_imagenet.close(trainer)
    trainer_params = {
        '/'.join(p.key for p in path): leaf
        for path, leaf in jax.tree_util.tree_leaves_with_path(
            models.to_flax_variables(trainer.updater.model)['params'])}
    assert sorted(trainer_params) == sorted(params)
    for key, leaf in trainer_params.items():
        np.testing.assert_array_equal(leaf, 0.5 * params[key])
    trainer = train_imagenet.main(
        common + ['--resume', str(out / 'snapshot_iter_16.npz')])
    try:
        assert trainer.updater.iteration == 16
        assert trainer.updater.optimizer.needs_broadcast is False
        got = models.to_flax_variables(trainer.updater.model)['params']
        for path, leaf in jax.tree_util.tree_leaves_with_path(got):
            np.testing.assert_array_equal(
                leaf, params['/'.join(p.key for p in path)])
    finally:
        train_imagenet.close(trainer)


def test_imagenet_twin_refuses_unported_options(tmp_path):
    """An unknown ``--pipeline`` is refused (``native`` is ported:
    ``tests/test_torch_input_pipeline.py`` runs it); ``--double-buffering``
    is ported: one quick epoch trains with the double-buffered optimizer
    under ``Trainer(async_metrics=True)``, as the JAX script does."""
    with pytest.raises(SystemExit):
        train_imagenet.main(['--cpu', '--pipeline', 'dali'])
    trainer = train_imagenet.main([
        '--cpu', '--quick', '--double-buffering', '--arch', 'nin',
        '--dtype', 'float32', '--batchsize', '64', '--out',
        str(tmp_path / 'out')])
    try:
        opt = trainer.updater.optimizer
        assert opt.double_buffering and trainer.async_metrics
        assert trainer.updater.iteration == 8 and opt.pending is not None
        assert np.isfinite(float(trainer.observation['loss']))
    finally:
        train_imagenet.close(trainer)


def test_compute_mean_twin(tmp_path):
    out = tmp_path / 'mean.npy'
    mean = compute_mean.main(['--output', str(out), '--limit', '4'])
    np.testing.assert_array_equal(np.load(out), mean)
    assert mean.shape == (256, 256, 3) and mean.dtype == np.float32
