"""The port's triggers, trainer extensions, ``NanGuard`` and npz
snapshots, the snapshots also across packages.

The trigger cases are those of ``tests/test_triggers.py`` that need no
JAX array.  The snapshots are read by the other package: a port
``save_npz`` file by the JAX ``read_npz`` (manifest and crc checked) and
the reverse, and an MLP snapshot of either package's
``extensions.snapshot()`` loaded into the other package's model.
"""

import io
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import serializers as jserializers
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import Classifier as JaxClassifier
from chainermn_tpu.training import extensions as jextensions
from chainermn_tpu_torch import models, ops, serializers, training, utils
from chainermn_tpu_torch.training import extensions, triggers
from chainermn_tpu_torch.utils import CheckpointCorruptError

torch.set_num_threads(2)


class _FakeUpdater:
    def __init__(self):
        self.iteration = 0
        self.epoch = 0
        self.is_new_epoch = False


class _FakeTrainer:
    def __init__(self, out=None):
        self.updater = _FakeUpdater()
        self.observation = {}
        self.out = out
        self.elapsed_time = 0.0

    def step(self, new_epoch=False, **obs):
        self.updater.iteration += 1
        self.updater.is_new_epoch = new_epoch
        self.updater.epoch += int(new_epoch)
        self.observation = obs


# ---------------------------------------------------------------------
# triggers (the cases of tests/test_triggers.py)

def test_max_value_trigger_fires_on_improvement():
    tr = _FakeTrainer()
    trig = triggers.MaxValueTrigger('acc', check_trigger=(1, 'iteration'))
    fired = []
    for acc in (0.5, 0.6, 0.55, 0.7, 0.7):
        tr.step(acc=acc)
        fired.append(trig(tr))
    assert fired == [True, True, False, True, False]
    assert trig.best == 0.7


def test_min_value_trigger():
    tr = _FakeTrainer()
    trig = triggers.MinValueTrigger('loss', check_trigger=(1, 'iteration'))
    fired = []
    for loss in (2.0, 1.5, 1.8, 1.1):
        tr.step(loss=loss)
        fired.append(trig(tr))
    assert fired == [True, True, False, True]


def test_best_value_skips_missing_key_and_reads_tensors():
    tr = _FakeTrainer()
    trig = triggers.MaxValueTrigger('acc', check_trigger=(1, 'iteration'))
    tr.step(other=1.0)
    assert trig(tr) is False
    tr.step(acc=torch.tensor(0.9))
    assert trig(tr) is True
    assert trig.best == pytest.approx(0.9)


def test_early_stopping_patience():
    tr = _FakeTrainer()
    stop = triggers.EarlyStoppingTrigger(
        'acc', patience=2, mode='max', check_trigger=(1, 'iteration'),
        max_trigger=(1000, 'iteration'))
    out = []
    for acc in [0.5, 0.6, 0.58, 0.59, 0.7, 0.65, 0.6]:
        tr.step(acc=acc)
        out.append(stop(tr))
    assert out[:4] == [False, False, False, True]


def test_early_stopping_max_trigger_backstop():
    tr = _FakeTrainer()
    stop = triggers.EarlyStoppingTrigger(
        'acc', patience=99, mode='max', check_trigger=(1, 'iteration'),
        max_trigger=(3, 'iteration'))
    out = []
    for acc in (0.1, 0.2, 0.3):
        tr.step(acc=acc)
        out.append(stop(tr))
    assert out == [False, False, True]


def test_early_stopping_min_mode():
    tr = _FakeTrainer()
    stop = triggers.EarlyStoppingTrigger(
        'loss', patience=1, mode='min', check_trigger=(1, 'iteration'),
        max_trigger=(1000, 'iteration'))
    tr.step(loss=1.0)
    assert stop(tr) is False
    tr.step(loss=1.2)
    assert stop(tr) is True
    with pytest.raises(ValueError):
        triggers.EarlyStoppingTrigger('loss', mode='median')


def test_trigger_state_roundtrip():
    tr = _FakeTrainer()
    trig = triggers.MaxValueTrigger('acc', check_trigger=(1, 'iteration'))
    tr.step(acc=0.9)
    assert trig(tr) is True
    fresh = triggers.MaxValueTrigger('acc', check_trigger=(1, 'iteration'))
    fresh.load_state_dict(trig.state_dict())
    tr2 = _FakeTrainer()
    tr2.updater.iteration = tr.updater.iteration
    tr2.step(acc=0.7)  # worse than the restored 0.9: must NOT fire
    assert fresh(tr2) is False
    tr2.step(acc=0.95)
    assert fresh(tr2) is True

    stop = triggers.EarlyStoppingTrigger(
        'acc', patience=2, mode='max', check_trigger=(1, 'iteration'),
        max_trigger=(1000, 'iteration'))
    tr3 = _FakeTrainer()
    for acc in (0.6, 0.5):  # one stale check accumulated
        tr3.step(acc=acc)
        stop(tr3)
    resumed = triggers.EarlyStoppingTrigger(
        'acc', patience=2, mode='max', check_trigger=(1, 'iteration'),
        max_trigger=(1000, 'iteration'))
    resumed.load_state_dict(stop.state_dict())
    tr4 = _FakeTrainer()
    tr4.updater.iteration = tr3.updater.iteration
    tr4.step(acc=0.55)  # second consecutive stale check -> stop
    assert resumed(tr4) is True
    # the interval trigger's own counter
    every3 = triggers.IntervalTrigger(3, 'iteration')
    tr5 = _FakeTrainer()
    for _ in range(4):
        tr5.step()
        every3(tr5)
    again = triggers.IntervalTrigger(3, 'iteration')
    again.load_state_dict(every3.state_dict())
    tr5.step()
    assert again(tr5) is False   # iteration 5: not a multiple of 3
    tr5.step()
    assert again(tr5) is True


# ---------------------------------------------------------------------
# extensions and the trainer

def test_log_report_keeps_sparse_keys_undiluted(tmp_path):
    tr = _FakeTrainer(out=str(tmp_path))
    log = extensions.LogReport()
    for i in range(4):
        obs = {'loss': float(i)}
        if i == 3:
            obs['validation/main/accuracy'] = 0.8   # once an epoch
        tr.step(new_epoch=(i == 3), **obs)
        entry = log(tr)
    assert entry['loss'] == 1.5
    assert entry['validation/main/accuracy'] == 0.8
    assert (entry['epoch'], entry['iteration']) == (1, 4)
    written = json.loads((tmp_path / 'log').read_text())
    assert written == log.log and len(written) == 1
    only = extensions.LogReport(keys=['loss'])
    tr.step(new_epoch=True, loss=2.0, other=5.0)
    assert 'other' not in only(tr)


def test_print_report_header_then_rows():
    out = io.StringIO()
    tr = _FakeTrainer()
    report = extensions.PrintReport(['epoch', 'loss', 'missing'], out=out)
    for loss in (0.5, 0.25):
        tr.step(new_epoch=True, loss=loss)
        report(tr)
    lines = out.getvalue().splitlines()
    assert lines[0].split() == ['epoch', 'loss', 'missing']
    assert [line.split() for line in lines[1:]] == [['1', '0.5'],
                                                    ['2', '0.25']]


class _Updater:
    """Counts iterations; an epoch is 2 of them."""

    def __init__(self, fail_at=None):
        self.iteration = 0
        self.fail_at = fail_at

    def update(self, sync=True):
        self.iteration += 1
        if self.iteration == self.fail_at:
            raise RuntimeError('boom')
        loss = 1.0 / self.iteration
        return {'loss': loss if sync else torch.tensor(loss)}

    @property
    def epoch(self):
        return self.iteration // 2

    @property
    def is_new_epoch(self):
        return self.iteration > 0 and self.iteration % 2 == 0


def test_trainer_priority_order_defaults_and_finalize(tmp_path):
    calls, finalized = [], []

    def ext(name, **attrs):
        def fn(trainer):
            calls.append(name)
            return {name: trainer.updater.iteration}
        fn.finalize = lambda: finalized.append(name)
        for k, v in attrs.items():
            setattr(fn, k, v)
        return fn

    out = tmp_path / 'out'
    trainer = training.Trainer(_Updater(), (2, 'epoch'), out=str(out))
    trainer.extend(ext('low', priority=10), trigger=(1, 'iteration'))
    trainer.extend(ext('high', priority=300), trigger=(1, 'iteration'))
    trainer.extend(ext('epochly'))               # default: (1, 'epoch')
    trainer.extend(ext('mid', trigger=(1, 'iteration')), priority=200)
    trainer.run()
    assert out.is_dir()
    assert calls == ['high', 'mid', 'low', 'high', 'mid', 'epochly', 'low',
                     'high', 'mid', 'low', 'high', 'mid', 'epochly', 'low']
    assert trainer.observation['epochly'] == 4
    assert sorted(finalized) == ['epochly', 'high', 'low', 'mid']
    # a raising run still finalizes every extension
    finalized.clear()
    failing = training.Trainer(_Updater(fail_at=3), (9, 'epoch'),
                               out=str(out))
    failing.extend(ext('a', trigger=(1, 'iteration')))
    with pytest.raises(RuntimeError, match='boom'):
        failing.run()
    assert finalized == ['a']
    # stop(reason) ends the run at the iteration boundary
    stopper = training.Trainer(_Updater(), (9, 'epoch'), out=None)
    stopper.extend(lambda tr: tr.stop('enough'), trigger=(3, 'iteration'))
    stopper.run()
    assert stopper.updater.iteration == 3
    assert stopper.stop_reason == 'enough'
    # async_metrics: the observation holds the updater's 0-d tensors,
    # and the loop reads one every sync_interval iterations
    reads = []
    quiet = training.Trainer(_Updater(), (2, 'epoch'), out=None,
                             async_metrics=True, sync_interval=3)
    quiet.extend(lambda tr: reads.append(torch.is_tensor(
        tr.observation['loss'])), trigger=(1, 'iteration'))
    quiet.run()
    assert reads == [True] * 4 and quiet.sync_interval == 3
    assert float(quiet.observation['loss']) == 0.25


def _mlp_updater(n=8, lr=0.1):
    comm = cmt.create_communicator('naive', device='cpu')
    model = models.MLP(n_units=16, device='cpu')
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), lr, 0.9), comm)
    rng = np.random.RandomState(0)
    data = [(rng.randn(784).astype(np.float32), np.int32(i % 10))
            for i in range(n)]
    return training.StandardUpdater(
        training.SerialIterator(data, 4, shuffle=False), opt,
        models.Classifier(model), model, comm)


def test_nan_guard_raises_with_a_forensic_snapshot(tmp_path):
    up = _mlp_updater()
    trainer = training.Trainer(up, (4, 'iteration'), out=str(tmp_path))
    guard = utils.NanGuard(param_interval=1, checkpoint_on_divergence=True)
    trainer.extend(guard)
    trainer.run()                    # healthy: nothing raised
    assert guard.divergence_checkpoint is None
    with torch.no_grad():
        up.model.Dense_1.bias[3] = float('nan')
    trainer = training.Trainer(up, (6, 'iteration'), out=str(tmp_path))
    trainer.extend(guard)
    with pytest.raises(utils.DivergenceError, match='loss'):
        trainer.run()
    forensic = json.loads(
        (tmp_path / 'divergence' / 'divergence.json').read_text())
    assert forensic['iteration'] == 5 and 'loss' in forensic['bad']
    state, manifest = serializers.read_npz(guard.divergence_checkpoint)
    assert manifest['complete']
    assert np.isnan(state['params/Dense_1/bias'][3])
    assert 'params/Dense_1/bias' in utils.check_finite(up.params, 'params/')
    tree = {'a': np.ones(2), 'i': np.arange(3), 'b': {'c': torch.ones(2)}}
    assert utils.check_finite(tree) == []
    tree['b']['c'][1] = float('inf')
    assert utils.check_finite(tree, 'x/') == ['x/b/c']


# ---------------------------------------------------------------------
# npz snapshots

def _tree():
    rng = np.random.RandomState(5)
    return {'w': rng.randn(3, 4).astype(np.float32),
            'nested': {'i': np.arange(5, dtype=np.int32), 'n': 7,
                       'f': 0.25},
            'flag': np.bool_(True)}


def test_port_npz_is_read_by_the_jax_package(tmp_path):
    tree = _tree()
    half = torch.randn(6, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    tree['half'] = half
    path = serializers.save_npz(str(tmp_path / 'p'), tree)
    assert path.endswith('.npz') and not os.path.exists(path + '.tmp')
    by_key, manifest = jserializers.read_npz(path)   # crc-checked
    assert manifest['complete'] and manifest['world_size'] == 1
    assert sorted(manifest['leaves']) == sorted(by_key)
    np.testing.assert_array_equal(by_key['w'], tree['w'])
    np.testing.assert_array_equal(by_key['nested/i'], tree['nested']['i'])
    assert int(by_key['nested/n']) == 7 and float(by_key['nested/f']) == .25
    assert by_key['half'].dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(by_key['half'].astype(np.float32),
                                  half.float().numpy())
    assert jserializers.verify_checkpoint(path)['complete']
    assert serializers.checkpoint_complete(path)
    assert serializers.verify_checkpoint(path)['complete']


def test_jax_npz_is_read_by_the_port(tmp_path):
    tree = _tree()
    tree['half'] = jnp.asarray([1.5, -2.25, 3.0], jnp.bfloat16)
    path = jserializers.save_npz(str(tmp_path / 'j'), tree)
    by_key, manifest = serializers.read_npz(path)
    assert manifest['complete'] and manifest['leaves']['half']['dtype'] \
        == 'bfloat16'
    np.testing.assert_array_equal(by_key['w'], tree['w'])
    assert by_key['half'].dtype == torch.bfloat16
    assert by_key['half'].tolist() == [1.5, -2.25, 3.0]
    loaded = serializers.load_npz(path, {'w': np.zeros((3, 4), np.float32),
                                         'nested': {'n': np.int64(0)}})
    np.testing.assert_array_equal(loaded['w'], tree['w'])
    assert serializers.checkpoint_complete(path)


def _jax_mlp_updater():
    jm = JaxMLP(n_units=16, n_out=10)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(2),
                                       jnp.zeros((1, 784), jnp.float32)))
    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    rng = np.random.RandomState(0)
    data = [(rng.randn(784).astype(np.float32), np.int32(i % 10))
            for i in range(8)]
    up = jtraining.StandardUpdater(
        jtraining.SerialIterator(data, 4, shuffle=False),
        chainermn_tpu.create_multi_node_optimizer(
            optax.sgd(0.1, momentum=0.9), jcomm),
        JaxClassifier(jm.apply), variables, jcomm, has_aux=True)
    return jm, up


class _Holder:
    def __init__(self, updater, out):
        self.updater = updater
        self.out = out


def test_mlp_snapshots_cross_packages(tmp_path):
    x = np.random.RandomState(9).randn(5, 784).astype(np.float32)
    # JAX snapshot -> the port's MLP
    jm, jup = _jax_mlp_updater()
    for _ in range(3):
        jup.update()
    jextensions.snapshot()(_Holder(jup, str(tmp_path)))
    jpath = str(tmp_path / 'snapshot_iter_3.npz')
    model = models.MLP(n_units=16, device='cpu', generator=torch.Generator(
    ).manual_seed(4))
    # the JAX example's updater holds the whole variables dict as its
    # params, so its snapshot nests them once more
    tree = serializers.load_npz(jpath, {'params': {
        'params': models.to_flax_variables(model)['params']}})
    models.load_flax_variables(model, tree['params'])
    want = np.asarray(jm.apply(jax.device_get(jup.params), x))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the port's snapshot -> the JAX MLP
    up = _mlp_updater()
    for _ in range(3):
        up.update()
    trainer = training.Trainer(up, out=str(tmp_path / 'port'))
    os.makedirs(trainer.out)
    extensions.snapshot()(trainer)
    ppath = str(tmp_path / 'port' / 'snapshot_iter_3.npz')
    template = {'params': jax.device_get(jup.params)['params']}
    loaded = jserializers.load_npz(ppath, template)
    with torch.no_grad():
        port_logits = up.model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(np.asarray(jm.apply(loaded, x)),
                               port_logits, rtol=1e-5, atol=1e-6)
    state, manifest = serializers.read_npz(ppath)
    assert int(state['iteration']) == 3 and int(state['epoch']) == 1
    assert float(state['epoch_detail']) == 1.5
    assert bool(state['opt_state/needs_broadcast']) is False
    assert state['opt_state/actual_state/0/velocity'].shape == (16, 784)


def test_resume_restores_the_updater(tmp_path):
    up = _mlp_updater()
    for _ in range(3):
        up.update()
    path = serializers.save_npz(str(tmp_path / 's'),
                                serializers.updater_state(up))
    fresh = _mlp_updater()
    assert fresh.optimizer.needs_broadcast
    info = serializers.resume_updater(path, fresh)
    assert info['iteration'] == 3 and fresh.iteration == 3
    assert fresh.optimizer.needs_broadcast is False
    assert fresh.iterator.epoch_detail == up.iterator.epoch_detail == 1.5
    for p, q in zip(fresh.model.parameters(), up.model.parameters()):
        assert torch.equal(p, q)
    assert fresh.update() == up.update()
    # elastic is the default and a same-topology resume reshards nothing
    again = _mlp_updater()
    info = serializers.resume_updater(path, again, elastic=True)
    assert info['resharded'] is False and info['iteration'] == 3


def test_resume_keeps_layouts_and_batch_statistics(tmp_path):
    """A ResNet's channels_last conv weights: each restored velocity has
    its parameter's layout, and the BatchNorm statistics come back."""
    def updater():
        comm = cmt.create_communicator('xla', device='cpu')
        model = models.ResNet(stage_sizes=[1], width=4, num_classes=10,
                              dtype=torch.float32, device='cpu')
        opt = cmt.create_multi_node_optimizer(
            ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
        rng = np.random.RandomState(1)
        data = [(rng.randn(16, 16, 3).astype(np.float32), np.int32(i))
                for i in range(4)]
        return training.StandardUpdater(
            training.SerialIterator(data, 2, shuffle=False), opt,
            models.StatefulClassifier(model).loss, model, comm)

    up = updater()
    for _ in range(3):
        up.update()
    state = serializers.updater_state(up)
    assert 'batch_stats' in state['model_state']
    path = serializers.save_npz(str(tmp_path / 'r'), state)
    fresh = updater()
    serializers.resume_updater(path, fresh)
    opt = fresh.optimizer.actual_optimizer
    for p, q in zip(fresh.model.parameters(), up.model.parameters()):
        v = opt.state[p]['velocity']
        assert v.stride() == p.stride() and torch.equal(
            v, up.optimizer.state[q]['velocity'])
    for a, b in zip(fresh.model.buffers(), up.model.buffers()):
        assert torch.equal(a, b)
    assert fresh.update() == up.update()


def _rezip(src, dst, edit):
    """Copy an npz with ``edit(name, array) -> array or None`` (None
    drops the entry), zip CRCs recomputed: damage that only the
    manifest can see."""
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    out = {}
    for k, v in arrays.items():
        v = edit(k, v)
        if v is not None:
            out[k] = v
    np.savez(dst, **out)
    return dst


def test_torn_or_corrupt_snapshots_raise_typed_errors(tmp_path):
    up = _mlp_updater()
    up.update()
    path = serializers.save_npz(str(tmp_path / 's'),
                                serializers.updater_state(up))
    blob = open(path, 'rb').read()
    torn = tmp_path / 'torn.npz'
    torn.write_bytes(blob[:len(blob) // 2])
    with pytest.raises(CheckpointCorruptError) as err:
        serializers.read_npz(str(torn))
    assert err.value.kind == 'unreadable'
    assert not serializers.checkpoint_complete(str(torn))
    empty = tmp_path / 'empty.npz'
    empty.write_bytes(b'')
    with pytest.raises(CheckpointCorruptError):
        serializers.resume_updater(str(empty), up)
    flipped = tmp_path / 'flipped.npz'
    flipped.write_bytes(blob[:len(blob) // 3] + bytes(
        [blob[len(blob) // 3] ^ 0xFF]) + blob[len(blob) // 3 + 1:])
    with pytest.raises(CheckpointCorruptError):
        serializers.read_npz(str(flipped))

    def flip(name, value):
        if name == 'params/Dense_1/kernel':
            value = value.copy()
            value.view(np.uint32)[2, 3] ^= 1
        return value

    rot = _rezip(path, str(tmp_path / 'rot.npz'), flip)
    with pytest.raises(CheckpointCorruptError) as err:
        serializers.read_npz(rot)
    assert (err.value.kind, err.value.leaf) == ('crc',
                                                'params/Dense_1/kernel')
    assert 'params/Dense_1/kernel' in str(err.value)
    with pytest.raises(CheckpointCorruptError) as err:
        serializers.resume_updater(rot, _mlp_updater())
    assert err.value.leaf == 'params/Dense_1/kernel'
    dropped = _rezip(path, str(tmp_path / 'drop.npz'),
                     lambda k, v: None if k == 'params/Dense_0/bias' else v)
    with pytest.raises(CheckpointCorruptError) as err:
        serializers.read_npz(dropped)
    assert (err.value.kind, err.value.leaf) == ('missing',
                                                'params/Dense_0/bias')
    no_manifest = _rezip(path, str(tmp_path / 'legacy.npz'), lambda k, v:
                         None if k == serializers.MANIFEST_KEY else v)
    assert not serializers.checkpoint_complete(no_manifest)
    with pytest.raises(CheckpointCorruptError) as err:
        serializers.verify_checkpoint(no_manifest)
    assert err.value.kind == 'incomplete'
    with pytest.raises(CheckpointCorruptError) as err:
        serializers.load_npz(path, {'params': {'Dense_2': {
            'bias': np.zeros(11, np.float32)}}})
    assert (err.value.kind, err.value.leaf) == ('shape',
                                                'params/Dense_2/bias')
    wider = training.StandardUpdater(
        up.iterator, up.optimizer, up.loss_fn,
        models.MLP(n_units=17, device='cpu'), up.comm)
    with pytest.raises(CheckpointCorruptError) as err:
        serializers.resume_updater(path, wider)
    assert err.value.kind == 'shape'
    with zipfile.ZipFile(path) as z:   # the container is a plain npz
        assert 'params/Dense_0/kernel.npy' in z.namelist()
