"""The port's batch input pipeline, its updater spans and the
space-to-depth stem against the JAX package.

``BatchAugmentPipeline`` bit for bit against the JAX one (its native and
its numpy route) for float32 and uint8 stores; ``PipelineIterator``'s
index streams, top-up and ``restore_position``; the dataset helpers; the
updater's ``host_batch_prep`` / ``h2d`` / ``jitted_step`` /
``metrics_sync`` spans against a JAX run; the overlap arithmetic and the
log reader; the ImageNet twin under ``--pipeline native``; and
``resnet50_s2d`` on weights from ``convert_stem_variables``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu import dataset as jdataset
from chainermn_tpu import models as jmodels
from chainermn_tpu import native as jnative
from chainermn_tpu import telemetry as jtelemetry
from chainermn_tpu import training as jtraining
from chainermn_tpu.datasets import imagenet as jimagenet
from chainermn_tpu.models import resnet50 as jresnet50
from chainermn_tpu.telemetry import report as jreport
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import dataset, models, telemetry, training
from chainermn_tpu_torch.datasets import imagenet
from chainermn_tpu_torch.examples.imagenet import train_imagenet
from chainermn_tpu_torch.telemetry import report

torch.set_num_threads(4)


class _Raw:
    """``(image, label)`` items of a seeded store in ``dtype``."""

    def __init__(self, n, size, dtype, seed=0):
        rng = np.random.RandomState(seed)
        self.images = (rng.rand(n, size, size, 3) * 255).astype(dtype)
        self.labels = rng.randint(0, 10, n).astype(np.int32)

    def __len__(self):
        return len(self.images)

    def __getitem__(self, i):
        return self.images[i], self.labels[i]


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint32)


@pytest.mark.parametrize('dtype', [np.float32, np.uint8])
@pytest.mark.parametrize('random', [True, False])
@pytest.mark.parametrize('with_mean', [True, False])
def test_batch_augment_pipeline_bit_equal_to_jax(monkeypatch, dtype, random,
                                                 with_mean):
    """Four batches of the port's pipeline and of the JAX one (native,
    then with its native core off, its numpy loop) from the same seed:
    the same images bit for bit and the same labels."""
    raw = _Raw(12, 20, dtype)
    mean = jimagenet.compute_mean(raw, limit=12) if with_mean else None
    kw = dict(mean=mean, random=random, seed=5)
    ours = imagenet.BatchAugmentPipeline(raw, 16, **kw)
    assert ours._store.dtype == np.dtype(dtype)
    jax_native = jimagenet.BatchAugmentPipeline(raw, 16, **kw)
    jax_numpy = jimagenet.BatchAugmentPipeline(raw, 16, **kw)
    order = np.random.RandomState(1).permutation(12)
    for b in range(4):
        idx = np.concatenate([order, order])[b * 5:b * 5 + 5]
        got = ours.batch(idx)
        want = jax_native.batch(idx)
        monkeypatch.setattr(jnative, 'available', False)
        plain = jax_numpy.batch(idx)
        monkeypatch.setattr(jnative, 'available', True)
        assert got[0].shape == (5, 16, 16, 3) and got[0].dtype == np.float32
        for w in (want, plain):
            np.testing.assert_array_equal(_bits(got[0]), _bits(w[0]))
            np.testing.assert_array_equal(got[1], w[1])
    assert len(ours) == 12
    with pytest.raises(ValueError):
        ours.batch([0, 12])
    with pytest.raises(ValueError):
        ours.batch([-1])


def test_augment_ref_is_the_pipelines_plain_version():
    raw = _Raw(6, 12, np.uint8, seed=3)
    pipe = imagenet.BatchAugmentPipeline(raw, 8, mean=None, seed=2)
    rng = np.random.RandomState(2)
    idx = np.array([5, 0, 3])
    tops = rng.randint(0, 5, 3).astype(np.int32)
    lefts = rng.randint(0, 5, 3).astype(np.int32)
    flips = (rng.rand(3) > 0.5).astype(np.uint8)
    images, _ = pipe.batch(idx)
    np.testing.assert_array_equal(
        _bits(images), _bits(imagenet._augment_ref(
            raw.images, idx, tops, lefts, flips, 8)))


class _Recorder:
    """A pipeline whose batches are its index arrays."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def batch(self, indices):
        return (indices.copy(), indices * 0)


@pytest.mark.parametrize('n,bs,shuffle,repeat', [
    (10, 4, True, True), (10, 4, False, True), (9, 3, True, True),
    (7, 4, True, False), (3, 5, True, True)])
def test_pipeline_iterator_equal_jax(n, bs, shuffle, repeat):
    ours = training.PipelineIterator(_Recorder(n), bs, repeat=repeat,
                                     shuffle=shuffle, seed=4)
    theirs = jtraining.PipelineIterator(_Recorder(n), bs, repeat=repeat,
                                        shuffle=shuffle, seed=4)
    for _ in range(9):
        try:
            want = next(theirs)
        except StopIteration:
            with pytest.raises(StopIteration):
                next(ours)
            break
        got = next(ours)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.int64
        if repeat and n >= bs:
            assert len(got[0]) == bs   # topped up
        assert (ours.epoch, ours.iteration, ours.is_new_epoch,
                ours.epoch_detail) == (theirs.epoch, theirs.iteration,
                                       theirs.is_new_epoch,
                                       theirs.epoch_detail)


def test_pipeline_iterator_restore_equal_jax():
    ours = training.PipelineIterator(_Recorder(10), 4, seed=7)
    theirs = jtraining.PipelineIterator(_Recorder(10), 4, seed=7)
    for detail in (1.3, 0.0, 2.75):
        ours.restore_position(detail)
        theirs.restore_position(detail)
        assert (ours.epoch, ours._pos) == (theirs.epoch, theirs._pos)
        for _ in range(3):
            np.testing.assert_array_equal(next(ours)[0], next(theirs)[0])
    ours.restore_epoch(5)
    theirs.restore_epoch(5)
    assert ours.epoch == theirs.epoch == 5
    ours.reset()
    assert (ours.epoch, ours.iteration, ours.epoch_detail) == (0, 0, 0.0)
    with pytest.raises(StopIteration):
        next(training.PipelineIterator(_Recorder(0), 4))


def test_restore_epoch_on_every_iterator():
    si = training.SerialIterator(list(range(10)), 3)
    si.restore_epoch(4)
    assert si.epoch == 4
    mi = training.MultiprocessIterator(list(range(10)), 3, n_prefetch=2)
    try:
        next(mi)
        mi.restore_epoch(2)
        assert (mi.epoch, mi.epoch_detail) == (2, 2.0)
        next(mi)
        assert mi.epoch >= 2
    finally:
        mi.finalize()
    it = training.DevicePrefetchIterator(
        training.PipelineIterator(_Recorder(10), 4), lambda b: b,
        device='cpu')
    try:
        it.restore_epoch(3)
        assert (it.epoch, it.epoch_detail) == (3, 3.0)
        it.restore_position(1.5)
        assert it.epoch == 1 and it.epoch_detail == 1.5
    finally:
        it.finalize()


# ---------------------------------------------------------------------
# dataset helpers

def test_epoch_position_and_triggers_equal_jax():
    for detail in (0.0, 0.49, 1.5, 2.999, 7.25):
        for n in (0, 1, 10, 23):
            assert dataset.epoch_position(detail, n) == \
                jdataset.epoch_position(detail, n)
    with pytest.raises(ValueError):
        dataset.epoch_position(1.0, -1)
    data = list(range(103))

    class _Comm:
        size = 4

    for kw in (dict(size=3), dict(comm=_Comm()), {}):
        assert dataset.get_n_iterations_for_one_epoch(data, 8, **kw) == \
            jdataset.get_n_iterations_for_one_epoch(data, 8, **kw)
        assert dataset.get_epoch_trigger(3, data, 8, **kw) == \
            jdataset.get_epoch_trigger(3, data, 8, **kw)
    assert dataset.get_epoch_trigger(2, data, 10, size=2) == \
        (12, 'iteration')


# ---------------------------------------------------------------------
# the updater's spans

_STEP_SPANS = ('host_batch_prep', 'h2d', 'jitted_step', 'metrics_sync')


def _step_spans(records):
    return [(r['name'], r['kind'], r['iteration']) for r in records
            if r.get('type') == 'span' and r.get('name') in _STEP_SPANS
            and 'iteration' in r]


def _mlp_data(n=12):
    rng = np.random.RandomState(0)
    return [(rng.randn(12).astype(np.float32), np.int32(rng.randint(3)))
            for _ in range(n)]


def test_updater_spans_equal_jax():
    """Three ``update()`` calls: the port records the JAX updater's four
    spans, kinds and ``iteration`` tags in the JAX order; under
    ``update(sync=False)`` there is no ``metrics_sync``; with telemetry
    off nothing is recorded."""
    data = _mlp_data()
    jmodel = jmodels.MLP(8, 3)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 12)))
    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jup = jtraining.StandardUpdater(
        jtraining.SerialIterator(data, 4, shuffle=False),
        chainermn_tpu.create_multi_node_optimizer(optax.sgd(0.1), jcomm),
        jmodels.Classifier(jmodel.apply), variables, jcomm, has_aux=True)
    jtelemetry.disable()
    jrec = jtelemetry.enable()
    try:
        for _ in range(3):
            jup.update()
    finally:
        jtelemetry.disable()
    want = _step_spans(jrec.events)

    comm = cmt.create_communicator('xla', device='cpu')
    try:
        model = models.MLP(8, 3, device='cpu', n_in=12)
        up = training.StandardUpdater(
            training.SerialIterator(data, 4, shuffle=False),
            cmt.create_multi_node_optimizer(
                torch.optim.SGD(model.parameters(), 0.1), comm),
            models.Classifier(model).loss, model, comm)
        telemetry.disable()
        up.update()   # off: nothing recorded, nothing fenced
        rec = telemetry.enable(sync_fences=True)
        try:
            up.iteration = 0
            for _ in range(3):
                up.update()
            up.update(sync=False)
        finally:
            telemetry.disable()
    finally:
        comm.close()
    got = _step_spans(rec.events)
    assert got[:12] == want == [
        (name, kind, i) for i in range(3)
        for name, kind in (('host_batch_prep', 'host'), ('h2d', 'h2d'),
                           ('jitted_step', 'compute'),
                           ('metrics_sync', 'host'))]
    assert got[12:] == [('host_batch_prep', 'host', 3), ('h2d', 'h2d', 3),
                        ('jitted_step', 'compute', 3)]
    assert not any(r.get('synced') for r in rec.events)   # CPU tensors
    assert all(r['t1'] >= r['t0'] for r in rec.events
               if r.get('type') == 'span')


def test_updater_spans_under_device_prefetch_and_the_env(monkeypatch,
                                                         tmp_path):
    """Under ``device_prefetch`` the batch spans come from the prefetch
    thread; ``CHAINERMN_TPU_TELEMETRY`` enables a session when the
    updater is built, and its log reads back with ``load_rank_logs``."""
    telemetry.disable()
    monkeypatch.setenv(telemetry.ENV_VAR, str(tmp_path))
    monkeypatch.setenv(telemetry.ENV_SYNC, '1')
    comm = cmt.create_communicator('xla', device='cpu')
    try:
        model = models.MLP(8, 3, device='cpu', n_in=12)
        up = training.StandardUpdater(
            training.SerialIterator(_mlp_data(), 4, shuffle=False),
            cmt.create_multi_node_optimizer(
                torch.optim.SGD(model.parameters(), 0.1), comm),
            models.Classifier(model).loss, model, comm, device_prefetch=2)
        rec = telemetry.active()
        assert rec is not None and rec.sync_fences
        assert rec.outdir == str(tmp_path)
        for _ in range(3):
            up.update()
        up.iterator.finalize()
        telemetry.flush()
    finally:
        comm.close()
        telemetry.disable()
    metas, spans, events, bad = report.load_rank_logs(str(tmp_path))
    assert (metas[0]['sync_fences'], bad, events) == (True, 0, [])
    jmetas, jspans, _, _ = jreport.load_rank_logs(str(tmp_path))
    assert jspans == spans and jmetas == metas
    names = [s['name'] for s in spans]
    assert names.count('jitted_step') == 3
    assert names.count('metrics_sync') == 3
    assert names.count('host_batch_prep') == names.count('h2d') >= 3
    with open(tmp_path / 'events-rank0.jsonl', 'a') as f:
        f.write('{torn\n')
    assert report.load_rank_logs(str(tmp_path))[3] == 1
    monkeypatch.delenv(telemetry.ENV_VAR)
    assert telemetry.maybe_enable_from_env() is None   # unset
    telemetry.disable()


def test_overlap_from_intervals_equal_jax():
    rng = np.random.RandomState(3)
    for _ in range(20):
        a = [tuple(sorted(rng.rand(2) * 10)) for _ in range(rng.randint(6))]
        b = [tuple(sorted(rng.rand(2) * 10)) for _ in range(rng.randint(6))]
        got = report.overlap_from_intervals(a, b)
        assert got == jreport.overlap_from_intervals(a, b)
        assert report.merge_intervals(b) == jreport.merge_intervals(b)
    assert report.overlap_from_intervals([], [(0, 1)])[
        'overlap_fraction'] is None
    st = report.overlap_from_intervals([(0, 2), (1, 3)], [(0, 1.5)])
    assert st['total_collective_s'] == 3 and st['overlap_fraction'] == 0.5
    assert report.STEP_PHASES == jreport.STEP_PHASES


# ---------------------------------------------------------------------
# the ImageNet twin on the native pipeline

def test_imagenet_twin_native_pipeline(tmp_path):
    """``--pipeline native --cpu --quick`` (NIN, the cheapest arch on
    the CPU): a ``BatchAugmentPipeline`` over the shard read by a
    ``PipelineIterator`` under the updater's device prefetch, two
    iterations of 256, finite losses."""
    trainer = train_imagenet.main([
        '--cpu', '--quick', '--pipeline', 'native', '--dtype', 'float32',
        '--arch', 'nin', '--batchsize', '256', '--out',
        str(tmp_path / 'out')])
    try:
        it = trainer.updater.iterator
        assert isinstance(it, training.DevicePrefetchIterator)
        assert isinstance(it.inner, training.PipelineIterator)
        assert isinstance(it.inner.pipeline, imagenet.BatchAugmentPipeline)
        assert trainer.updater.iteration == 2 and it.epoch == 1
        assert np.isfinite(float(trainer.observation['loss']))
        assert 0.0 <= float(
            trainer.observation['validation/main/accuracy']) <= 1.0
    finally:
        train_imagenet.close(trainer)


# ---------------------------------------------------------------------
# the space-to-depth stem

def test_resnet50_s2d_against_jax_and_the_standard_stem():
    """At width 8, two stages of one block, 32 px, f32: the flax standard-stem
    weights in both packages; ``convert_stem_variables`` equal in both;
    the port's s2d model against the JAX s2d model and against the port's
    standard stem (rtol 1e-5), train and eval."""
    kw = dict(stage_sizes=[1, 1], width=8, num_classes=10)
    jstd = jresnet50.ResNet(dtype=jnp.float32, **kw)
    js2d = jresnet50.ResNet(dtype=jnp.float32, stem='space_to_depth', **kw)
    x = np.random.RandomState(0).rand(4, 32, 32, 3).astype(np.float32)
    variables = jax.device_get(jstd.init(
        {'params': jax.random.PRNGKey(1)}, jnp.asarray(x), train=False))
    jconv = jax.device_get(jresnet50.convert_stem_variables(variables))
    conv = models.convert_stem_variables(variables)
    np.testing.assert_array_equal(
        conv['params']['conv_init_s2d']['kernel'],
        jconv['params']['conv_init_s2d']['kernel'])
    assert 'conv_init' not in conv['params']
    assert conv['batch_stats'] is variables['batch_stats']

    std = models.ResNet(dtype=torch.float32, device='cpu', **kw)
    s2d = models.ResNet(dtype=torch.float32, device='cpu',
                        stem='space_to_depth', **kw)
    models.load_flax_variables(std, variables)
    models.load_flax_variables(
        s2d, models.convert_stem_variables(models.to_flax_variables(std)))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        std.eval()
        s2d.eval()
        got, ref = s2d(xt).numpy(), std(xt).numpy()
        want = np.asarray(js2d.apply(jconv, jnp.asarray(x), train=False))
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        std.train()
        s2d.train()
        np.testing.assert_allclose(s2d(xt).numpy(), std(xt).numpy(),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match='even'):
        s2d(torch.zeros(1, 33, 33, 3))
    with torch.device('meta'):
        big = models.get_arch('resnet50_s2d', device='meta')
    assert tuple(big.conv_init_s2d.weight.shape) == (64, 12, 4, 4)
    # every one of the 49 taps lands once
    assert models.s2d_stem_kernel(np.ones((7, 7, 3, 2))).sum() == 49 * 6
