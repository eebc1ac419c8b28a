"""The port's record shards and streaming loader against the JAX package.

``chainermn_tpu_torch.data`` reads the shards ``chainermn_tpu.data``
writes and the reverse (``np.savez`` stamps each zip member with the wall
time, so the formats are held by cross-reading, not by bytes); the
typed failures; the loader's id streams, batches and cursor, bit for bit
against the JAX loader on the same shards, seed and ``(size, rank)``;
the cursor through ``serializers`` and through ``DevicePrefetchIterator``.
"""

import json
import os

import numpy as np
import pytest
import torch

from chainermn_tpu import data as jdata
from chainermn_tpu import serializers as jserializers
from chainermn_tpu.training import iterators as jiterators
from chainermn_tpu_torch import data, serializers, telemetry, training
from chainermn_tpu_torch.utils import failure

torch.set_num_threads(2)


def _examples(n, dim=4, seed=0):
    rs = np.random.RandomState(seed)
    return [(rs.randn(dim, 3).astype(np.float32),
             np.int32(rs.randint(3))) for _ in range(n)]


@pytest.fixture
def shard_paths(tmp_path):
    return data.write_examples(_examples(23), str(tmp_path / 'shards'),
                               n_shards=4)


def _drain(loader, n):
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.finalize()


def _same_batches(a, b):
    assert len(a) == len(b)
    for ba, bb in zip(a, b):
        assert len(ba) == len(bb)
        for ea, eb in zip(ba, bb):
            assert len(ea) == len(eb)
            for xa, xb in zip(ea, eb):
                assert xa.dtype == xb.dtype
                np.testing.assert_array_equal(xa, xb)


# ---------------------------------------------------------------------
# the format, both ways

@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_shards_cross_read(tmp_path, writer):
    """Each package reads the other's shards: the sidecars, the payload
    bytes record by record, and the decoded examples agree."""
    examples = _examples(11, seed=4)
    write = (jdata.write_examples if writer == 'jax'
             else data.write_examples)
    paths = write(examples, str(tmp_path), n_shards=3)
    other = (data.write_examples if writer == 'jax'
             else jdata.write_examples)(examples, str(tmp_path / 'o'),
                                        n_shards=3)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in other]
    ours, theirs = data.ShardSet(paths), jdata.ShardSet(paths)
    try:
        assert len(ours) == len(theirs) == 11
        assert ours.lengths == theirs.lengths == [3, 4, 4]
        for p, q in zip(paths, other):
            a, b = data.read_index(p), jdata.read_index(q)
            assert a['n_records'] == b['n_records']
            assert a['complete'] is b['complete'] is True
            assert a['magic'] == b['magic'] == 'CMNSHRD1'
        for g in range(11):
            assert ours.locate(g) == theirs.locate(g)
            payload = ours.read(g)
            assert payload == theirs.read(g)
            got = data.decode_example(payload)
            want = jdata.decode_example(payload)
            for x, y, z in zip(got, want, examples[g]):
                np.testing.assert_array_equal(x, y)
                np.testing.assert_array_equal(x, z)
    finally:
        ours.close()
        theirs.close()


def test_example_codec_against_jax():
    ex = (np.arange(6, dtype=np.float32).reshape(2, 3), np.int32(7))
    for blob in (data.encode_example(ex), jdata.encode_example(ex)):
        for dec in (data.decode_example, jdata.decode_example):
            back = dec(blob)
            np.testing.assert_array_equal(back[0], ex[0])
            assert int(back[1]) == 7 and back[1].dtype == np.int32
    single = data.decode_example(data.encode_example(np.ones(3)))
    assert len(single) == 1


def test_raw_records_and_index_path(tmp_path):
    path = str(tmp_path / 'a.rec')
    payloads = [b'alpha', b'bee', b'', b'x' * 1000]
    with data.ShardWriter(path) as w:
        for p in payloads:
            w.append(p)
    assert data.index_path(path) == jdata.recordio.index_path(path)
    assert data.read_index(path) == jdata.read_index(path)
    r = data.ShardReader(path)
    assert [r.read(i) for i in range(4)] == payloads
    with pytest.raises(IndexError):
        r.read(4)
    r.close()


# ---------------------------------------------------------------------
# typed failures

def test_abandoned_writer_commits_nothing(tmp_path):
    path = str(tmp_path / 'b.rec')
    with pytest.raises(RuntimeError):
        with data.ShardWriter(path) as w:
            w.append(b'partial')
            raise RuntimeError('crash mid-write')
    assert not os.path.exists(path)
    assert not os.path.exists(path + '.idx')
    assert not os.path.exists(path + '.tmp')


def test_missing_sidecar_typed(shard_paths):
    os.remove(shard_paths[0] + '.idx')
    with pytest.raises(failure.DataCorruptError) as ei:
        data.ShardReader(shard_paths[0])
    assert ei.value.kind == 'unreadable'
    assert ei.value.shard == shard_paths[0]
    assert ei.value.status_name == 'CMN_DATA_CORRUPT'
    with pytest.raises(failure.DataCorruptError):
        data.ShardSet.from_dir(os.path.dirname(shard_paths[0]),
                               pattern='*.none')


@pytest.mark.parametrize('reader', ['jax', 'port'])
def test_flipped_byte_typed_crc(tmp_path, reader):
    path = str(tmp_path / 'c.rec')
    with data.ShardWriter(path) as w:
        w.append(b'payload-bytes-here')
    blob = bytearray(open(path, 'rb').read())
    blob[-3] ^= 0xFF
    with open(path, 'wb') as f:
        f.write(bytes(blob))
    mod = jdata if reader == 'jax' else data
    err = (jdata.recordio.failure.DataCorruptError if reader == 'jax'
           else failure.DataCorruptError)
    r = mod.ShardReader(path)
    with pytest.raises(err) as ei:
        r.read(0)
    assert (ei.value.kind, ei.value.record, ei.value.offset) == \
        ('crc', 0, 8)
    r.close()


def test_truncated_typed(shard_paths):
    path = shard_paths[1]
    with open(path, 'r+b') as f:
        f.truncate(os.path.getsize(path) - 10)
    r = data.ShardReader(path)
    with pytest.raises(failure.DataCorruptError) as ei:
        for i in range(len(r)):
            r.read(i)
    assert ei.value.kind == 'truncated' and ei.value.shard == path
    r.close()
    with open(path, 'wb') as f:   # not even the magic
        f.write(b'CMN')
    with pytest.raises(failure.DataCorruptError) as ei:
        data.ShardReader(path)
    assert ei.value.kind == 'truncated' and ei.value.offset == 0


def test_shardset_global_ids_with_a_zero_length_shard(tmp_path):
    # 2 examples over 3 shards: the balanced split leaves shard 0 empty
    paths = data.write_examples(_examples(2), str(tmp_path), n_shards=3)
    ours, theirs = data.ShardSet(paths), jdata.ShardSet(paths)
    assert ours.lengths == theirs.lengths and 0 in ours.lengths
    assert [ours.locate(g) for g in range(2)] == \
        [theirs.locate(g) for g in range(2)]
    for g in range(2):
        np.testing.assert_array_equal(
            data.decode_example(ours.read(g))[0], _examples(2)[g][0])
    with pytest.raises(IndexError):
        ours.read(2)
    from_dir = data.ShardSet.from_dir(str(tmp_path))
    assert from_dir.paths == sorted(paths)
    for s in (ours, theirs, from_dir):
        s.close()


# ---------------------------------------------------------------------
# the stream

@pytest.mark.parametrize('seed,epoch,shuffle', [
    (0, 0, True), (3, 1, True), (3, 2, True), (7, 5, False)])
def test_stream_order_and_epoch_stream_equal_jax(seed, epoch, shuffle):
    for n in (0, 1, 23, 100):
        np.testing.assert_array_equal(
            data.stream_order(n, seed, epoch, shuffle),
            jdata.stream_order(n, seed, epoch, shuffle))
        for bs, drop in ((8, False), (8, True), (5, False)):
            got = data.epoch_stream(n, seed, bs, epoch, shuffle, drop)
            want = jdata.epoch_stream(n, seed, bs, epoch, shuffle, drop)
            assert [g.tolist() for g in got] == [w.tolist() for w in want]
    with pytest.raises(ValueError):
        data.stream_order(-1, 0, 0)


@pytest.mark.parametrize('size,rank', [(1, 0), (2, 0), (2, 1), (3, 2)])
def test_loader_batches_equal_jax(shard_paths, size, rank):
    """Seven batches (past two epoch boundaries) of the port's loader and
    the JAX loader on the same shards, seed and ``(size, rank)``: the
    same examples, ledgers, counters and cursor after each batch."""
    kw = dict(size=size, rank=rank, seed=3, n_workers=2, prefetch=2)
    ours = data.StreamingLoader(data.ShardSet(shard_paths), 8, **kw)
    theirs = jdata.StreamingLoader(jdata.ShardSet(shard_paths), 8, **kw)
    try:
        for _ in range(7):
            _same_batches([next(ours)], [next(theirs)])
            assert ours.state() == theirs.state()
            assert (ours.epoch, ours.iteration, ours.is_new_epoch) == \
                (theirs.epoch, theirs.iteration, theirs.is_new_epoch)
            assert ours.epoch_detail == theirs.epoch_detail
            assert ours.stream_cursor == theirs.stream_cursor
        assert ours.ledger == theirs.ledger
        np.testing.assert_array_equal(ours.remaining_ids(),
                                      theirs.remaining_ids())
    finally:
        ours.finalize()
        theirs.finalize()


def test_loader_default_topology_is_the_world(shard_paths):
    loader = data.StreamingLoader(shard_paths, 8)
    try:
        assert (loader.size, loader.rank) == (1, 0)
    finally:
        loader.finalize()

    class _Comm:
        size, rank = 3, 2

    loader = data.StreamingLoader(os.path.dirname(shard_paths[0]), 8,
                                  comm=_Comm())
    try:
        assert (loader.size, loader.rank) == (3, 2)
        assert len(next(loader)) == 3   # rank 2's slice of 8 over 3
    finally:
        loader.finalize()
    for bad in (dict(batch_size=0), dict(n_workers=0), dict(prefetch=0),
                dict(size=2, rank=2)):
        kw = dict(batch_size=8, size=1, rank=0)
        kw.update(bad)
        with pytest.raises(ValueError):
            data.StreamingLoader(shard_paths, **kw)


def test_n_to_m_cursor_resume_replays_the_remaining_stream(shard_paths):
    """Two global batches at 3 processes, then the cursor restored at 2
    and at 1: what the port's loaders consume is the JAX oracle stream
    exactly, no repeat and no drop, and a JAX loader restored at the same
    cursor yields the same tail."""
    first = [data.StreamingLoader(shard_paths, 8, size=3, rank=r, seed=3)
             for r in range(3)]
    try:
        for _ in range(2):
            for loader in first:
                next(loader)
        state = first[0].state()
        assert state == {'epoch': 0, 'cursor': 16}
        assert all(loader.state() == state for loader in first)
        head = [i for e in range(2) for loader in first
                for i in loader.ledger[e]['ids']]
    finally:
        for loader in first:
            loader.finalize()
    oracle = np.concatenate(jdata.epoch_stream(23, 3, 8)).tolist()
    for m in (2, 1):
        second = [data.StreamingLoader(shard_paths, 8, size=m, rank=r,
                                       seed=3) for r in range(m)]
        jax_tail = jdata.StreamingLoader(jdata.ShardSet(shard_paths), 8,
                                         size=1, rank=0, seed=3)
        try:
            for loader in second:
                loader.restore_cursor(state['epoch'], state['cursor'])
                next(loader)   # the final 7-sample batch
            jax_tail.restore_cursor(state['epoch'], state['cursor'])
            next(jax_tail)
            tail = [i for loader in second for i in loader.ledger[0]['ids']]
            assert head + tail == oracle
            assert tail == jax_tail.ledger[0]['ids']
            assert all(loader.epoch == 1 and loader.is_new_epoch
                       for loader in second)
        finally:
            for loader in second:
                loader.finalize()
            jax_tail.finalize()


def test_restore_position_epoch_and_clamp_equal_jax(shard_paths):
    ours = data.StreamingLoader(shard_paths, 8, size=1, rank=0, seed=3)
    theirs = jdata.StreamingLoader(jdata.ShardSet(shard_paths), 8, size=1,
                                   rank=0, seed=3)
    try:
        for detail in (8 / 23, 1.5, 2.0 + 16 / 23):
            ours.restore_position(detail)
            theirs.restore_position(detail)
            assert ours.state() == theirs.state()
            _same_batches([next(ours)], [next(theirs)])
        ours.restore_epoch(4)
        theirs.restore_epoch(4)
        assert ours.state() == theirs.state() == {'epoch': 4, 'cursor': 0}
        ours.restore_cursor(2, 50)   # past the end: clamps
        assert ours.state() == {'epoch': 2, 'cursor': 23}
        batch = next(ours)
        assert ours.epoch == 3 and len(batch) == 8
        with pytest.raises(ValueError):
            ours.restore_cursor(0, -1)
        ours.reset()
        assert ours.state() == {'epoch': 0, 'cursor': 0}
        assert ours.iteration == 0 and ours.ledger == []
    finally:
        ours.finalize()
        theirs.finalize()


def test_drop_last_and_no_repeat_equal_jax(shard_paths):
    for kw, n in ((dict(drop_last=True), 5), (dict(repeat=False), 3),
                  (dict(repeat=False, drop_last=True), 2)):
        kw = dict(kw, size=2, rank=1, seed=5)
        ours = data.StreamingLoader(shard_paths, 8, **kw)
        theirs = jdata.StreamingLoader(jdata.ShardSet(shard_paths), 8, **kw)
        _same_batches(_drain(ours, n), _drain(theirs, n))
        assert ours.ledger == theirs.ledger
        if not kw.get('repeat', True):
            with pytest.raises(StopIteration):
                next(ours)
            with pytest.raises(StopIteration):
                next(ours)
    loader = data.StreamingLoader(shard_paths, 8, size=1, rank=0,
                                  drop_last=True)
    sizes = [len(b) for b in _drain(loader, 3)]
    assert sizes == [8, 8, 8]
    assert len([i for e in loader.ledger if e['epoch'] == 0
                for i in e['ids']]) == 16
    empty = data.write_examples([], os.path.join(
        os.path.dirname(shard_paths[0]), 'empty'), n_shards=1)
    loader = data.StreamingLoader(empty, 4, size=1, rank=0)
    with pytest.raises(StopIteration):
        next(loader)
    assert loader.epoch_detail == 0.0
    loader.finalize()


def _flip_byte(path, record):
    off = data.read_index(path)['offsets'][record]
    with open(path, 'r+b') as f:
        f.seek(off + 8 + 5)
        byte = f.read(1)
        f.seek(off + 8 + 5)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_corrupt_record_skipped_and_counted_as_jax(shard_paths):
    """A flipped byte in one record: both loaders skip the same id, count
    it, ledger it under ``skipped``, and finish the epoch; the port
    records the ``data_corrupt_skipped`` event and counter."""
    _flip_byte(shard_paths[2], 1)
    bad = int(np.cumsum([0] + data.ShardSet(shard_paths).lengths)[2] + 1)
    telemetry.disable()
    rec = telemetry.enable()
    try:
        ours = data.StreamingLoader(shard_paths, 8, size=1, rank=0, seed=3)
        theirs = jdata.StreamingLoader(jdata.ShardSet(shard_paths), 8,
                                       size=1, rank=0, seed=3)
        got, want = _drain(ours, 3), _drain(theirs, 3)
        _same_batches(got, want)
        assert sum(len(b) for b in got) == 22
        assert ours.corrupt_skipped == theirs.corrupt_skipped == 1
        assert ours.corrupt_ids == theirs.corrupt_ids == [bad]
        assert ours.ledger == theirs.ledger
        assert ours.epoch == 1 and ours.is_new_epoch
        events = [r for r in rec.events
                  if r.get('name') == 'data_corrupt_skipped']
        assert len(events) == 1
        assert events[0]['corruption_kind'] == 'crc'
        assert events[0]['shard'] == shard_paths[2]
        assert events[0]['record'] == 1
        snap = rec.registry.snapshot()
        assert snap['data_corrupt_skipped_total']['value'] == 1.0
    finally:
        telemetry.disable()


def test_spans_gauges_and_ledger_file(shard_paths, tmp_path):
    telemetry.disable()
    rec = telemetry.enable()
    try:
        lpath = str(tmp_path / 'ledger.jsonl')
        loader = data.StreamingLoader(shard_paths, 8, size=1, rank=0,
                                      seed=3, ledger_path=lpath)
        _drain(loader, 2)
        names = set(rec.registry.snapshot())
        assert {'data_queue_depth', 'data_worker_busy_fraction'} <= names
        spans = [r for r in rec.events if r.get('name') == 'data_decode']
        assert [s['iteration'] for s in spans] == [0, 1]
        assert all(s['kind'] == 'data' and s['n'] == 8 for s in spans)
        assert len(loader.depth_samples) == 2
        assert 0.0 <= loader.busy_fraction() <= 1.0
        rows = [json.loads(ln) for ln in open(lpath).read().splitlines()]
        assert rows == loader.ledger
    finally:
        telemetry.disable()


def test_finalize_stops_the_decode_threads(shard_paths):
    loader = data.StreamingLoader(shard_paths, 4, size=1, rank=0,
                                  n_workers=3, prefetch=4)
    next(loader)
    threads = list(loader._pool._threads)
    assert threads
    loader.finalize()
    assert not any(t.is_alive() for t in threads)
    loader.finalize()   # idempotent


# ---------------------------------------------------------------------
# the cursor through the updater and the device prefetcher

class _StubUpdater:
    def __init__(self, iterator):
        self.iteration = 3
        self.iterator = iterator


def test_restore_counters_takes_the_cursor_first(shard_paths):
    """The JAX order: the cursor, then the fraction, then the epoch."""
    for restore in (serializers.restore_counters,
                    jserializers.restore_counters):
        loader = data.StreamingLoader(shard_paths, 8, size=1, rank=0,
                                      seed=3)
        upd = _StubUpdater(loader)
        try:
            restore(upd, 7, epoch=1, epoch_detail=1.0 + 16 / 23,
                    stream_cursor=16)
            assert upd.iteration == 7
            assert loader.state() == {'epoch': 1, 'cursor': 16}
            restore(upd, 8, epoch=2, epoch_detail=2.0 + 8 / 23)
            assert loader.state() == {'epoch': 2, 'cursor': 8}
            restore(upd, 9, epoch=3)
            assert loader.state() == {'epoch': 3, 'cursor': 0}
        finally:
            loader.finalize()
    it = training.SerialIterator(list(range(10)), 2)
    serializers.restore_counters(_StubUpdater(it), 1, epoch=4)
    assert it.epoch == 4


def test_updater_state_and_resume_carry_the_cursor(shard_paths, tmp_path):
    """A snapshot of an updater over a streaming loader (under the
    updater's device prefetch) holds ``stream_cursor``;
    ``resume_updater`` lands a fresh updater's loader there.  An
    iterator without a cursor stores none."""
    from chainermn_tpu_torch import create_communicator, models, ops
    comm = create_communicator('xla', device='cpu')

    def make(iterator):
        model = models.MLP(4, 3, device='cpu', n_in=12)
        clf = models.Classifier(model)
        opt = ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9)
        return training.StandardUpdater(iterator, opt, clf.loss, model,
                                        comm, device_prefetch=2)

    def loader():
        return data.StreamingLoader(shard_paths, 8, size=1, rank=0, seed=3)

    try:
        up = make(loader())
        try:
            for _ in range(4):
                up.update()
            state = serializers.updater_state(up)
            assert state['stream_cursor'] == 8   # 8 + 8 + 7 | 8
            assert state['epoch'] == 1
            path = serializers.save_npz(str(tmp_path / 'snap'), state)
        finally:
            up.iterator.finalize()
        with np.load(path) as z:
            assert int(z['stream_cursor']) == 8
        fresh = make(loader())
        try:
            serializers.resume_updater(path, fresh)
            assert fresh.iteration == 4
            assert fresh.iterator.stream_cursor == 8
            assert fresh.iterator.inner.state() == {'epoch': 1, 'cursor': 8}
            assert fresh.epoch == 1
        finally:
            fresh.iterator.finalize()
        plain = make(training.SerialIterator(_examples(5), 2))
        try:
            assert 'stream_cursor' not in serializers.updater_state(plain)
        finally:
            plain.iterator.finalize()
    finally:
        comm.close()


@pytest.mark.parametrize('package', ['jax', 'port'])
def test_device_prefetch_cursor_is_consumer_side(shard_paths, package):
    """The prefetcher reads ahead; its ``stream_cursor`` counts what
    ``next()`` returned, in both packages alike."""
    loader = data.StreamingLoader(shard_paths, 8, size=1, rank=0, seed=3)
    if package == 'jax':
        it = jiterators.DevicePrefetchIterator(loader, lambda b: b, depth=3)
    else:
        it = training.DevicePrefetchIterator(loader, lambda b: b, depth=3,
                                             device='cpu')
    try:
        assert it.stream_cursor == 0
        next(it)
        assert it.stream_cursor == 8
        it.restore_cursor(0, 0)
        assert it.stream_cursor == 0
        next(it)
        next(it)
        assert it.stream_cursor == 16 and it.epoch == 0
        next(it)
        assert it.stream_cursor == 0 and it.epoch == 1 and it.is_new_epoch
        it.restore_epoch(3)
        assert (it.epoch, it.epoch_detail, it.stream_cursor) == (3, 3.0, 0)
        it.restore_position(2 + 8 / 23)
        assert it.stream_cursor == 8 and it.epoch == 2
    finally:
        it.finalize()
    assert it._thread.join(5) is None and not it._thread.is_alive()


def test_device_prefetch_without_a_cursor(shard_paths):
    it = training.DevicePrefetchIterator(
        training.SerialIterator(list(range(10)), 4), lambda b: b,
        device='cpu')
    try:
        assert it.stream_cursor is None
        next(it)
        assert it.stream_cursor is None
        it.restore_cursor(2, 5)   # no cursor inside: the epoch's start
        assert it.epoch == 2 and it.epoch_detail == 2.0
    finally:
        it.finalize()
