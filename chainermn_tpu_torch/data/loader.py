"""Sharded streaming loader with a deterministic elastic-resume cursor.

Counterpart of ``chainermn_tpu/data/loader.py``.  The determinism
contract: **the global sample stream is a function of ``(seed, epoch)``
alone, never of the topology.**  Epoch ``e``'s stream is
:func:`stream_order`, a seeded permutation of the shard set's global ids,
consumed in GLOBAL batches of a fixed ``batch_size``; a process at
``(rank, size)`` takes the :func:`~chainermn_tpu_torch.dataset.scatter_index`
slice of each global batch.  Because neither the stream nor its batch
boundaries mention the topology, a run checkpointed at N processes and
resumed at M replays the exact remaining global sequence.

The resume contract is the **stream cursor**: the number of samples of
the current epoch consumed globally.  ``(epoch, cursor)`` rides
``serializers.updater_state`` (``stream_cursor`` beside ``epoch_detail``)
and :meth:`StreamingLoader.restore_cursor` needs no arithmetic for N->M.
``restore_position`` (the fractional ``epoch_detail`` shared with the
other iterators) is kept for snapshots without a cursor.

Decode runs on a thread pool (payloads are numpy, whose work releases the
interpreter lock), with the reads of up to ``prefetch`` future batches
submitted ahead of consumption; wrap the loader in
:class:`~chainermn_tpu_torch.training.DevicePrefetchIterator` (or pass
``StandardUpdater(device_prefetch=N)``) and the collation and the
host-to-device copy run ahead too.  Its telemetry: the ``data_decode``
span (``kind='data'``) around each batch's wait, the
``data_queue_depth`` and ``data_worker_busy_fraction`` gauges, and a
``data_corrupt_skipped`` event for each corrupt record, which is SKIPPED
AND COUNTED (``corrupt_skipped``), never consumed and never fatal to the
epoch.  Call :meth:`StreamingLoader.finalize` to stop the pool.
"""

import collections
import json
import os
import time
import zlib

import numpy as np

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.data.recordio import ShardSet, decode_example
from chainermn_tpu_torch.dataset import _world, epoch_position, scatter_index
from chainermn_tpu_torch.utils import failure

_JOIN_TIMEOUT = 5.0   # seconds a decode thread gets to finish a read


def stream_order(n, seed, epoch, shuffle=True):
    """Epoch ``epoch``'s global sample-id stream: a permutation of
    ``range(n)`` that is a deterministic function of ``(seed,
    epoch)`` ALONE -- two loaders (or two topologies, or two runs)
    given the same pair produce byte-identical streams.  The mix uses
    crc32, not Python's per-process salted ``hash`` (the chaos-seed
    discipline)."""
    if n < 0:
        raise ValueError('n must be >= 0')
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    mix = (zlib.crc32(b'stream:%d:%d' % (int(seed), int(epoch)))
           & 0xffffffff)
    return np.random.RandomState(mix).permutation(n).astype(np.int64)


def epoch_stream(n, seed, batch_size, epoch=0, shuffle=True,
                 drop_last=False):
    """The uninterrupted ORACLE stream of one epoch as a list of
    global-batch id arrays -- what the concatenated per-rank ledgers
    of any topology (or any N->M resume) must reproduce exactly.
    Test/verification helper; the loader itself never materializes
    this."""
    order = stream_order(n, seed, epoch, shuffle)
    out = []
    for c in range(0, n, batch_size):
        ids = order[c:c + batch_size]
        if drop_last and len(ids) < batch_size:
            break
        out.append(ids)
    return out


class StreamingLoader:
    """Iterator over record shards yielding this process's slice of
    each GLOBAL batch as a list of decoded examples (collation is the
    updater's ``concat_examples`` job, as with every other iterator).

    Args:
      shards: a :class:`~chainermn_tpu_torch.data.recordio.ShardSet`, a
        list of shard paths, or a shard directory.
      batch_size: the GLOBAL batch size (topology-independent -- the
        elastic contract's invariant; the reference's per-rank
        ``batchsize`` is topology-coupled, which is exactly what
        breaks N->M replay).
      comm: communicator; ``size``/``rank`` default to its size and
        rank (one process a device, ``scatter_dataset``'s rule), else
        to the initialized ``torch.distributed`` group, else a world of
        one.  Explicit ``size``/``rank`` override (single-process tests
        simulate several processes this way).
      seed / shuffle: stream-order parameters.
      repeat: roll into the next epoch at the boundary (else
        ``StopIteration``).
      drop_last: skip a final partial global batch (static-shape jit
        steps want this; the default ``False`` emits it, split by the
        same balanced rule).
      n_workers / prefetch: decode threads and the number of batches
        whose reads are submitted ahead of consumption.
      decode / transform: payload decoder (default
        :func:`~chainermn_tpu_torch.data.recordio.decode_example`) and an
        optional per-example post-transform (augmentation).
      ledger_path: when set, every consumed batch slice is appended
        as one fsynced JSON line ``{"epoch", "base", "positions",
        "ids"}`` -- the crash-surviving sample-id ledger the chaos
        scenarios audit.
    """

    def __init__(self, shards, batch_size, comm=None, size=None,
                 rank=None, seed=0, shuffle=True, repeat=True,
                 drop_last=False, n_workers=2, prefetch=2,
                 decode=decode_example, transform=None,
                 ledger_path=None):
        if isinstance(shards, str):
            shards = ShardSet.from_dir(shards)
        elif isinstance(shards, (list, tuple)):
            shards = ShardSet(shards)
        self.shards = shards
        if batch_size < 1:
            raise ValueError('batch_size must be >= 1')
        if n_workers < 1:
            raise ValueError('n_workers must be >= 1')
        if prefetch < 1:
            raise ValueError('prefetch must be >= 1')
        if size is None or rank is None:
            world, me = ((comm.size, comm.rank) if comm is not None
                         else _world())
            size = world if size is None else size
            rank = me if rank is None else rank
        if not 0 <= rank < size:
            raise ValueError('rank %d out of range for size %d'
                             % (rank, size))
        self.batch_size = batch_size
        self.size = size
        self.rank = rank
        self.seed = seed
        self._shuffle = shuffle
        self._repeat = repeat
        self._drop_last = drop_last
        self.n_workers = n_workers
        self._prefetch_depth = prefetch
        self._decode = decode
        self._transform = transform
        self._ledger_file = (open(ledger_path, 'a')
                             if ledger_path else None)
        self.ledger = []  # in-memory [(epoch, base, positions, ids)]
        self.corrupt_skipped = 0
        self.corrupt_ids = []
        self._busy_s = 0.0  # accumulated worker read+decode seconds
        self._t_start = time.monotonic()
        self._busy_mark = (0.0, self._t_start)
        self.depth_samples = collections.deque(maxlen=4096)
        self._pool = None
        self._pending = collections.deque()
        # consumer-side counters (the checkpointable truth)
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._cursor = 0
        # producer-side counters (read-ahead position; rebuilt from
        # the consumer side on any restore)
        self._sync_producer()

    # -- positions -----------------------------------------------------

    def __len__(self):
        return len(self.shards)

    @property
    def stream_cursor(self):
        """Samples of the current epoch consumed GLOBALLY -- the
        elastic-resume cursor (topology-free by construction)."""
        return self._cursor

    @property
    def epoch_detail(self):
        return self.epoch + self._cursor / max(1, len(self.shards))

    def state(self):
        """``{'epoch', 'cursor'}`` -- the exact-resume checkpoint."""
        return {'epoch': self.epoch, 'cursor': self._cursor}

    def restore_cursor(self, epoch, cursor):
        """EXACT elastic restore: land at global position ``cursor``
        of epoch ``epoch``'s stream.  All read-ahead from the
        pre-restore position is discarded; the epoch's order is
        re-derived from ``(seed, epoch)``, so the remaining stream is
        exactly what the interrupted run would have consumed.  A
        cursor beyond the CURRENT shard-set length (the data set
        shrank between runs) clamps to the epoch boundary rather than
        fabricating positions."""
        n = len(self.shards)
        if cursor < 0:
            raise ValueError('cursor must be >= 0')
        self._discard_pending()
        self.epoch = int(epoch)
        self._cursor = min(int(cursor), n)
        self.is_new_epoch = False
        self._sync_producer()

    def restore_position(self, epoch_detail):
        """Fractional restore (the PR 5 iterator contract, kept for
        snapshots without a ``stream_cursor``): exact whenever the
        detail was produced by a loader over the same shard-set
        length, nearest-position otherwise."""
        epoch, pos = epoch_position(float(epoch_detail),
                                    len(self.shards))
        self.restore_cursor(epoch, pos)

    def restore_epoch(self, epoch):
        self.restore_cursor(int(epoch), 0)

    def reset(self):
        self.restore_cursor(0, 0)
        self.iteration = 0
        self.ledger = []
        self.corrupt_skipped = 0
        self.corrupt_ids = []

    def remaining_ids(self):
        """This epoch's not-yet-consumed global ids, in stream order
        (verification helper)."""
        return self._order_for(self.epoch)[self._cursor:]

    # -- producer ------------------------------------------------------

    def _order_for(self, epoch):
        return stream_order(len(self.shards), self.seed, epoch,
                            self._shuffle)

    def _sync_producer(self):
        self._p_epoch = self.epoch
        self._p_cursor = self._cursor
        self._p_order = self._order_for(self._p_epoch)
        self._p_done = False

    def _discard_pending(self):
        for item in self._pending:
            for f in item['futures']:
                f.cancel()
        self._pending.clear()

    def _ensure_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=self.n_workers,
                thread_name_prefix='cmn-data')
        return self._pool

    def _read_one(self, sid):
        """Worker-thread body: read + decode one sample; a corrupt
        record returns ``None`` (skip-and-count happens consumer-side
        so the counters stay single-threaded)."""
        t0 = time.monotonic()
        try:
            try:
                payload = self.shards.read(int(sid))
                ex = self._decode(payload)
            except failure.DataCorruptError as e:
                return ('corrupt', e)
            if self._transform is not None:
                ex = self._transform(ex)
            return ('ok', ex)
        finally:
            self._busy_s += time.monotonic() - t0

    def _submit_next(self):
        """Submit the reads of the next global batch's local slice;
        False when the (non-repeating) stream is exhausted."""
        n = len(self.shards)
        if self._p_done or n == 0:
            return False
        if self._p_cursor >= n:
            if not self._repeat:
                self._p_done = True
                return False
            self._p_epoch += 1
            self._p_cursor = 0
            self._p_order = self._order_for(self._p_epoch)
        m = min(self.batch_size, n - self._p_cursor)
        if m < self.batch_size and self._drop_last:
            # skip the partial tail: the epoch boundary still fires
            # (consumer sees an empty batch marker), positions
            # [cursor, n) are deliberately unconsumed this epoch
            if not self._repeat:
                self._p_done = True
                return False
            self._p_epoch += 1
            self._p_cursor = 0
            self._p_order = self._order_for(self._p_epoch)
            m = min(self.batch_size, n)
        base = self._p_cursor
        end = base + m
        # last batch of its epoch when it reaches the boundary, or
        # when drop_last would discard everything after it
        epoch_end = (end >= n
                     or (self._drop_last and n - end < self.batch_size))
        lo, hi = scatter_index(m, self.size, self.rank)
        positions = np.arange(base + lo, base + hi, dtype=np.int64)
        ids = self._p_order[base + lo:base + hi]
        pool = self._ensure_pool()
        futures = [pool.submit(self._read_one, sid) for sid in ids]
        self._pending.append({
            'epoch': self._p_epoch, 'base': base, 'end': end,
            'epoch_end': epoch_end, 'positions': positions,
            'ids': ids, 'futures': futures})
        self._p_cursor = end
        return True

    # -- consumer ------------------------------------------------------

    def _record_batch(self, item, skipped):
        """Ledger one consumed batch slice: ``positions`` and ``ids``
        are the FULL (position -> id) assignment of this rank's
        slice; ``skipped`` lists the corrupt ids among them (counted,
        not consumed)."""
        entry = {'epoch': item['epoch'], 'base': item['base'],
                 'positions': item['positions'].tolist(),
                 'ids': [int(i) for i in item['ids']],
                 'skipped': [int(i) for i in skipped]}
        self.ledger.append(entry)
        if self._ledger_file is not None:
            self._ledger_file.write(json.dumps(entry) + '\n')
            self._ledger_file.flush()
            os.fsync(self._ledger_file.fileno())

    def _telemetry_tick(self):
        reg = _telemetry.registry()
        self.depth_samples.append(len(self._pending))
        if reg is None:
            return
        reg.gauge('data_queue_depth',
                  help='prefetched batches pending consumption'
                  ).set(float(len(self._pending)))
        busy0, t0 = self._busy_mark
        now = time.monotonic()
        wall = max(now - t0, 1e-9)
        frac = (self._busy_s - busy0) / (wall * self.n_workers)
        self._busy_mark = (self._busy_s, now)
        reg.gauge('data_worker_busy_fraction',
                  help='decode-pool busy seconds / wall seconds / '
                       'worker').set(min(max(frac, 0.0), 1.0))

    def busy_fraction(self):
        """Lifetime decode-pool utilization (0..1)."""
        wall = max(time.monotonic() - self._t_start, 1e-9)
        return min(max(self._busy_s / (wall * self.n_workers), 0.0),
                   1.0)

    def __iter__(self):
        return self

    def __next__(self):
        if len(self.shards) == 0:
            raise StopIteration
        while (len(self._pending) < self._prefetch_depth
               and self._submit_next()):
            pass
        if not self._pending:
            raise StopIteration
        item = self._pending.popleft()
        with _telemetry.span('data_decode', kind='data',
                             iteration=self.iteration,
                             n=len(item['ids'])):
            results = [f.result() for f in item['futures']]
        batch, skipped = [], []
        for sid, (status, value) in zip(item['ids'], results):
            if status == 'corrupt':
                # typed, counted, skipped -- NEVER silently consumed
                self.corrupt_skipped += 1
                self.corrupt_ids.append(int(sid))
                skipped.append(int(sid))
                _telemetry.event('data_corrupt_skipped', kind='data',
                                 shard=value.shard, record=value.record,
                                 corruption_kind=value.kind)
                reg = _telemetry.registry()
                if reg is not None:
                    reg.counter(
                        'data_corrupt_skipped_total',
                        help='corrupt records skipped by the '
                             'streaming loader').inc()
                continue
            batch.append(value)
        self._record_batch(item, skipped)
        # consumer counters advance to the batch's end position;
        # completing the epoch rolls them (SerialIterator semantics)
        if item['epoch_end']:
            self.epoch = item['epoch'] + 1
            self._cursor = 0
            self.is_new_epoch = True
        else:
            self.epoch = item['epoch']
            self._cursor = item['end']
            self.is_new_epoch = False
        self.iteration += 1
        self._telemetry_tick()
        return batch

    next = __next__

    def finalize(self):
        """Cancel the pending reads and stop the decode pool, waiting up
        to ``_JOIN_TIMEOUT`` seconds for each of its threads (a read in
        flight finishes); close the ledger."""
        self._discard_pending()
        if self._pool is not None:
            pool, self._pool = self._pool, None
            pool.shutdown(wait=False, cancel_futures=True)
            for thread in list(getattr(pool, '_threads', ())):
                thread.join(_JOIN_TIMEOUT)
        if self._ledger_file is not None:
            self._ledger_file.close()
            self._ledger_file = None
