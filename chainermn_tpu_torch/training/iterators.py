"""Dataset iterators.

Counterpart of ``chainermn_tpu/training/iterators.py``:
``SerialIterator``, ``PipelineIterator`` (index batches for a batch-level
pipeline such as ``datasets.BatchAugmentPipeline``),
``MultiprocessIterator`` (a prefetch thread over a ``SerialIterator``) and
``DevicePrefetchIterator`` (collation and the host-to-device copy of the
next batches on a side CUDA stream, behind the running step; it carries a
streaming loader's ``stream_cursor`` as consumed).  Every iterator has
``restore_epoch`` and ``restore_position``.  Host-side data handling
stays in numpy.
"""

import queue as queue_mod
import threading

import numpy as np
import torch

from chainermn_tpu_torch.dataset import epoch_position


class SerialIterator:
    """Single-thread batch iterator with epoch accounting."""

    def __init__(self, dataset, batch_size, repeat=True, shuffle=True,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._pos = 0
        self._order = self._new_order()

    def _new_order(self):
        n = len(self.dataset)
        return (self._rng.permutation(n) if self._shuffle
                else np.arange(n))

    @property
    def epoch_detail(self):
        """Epochs done, with the fraction of the current one."""
        return self.epoch + self._pos / max(1, len(self.dataset))

    def restore_epoch(self, epoch):
        """Continue epoch accounting from a checkpoint."""
        self.epoch = int(epoch)

    def restore_position(self, epoch_detail):
        """Land where an uninterrupted run stood at ``epoch_detail``:
        its epoch, its position in the epoch and, when shuffling, its
        permutation (a repeating iterator draws one order at the start
        and one at each epoch's end, so the seed's ``epoch + 1``-th
        draw is the order of the current epoch).  The JAX package's
        elastic ``restore_position`` keeps the position but draws a
        fresh order; this one resumes the same sequence of batches."""
        n = len(self.dataset)
        epoch = int(epoch_detail)
        self.epoch = epoch
        self._pos = int(round((float(epoch_detail) - epoch) * n))
        self.is_new_epoch = False
        self._rng = np.random.RandomState(self._seed)
        for _ in range(epoch + 1):
            self._order = self._new_order()

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.dataset)
        if n == 0:
            raise StopIteration
        if self._pos >= n:
            if not self._repeat:
                raise StopIteration
            self._pos = 0
            self._order = self._new_order()
        i, i_end = self._pos, min(self._pos + self.batch_size, n)
        batch = [self.dataset[int(self._order[k])] for k in range(i, i_end)]
        self._pos = i_end
        self.is_new_epoch = False
        if self._pos >= n:
            self.epoch += 1
            self.is_new_epoch = True
            if self._repeat:
                self._pos = 0
                self._order = self._new_order()
        # top up to a constant batch size when repeating
        while self._repeat and len(batch) < self.batch_size:
            batch.append(self.dataset[int(self._order[self._pos])])
            self._pos += 1
        self.iteration += 1
        return batch


class PipelineIterator:
    """Batch-level iterator over a
    :class:`~chainermn_tpu_torch.datasets.imagenet.BatchAugmentPipeline`
    (or anything with ``__len__`` and ``batch(indices) -> (X, Y)``):
    yields the pipeline's collated column arrays, assembled by the native
    C++ thread pool instead of per-item Python.  Epoch accounting is
    :class:`SerialIterator`'s; a repeating iterator tops a short last
    batch up from the next epoch's order, so every batch has
    ``batch_size`` rows.  ``restore_position`` is the JAX package's:
    the position of ``dataset.epoch_position`` and a freshly drawn
    order."""

    def __init__(self, pipeline, batch_size, repeat=True, shuffle=True,
                 seed=0):
        self.pipeline = pipeline
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._pos = 0
        self._order = self._new_order()

    def restore_epoch(self, epoch):
        self.epoch = int(epoch)

    def restore_position(self, epoch_detail):
        """Land at the global epoch fraction ``epoch_detail``
        re-expressed at this pipeline's length; the order is drawn
        afresh."""
        self.epoch, self._pos = epoch_position(float(epoch_detail),
                                               len(self.pipeline))
        self.is_new_epoch = False
        self._order = self._new_order()

    def _new_order(self):
        n = len(self.pipeline)
        return (self._rng.permutation(n) if self._shuffle
                else np.arange(n))

    @property
    def epoch_detail(self):
        return self.epoch + self._pos / max(1, len(self.pipeline))

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.pipeline)
        if n == 0:
            raise StopIteration
        if self._pos >= n:
            if not self._repeat:
                raise StopIteration
            self._pos = 0
            self._order = self._new_order()
        i_end = min(self._pos + self.batch_size, n)
        idx = self._order[self._pos:i_end]
        self._pos = i_end
        self.is_new_epoch = False
        if self._pos >= n:
            self.epoch += 1
            self.is_new_epoch = True
            if self._repeat:
                self._pos = 0
                self._order = self._new_order()
        if self._repeat and len(idx) < self.batch_size:
            extra = self.batch_size - len(idx)
            idx = np.concatenate([idx, self._order[:extra]])
            self._pos = extra
        self.iteration += 1
        return self.pipeline.batch(idx.astype(np.int64))

    next = __next__


class _PrefetchingIterator:
    """Worker thread and queue shared by the prefetching iterators.

    A daemon thread calls :meth:`_produce` (pull from the inner
    iterator, transform, snapshot the inner counters) and feeds a
    bounded queue; ``__next__`` unpacks the items.  The worker holds ITS
    OWN queue and stop event, so a worker outliving a reset sees its
    own, set, stop event and never races its replacement; puts are
    bounded and check the stop event; the terminal item (StopIteration
    or the worker's exception) is remembered, since the worker has
    exited after sending it, and raised again until :meth:`reset`.
    """

    def _start_worker(self):
        self._queue = queue_mod.Queue(maxsize=self._depth)
        self._stop = threading.Event()
        self._terminal = None
        self._thread = threading.Thread(
            target=self._worker_loop, args=(self._queue, self._stop),
            daemon=True)
        self._thread.start()

    def _stop_worker(self):
        self._stop.set()
        # drain, so that a producer blocked in put() sees the stop flag
        while self._thread.is_alive():
            try:
                while True:
                    self._queue.get_nowait()
            except queue_mod.Empty:
                pass
            self._thread.join(timeout=0.2)

    def _worker_loop(self, out_queue, stop):
        try:
            while not stop.is_set():
                try:
                    item = self._produce()
                except StopIteration:
                    out_queue.put(StopIteration)
                    return
                while not stop.is_set():
                    try:
                        out_queue.put(item, timeout=0.2)
                        break
                    except queue_mod.Full:
                        continue
        except Exception as e:  # the consumer raises it
            out_queue.put(e)

    def _next_item(self):
        if self._terminal is not None:
            raise self._terminal
        item = self._queue.get()
        if item is StopIteration:
            self._terminal = StopIteration()
            raise StopIteration
        if isinstance(item, Exception):
            self._terminal = item
            raise item
        return item

    def __iter__(self):
        return self

    def finalize(self):
        """Stop the worker (and the inner iterator's, when it has one)."""
        self._stop_worker()
        fin = getattr(self._source, 'finalize', None)
        if fin is not None:
            fin()


class MultiprocessIterator(_PrefetchingIterator):
    """Prefetching iterator: a thread runs a :class:`SerialIterator` up to
    ``n_prefetch`` batches ahead, so the same batches come in the same
    order.  The reference needs worker processes for its Python-side
    JPEG decoding; the port's pipeline is numpy, whose array work frees
    the interpreter lock, so a thread hides it without fork hazards; the
    class name is the reference's.  ``epoch``, ``epoch_detail`` and
    ``is_new_epoch`` count what the consumer has taken, not the
    thread's read-ahead."""

    def __init__(self, dataset, batch_size, repeat=True, shuffle=True,
                 seed=0, n_prefetch=4, n_processes=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self._source = SerialIterator(dataset, batch_size, repeat,
                                      shuffle, seed)
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._consumed_pos = 0
        self._depth = n_prefetch
        self._start_worker()

    def _produce(self):
        inner = self._source
        batch = next(inner)
        return (batch, inner.epoch, inner.iteration, inner.is_new_epoch,
                inner._pos)

    def reset(self):
        """Stop the thread and restart from a fresh pass."""
        self._stop_worker()
        self._source.reset()
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._consumed_pos = 0
        self._start_worker()

    def restore_epoch(self, epoch):
        """Continue epoch accounting from a checkpoint: the inner
        iterator's counters are rebased too, so the prefetched batches
        carry the restored epoch."""
        self._stop_worker()
        self._source.epoch = int(epoch)
        self.epoch = int(epoch)
        self._consumed_pos = 0
        self._start_worker()

    def restore_position(self, epoch_detail):
        """Land the inner iterator at ``epoch_detail``
        (``SerialIterator.restore_position``) and the consumer's
        counters with it, dropping the read-ahead."""
        self._stop_worker()
        self._source.restore_position(float(epoch_detail))
        self.epoch = self._source.epoch
        self._consumed_pos = self._source._pos
        self.is_new_epoch = False
        self._start_worker()

    def __next__(self):
        batch, self.epoch, self.iteration, self.is_new_epoch, \
            self._consumed_pos = self._next_item()
        return batch

    next = __next__

    @property
    def epoch_detail(self):
        return self.epoch + self._consumed_pos / max(1, len(self.dataset))


class DevicePrefetchIterator(_PrefetchingIterator):
    """Collation and the host-to-device copy of the next ``depth``
    batches, behind the running step: a thread pulls batches from
    ``inner`` and runs ``place_fn(batch) -> tuple of tensors`` on them
    (``StandardUpdater(device_prefetch=N)`` passes one that collates
    into pinned host memory and copies with ``non_blocking=True``).

    On a CUDA ``device`` the thread runs ``place_fn`` on a side stream
    and records an event after it; ``__next__`` makes the current stream
    wait on that event (the step never reads a half-copied batch) and
    calls ``record_stream`` on the tensors (the caching allocator does
    not hand their memory out again while the step may read it).  Epoch
    accounting is what the consumer has taken, as
    :class:`MultiprocessIterator`'s; so is :attr:`stream_cursor`, a
    streaming loader's elastic cursor."""

    def __init__(self, inner, place_fn, depth=2, device=None):
        if depth < 1:
            raise ValueError('depth must be >= 1')
        self.inner = self._source = inner
        self._place = place_fn
        self._depth = depth
        self._device = torch.device(device) if device is not None else None
        self._stream = (torch.cuda.Stream(self._device)
                        if self._device is not None
                        and self._device.type == 'cuda' else None)
        self._rebase_counters()
        self._start_worker()

    def _rebase_counters(self):
        inner = self._source
        self.epoch = getattr(inner, 'epoch', 0)
        self.iteration = getattr(inner, 'iteration', 0)
        self.is_new_epoch = False
        self._consumed_detail = float(getattr(inner, 'epoch_detail', 0.0))
        self._consumed_cursor = getattr(inner, 'stream_cursor', None)

    def _produce(self):
        inner = self._source
        batch = next(inner)
        event = None
        if self._stream is None:
            placed = self._place(batch)
        else:
            with torch.cuda.device(self._device), \
                    torch.cuda.stream(self._stream):
                placed = self._place(batch)
                event = torch.cuda.Event()
                event.record(self._stream)
        return (placed, event, getattr(inner, 'epoch', 0),
                getattr(inner, 'iteration', 0),
                getattr(inner, 'is_new_epoch', False),
                float(getattr(inner, 'epoch_detail', 0.0)),
                getattr(inner, 'stream_cursor', None))

    def __next__(self):
        (placed, event, self.epoch, self.iteration, self.is_new_epoch,
         self._consumed_detail, self._consumed_cursor) = self._next_item()
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in placed:
                if t.is_cuda:
                    t.record_stream(current)
        return placed

    next = __next__

    @property
    def epoch_detail(self):
        return self._consumed_detail

    @property
    def stream_cursor(self):
        """The inner streaming loader's cursor as CONSUMED: the thread
        reads ahead, and a checkpoint must hold what the train loop
        took.  None over an inner iterator without a cursor (then
        ``serializers.updater_state`` stores none)."""
        return self._consumed_cursor

    def reset(self):
        self._stop_worker()
        if hasattr(self.inner, 'reset'):
            self.inner.reset()
        self._rebase_counters()
        self._start_worker()

    def restore_epoch(self, epoch):
        """Restore the inner iterator at the start of ``epoch`` and
        rebase the consumer's counters, dropping the read-ahead."""
        self._stop_worker()
        if hasattr(self.inner, 'restore_epoch'):
            self.inner.restore_epoch(epoch)
        else:
            self.inner.epoch = int(epoch)
        self._rebase_counters()
        self.epoch = int(epoch)
        self._consumed_detail = float(int(epoch))
        self._start_worker()

    def restore_cursor(self, epoch, cursor):
        """Exact elastic restore over a streaming loader: its global
        ``(epoch, cursor)``, the consumer's counters rebased, the
        read-ahead dropped.  Over an inner iterator without
        ``restore_cursor`` this lands at the start of ``epoch``."""
        if not hasattr(self.inner, 'restore_cursor'):
            return self.restore_position(float(int(epoch)))
        self._stop_worker()
        self.inner.restore_cursor(int(epoch), int(cursor))
        self._rebase_counters()
        self._start_worker()

    def restore_position(self, epoch_detail):
        """Restore the inner iterator at ``epoch_detail`` (its
        ``restore_position``, else its ``restore_epoch``, else its
        integer ``epoch``) and rebase the consumer's counters, dropping
        the read-ahead."""
        self._stop_worker()
        if hasattr(self.inner, 'restore_position'):
            self.inner.restore_position(float(epoch_detail))
        elif hasattr(self.inner, 'restore_epoch'):
            self.inner.restore_epoch(int(epoch_detail))
        else:
            self.inner.epoch = int(epoch_detail)
        self._rebase_counters()
        self._start_worker()
