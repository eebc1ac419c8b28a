"""Preemption-aware training: checkpoint on SIGTERM, resume by itself.

Counterpart of ``chainermn_tpu/training/recovery.py``, with the same
file names (``preempt_iter_<N>.npz``, ``preempted.json``), so each
package resumes from the other's preemption snapshots.  GPU capacity is
preemptible: the scheduler (or a chaos test) delivers SIGTERM and the
process has seconds to leave.

1. :class:`PreemptionHandler` installs a SIGTERM handler that only sets
   a flag and drops the flight record; at the next step boundary it
   writes the whole updater snapshot (``serializers.updater_state``:
   parameters, optimizer state, loss-scale state, counters) and stops
   the loop.  With ``async_=True`` the write runs on an
   :class:`AsyncCheckpointWriter`'s thread from a host copy taken at the
   step boundary.
2. :func:`auto_resume` walks the snapshot chain under the output
   directory newest to oldest and restores the first valid snapshot into
   a freshly built updater through ``serializers.resume_updater(
   elastic=True)`` (a ZeRO-1 snapshot written at another process count
   is resharded N -> M), so the relaunched job continues the same
   trajectory.  A torn or corrupt snapshot is skipped with a typed
   :class:`~chainermn_tpu_torch.utils.failure.CheckpointSkippedWarning`.

Both work in a hand-written loop (``update_core`` then
:meth:`PreemptionHandler.maybe_checkpoint`) and as Trainer extensions.
Snapshots are npz, or with ``method='orbax'`` (the JAX package's name)
step directories ``<out>/preempt/<iteration>/`` of
``torch.distributed.checkpoint`` (``serializers.save_checkpoint``),
which every process writes its part of.
"""

import json
import os
import re
import signal
import sys
import threading
import warnings

import numpy as np
import torch

from chainermn_tpu_torch import serializers
from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.utils import failure

PREEMPT_PREFIX = 'preempt_iter_'


def _is_main_thread():
    return threading.current_thread() is threading.main_thread()


def _host_copy(leaf):
    """A copy of ``leaf`` in host memory that no later step can change:
    a CUDA tensor's ``.cpu()`` is a copy; a CPU tensor is cloned; a numpy
    array that does not own its memory (``tensor.numpy()`` of a live CPU
    tensor is a view of it) is copied."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        return leaf.cpu() if leaf.is_cuda else leaf.clone()
    if isinstance(leaf, np.ndarray) and not leaf.flags.owndata:
        return leaf.copy()
    return leaf


def _host_tree(tree):
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    return _host_copy(tree)


class AsyncCheckpointWriter:
    """Background committer for snapshots held in host memory.

    The step path hands over a write job (:meth:`submit`) and returns at
    once; one daemon thread runs it (the job keeps the tmp + fsync +
    rename, manifest and sentinel discipline, so what lands on disk does
    not change, only who waits for the disk).  The thread ends when no
    job waits, and the next :meth:`submit` starts another: an idle
    writer leaves no thread behind.

    Back-pressure is newest-wins: at most one job runs and one waits.  A
    job submitted while another waits REPLACES it (``coalesced`` counts
    the drops), so under a slow disk the writer commits the newest
    snapshot and holds at most two in host memory.

    A job that raises has its exception stored (and a flight record
    dumped); the next :meth:`raise_pending_error` (which
    ``PreemptionHandler.checkpoint`` calls first) or :meth:`wait`
    re-raises it as it was (an ``OSError`` stays an ``OSError``).
    :meth:`wait` is the durability barrier: it returns when nothing waits
    and nothing runs.
    """

    def __init__(self, name='async_ckpt'):
        self.name = name
        self._cond = threading.Condition()
        self._pending = None     # newest submitted, not started yet
        self._busy = False       # a job is running
        self._error = None
        self._thread = None
        self.submitted = 0
        self.committed = 0
        self.coalesced = 0

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run,
                                            name=self.name, daemon=True)
            self._thread.start()

    def _run(self):
        while True:
            with self._cond:
                if self._pending is None:
                    self._thread = None
                    return
                job = self._pending
                self._pending = None
                self._busy = True
            try:
                job()
                with self._cond:
                    self.committed += 1
            except Exception as e:  # re-raised at the next probe
                with self._cond:
                    self._error = e
                _telemetry.event('async_ckpt_error', kind='checkpoint',
                                 error=repr(e))
                _telemetry.dump_flight('async_ckpt_error', blocking=False,
                                       error=repr(e))
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def submit(self, job):
        """Queue ``job`` (a callable of no arguments that touches host
        memory only); an unstarted queued job is replaced, not kept."""
        with self._cond:
            if self._pending is not None:
                self.coalesced += 1
            self._pending = job
            self.submitted += 1
            self._ensure_thread()
            self._cond.notify_all()

    def raise_pending_error(self):
        """Re-raise (and clear) a stored background failure."""
        with self._cond:
            e, self._error = self._error, None
        if e is not None:
            raise e

    def wait(self, timeout=None):
        """Block until every submitted job has committed or failed, then
        re-raise a stored failure.  Returns True when drained, False on
        timeout."""
        with self._cond:
            drained = self._cond.wait_for(
                lambda: self._pending is None and not self._busy, timeout)
            idle = self._thread
        if drained and idle is not None:
            idle.join()     # it finds nothing to do and ends
        self.raise_pending_error()
        return drained

    @property
    def in_flight(self):
        with self._cond:
            return ((1 if self._busy else 0)
                    + (1 if self._pending is not None else 0))


class PreemptionHandler:
    """SIGTERM -> checkpoint -> clean stop.

    In a hand-written loop::

        handler = PreemptionHandler(updater, out='result')
        for batch in loop:
            updater.update_core(batch)
            if handler.maybe_checkpoint():
                break   # snapshot written; leave cleanly

    As a Trainer extension (priority 300, above every other extension, so
    the snapshot comes before anything reads the iteration)::

        trainer.extend(PreemptionHandler(updater, out='result'))

    ``method``: ``'npz'`` (rank 0 writes ``preempt_iter_<N>.npz``, or
    every rank ``preempt_iter_<N>.rank<R>.npz`` with ``all_ranks`` in a
    world of more than one) or ``'orbax'``: the step directory
    ``<out>/preempt/<N>/`` of ``serializers.save_checkpoint``, a
    collective save in which each process writes its own ZeRO-1
    partitions.  ``exit_code``: when not None, ``sys.exit`` with it
    right after the preemption snapshot.  ``async_``: :meth:`checkpoint`
    copies the state to host memory at the step boundary (the gather of
    sharded state is still a collective there: every rank calls it at
    the same iteration), hands the write to an
    :class:`AsyncCheckpointWriter` (``'orbax'``: to
    ``save_checkpoint(async_=True)``) and returns; preemption snapshots
    (:meth:`maybe_checkpoint`) and :meth:`wait` still wait for the disk.
    The signal handler takes no lock: it sets a flag and dumps the
    flight record with ``blocking=False``.
    """

    trigger = (1, 'iteration')
    priority = 300  # before NanGuard / LogReport
    name = 'preemption'

    def __init__(self, updater, out='result', method='npz',
                 signals=(signal.SIGTERM,), exit_code=None,
                 all_ranks=False, async_=False):
        self.updater = updater
        self.out = out
        self.method = method
        self.exit_code = exit_code
        self.all_ranks = all_ranks
        self.async_ = async_
        self.writer = (AsyncCheckpointWriter()
                       if async_ and method == 'npz' else None)
        self.preempt_requested = False
        self.received_signal = None
        self.checkpoint_path = None
        self._prev_handlers = {}
        if signals and _is_main_thread():
            for sig in signals:
                self._prev_handlers[sig] = signal.signal(sig,
                                                         self._on_signal)

    def _on_signal(self, signum, frame):
        # the flags first (the checkpoint runs at the next step boundary,
        # where the state is consistent), then the flight record, the
        # only thing left if a SIGKILL follows before that boundary.  A
        # handler runs between bytecodes of the thread that may hold the
        # recorder's lock: the dump must not block on it
        self.preempt_requested = True
        self.received_signal = signum
        _telemetry.dump_flight('sigterm', blocking=False, signum=signum,
                               iteration=getattr(self.updater, 'iteration',
                                                 None))

    def restore_signal_handlers(self):
        for sig, prev in self._prev_handlers.items():
            signal.signal(sig, prev)
        self._prev_handlers = {}

    def _target(self, iteration):
        """``(path without .npz, whether this rank writes it)``."""
        rank, size = serializers._world()
        name = '%s%d' % (PREEMPT_PREFIX, iteration)
        if self.all_ranks and size > 1:
            name += '.rank%d' % rank
        return (os.path.join(self.out, name),
                self.all_ranks or rank == 0)

    def _sidecar(self, iteration, path):
        """``preempted.json`` (rank 0 only), tmp + rename."""
        if serializers._world()[0] != 0:
            return
        final = os.path.join(self.out, 'preempted.json')
        tmp = final + '.tmp'
        with open(tmp, 'w') as f:
            json.dump({'iteration': iteration,
                       'signal': self.received_signal,
                       'method': self.method, 'checkpoint': path}, f)
        os.replace(tmp, final)

    def checkpoint(self):
        """Write the preemption snapshot now (whatever the flag); returns
        its path (None on a rank that writes nothing).  The state is
        gathered first where it is sharded (ZeRO-1 partitions, a
        tensor-parallel model's shards): a collective, which is why every
        rank calls this at the same iteration.  With ``async_=True`` the
        path is durable only after :meth:`wait`, and a failure of an
        earlier background write re-raises here first."""
        os.makedirs(self.out, exist_ok=True)
        u = self.updater
        if self.writer is not None:
            self.writer.raise_pending_error()
            return self._checkpoint_async(u)
        with _telemetry.span('checkpoint_write', kind='checkpoint',
                             method=self.method, iteration=u.iteration):
            mesh_shape = serializers.mesh_shape_of(u)
            if self.method == 'orbax':
                directory = os.path.join(self.out, 'preempt')
                serializers.save_checkpoint(
                    directory, serializers.updater_state(u, sharded=True),
                    step=u.iteration, async_=self.async_,
                    mesh_shape=mesh_shape)
                path = os.path.join(directory, str(u.iteration))
            else:
                state = serializers.updater_state(u)
                target, write_here = self._target(u.iteration)
                path = (serializers.save_npz(target, state,
                                             mesh_shape=mesh_shape)
                        if write_here else None)
            self._sidecar(u.iteration, path)
        self.checkpoint_path = path
        return path

    def _checkpoint_async(self, u):
        """The step-path half of an asynchronous snapshot: gather (still
        collective), copy to host memory the next step cannot overwrite,
        submit the write."""
        iteration = u.iteration
        with _telemetry.span('checkpoint_snapshot', kind='checkpoint',
                             method=self.method, iteration=iteration):
            host = _host_tree(serializers.updater_state(u))
            mesh_shape = serializers.mesh_shape_of(u)
        target, write_here = self._target(iteration)
        path = target + '.npz' if write_here else None
        method = self.method

        def job():
            with _telemetry.span('checkpoint_write', kind='checkpoint',
                                 method=method, iteration=iteration,
                                 background=True):
                if write_here:
                    serializers.save_npz(target, host, mesh_shape=mesh_shape)
                self._sidecar(iteration, path)

        self.writer.submit(job)
        self.checkpoint_path = path
        return path

    def wait(self, timeout=None):
        """Durability barrier: block until every background write has
        committed, re-raising a background failure.  True at once for a
        synchronous handler."""
        if self.writer is not None:
            return self.writer.wait(timeout)
        if self.async_:
            serializers.wait_checkpoints()
        return True

    def maybe_checkpoint(self):
        """When a preemption signal arrived since the last call: write
        the snapshot, wait for the disk, and return its path (truthy);
        else None.  The caller stops its loop on a truthy value."""
        if not self.preempt_requested:
            return None
        os.makedirs(self.out, exist_ok=True)
        path = self.checkpoint() or True
        # the relaunch resumes from this snapshot: it must be on disk
        # before the process leaves
        self.wait()
        if self.exit_code is not None:
            sys.exit(self.exit_code)
        return path

    def __call__(self, trainer):
        if self.maybe_checkpoint():
            trainer.stop(reason='preempted (signal %s)'
                         % self.received_signal)


def snapshot_chain(out, extra_prefixes=('snapshot_iter_',)):
    """Every snapshot candidate under ``out`` as ``(kind, path,
    iteration)``, newest first (a tie prefers the preemption snapshot,
    written last): ``preempt_iter_<N>[.rank0].npz`` and the periodic
    ``snapshot_iter_<N>.npz`` of ``extensions.snapshot()``, and the step
    directories ``preempt/<N>/`` of ``method='orbax'`` (kind
    ``'orbax'``).  No validity probe: :func:`auto_resume` verifies each in
    turn."""
    prefixes = (PREEMPT_PREFIX,) + tuple(extra_prefixes)
    cands = []  # (iteration, priority, kind, path)
    try:
        names = os.listdir(out)
    except OSError:
        return []
    for name in names:
        for prio, prefix in enumerate(reversed(prefixes)):
            m = re.match(re.escape(prefix) + r'(\d+)(\.rank0)?\.npz$', name)
            if m:
                cands.append((int(m.group(1)), prio, 'npz',
                              os.path.join(out, name)))
    steps = os.path.join(out, 'preempt')
    if os.path.isdir(steps):
        for name in os.listdir(steps):
            if name.isdigit():
                cands.append((int(name), len(prefixes), 'orbax',
                              os.path.join(steps, name)))
    cands.sort(key=lambda c: (c[0], c[1]), reverse=True)
    return [(kind, path, it) for it, _, kind, path in cands]


def chain_heads(out, extra_prefixes=('snapshot_iter_',)):
    """The snapshot chain with the cheap completeness probe and the
    file's mtime: ``[(kind, path, iteration, mtime)]`` newest first,
    sentinel-less and zero-byte candidates dropped (the polling view of
    a watcher; the full crc check is the caller's)."""
    rows = []
    for kind, path, it in snapshot_chain(out, extra_prefixes):
        if not serializers.checkpoint_complete(path):
            continue
        try:
            mtime = os.path.getmtime(path)
        except OSError:
            continue  # raced a concurrent clean-up
        rows.append((kind, path, it, mtime))
    return rows


def latest_snapshot(out, extra_prefixes=('snapshot_iter_',)):
    """The newest complete snapshot under ``out`` as ``(kind, path,
    iteration)``, or ``(None, None, None)``.  The highest iteration wins
    (a tie prefers the preemption snapshot); a zero-byte file or one
    without the write-complete manifest sentinel (a crash mid-write) is
    never chosen."""
    for kind, path, it in snapshot_chain(out, extra_prefixes):
        with _telemetry.span('checkpoint_verify', kind='checkpoint',
                             path=path) as sp:
            complete = serializers.checkpoint_complete(path)
            sp.set(complete=bool(complete))
        if complete:
            return kind, path, it
    return None, None, None


def _resume_orbax(updater, path, it):
    """Restore step directory ``path`` (iteration ``it``) into the live
    updater.  At the writing topology (the sidecar's world size and
    device count are this world's) each process reads the shared leaves
    and its own ZeRO-1 rows; at another topology every leaf (a raw
    restore), which the shared core reshards.  Both then go through
    ``serializers.restore_updater_from_tree``: parameters, buffers,
    optimizer state, loss scale, counters and the stream cursor, each
    leaf checked against the live updater before anything is
    assigned."""
    directory = os.path.dirname(path)
    manifest = serializers.read_orbax_manifest(directory, it)
    if not (manifest and manifest.get('complete')):
        raise failure.CheckpointCorruptError(
            'missing or incomplete manifest sidecar (torn or legacy step '
            'directory) [snapshot %s]' % path, path=path, kind='incomplete')
    rank, world = serializers._world()
    same = (manifest.get('world_size') == world
            and manifest.get('device_count') == world)
    state = serializers.restore_checkpoint(directory, None, step=it,
                                           rank=rank if same else None)
    serializers.restore_updater_from_tree(updater, state, manifest,
                                          path=path)
    return updater.iteration


def auto_resume(updater, out, extra_prefixes=('snapshot_iter_',)):
    """Restore the newest VALID snapshot under ``out`` into ``updater``
    and return the restored iteration, or None when there is none.

    Walks :func:`snapshot_chain` newest to oldest: a corrupt, torn or
    incomplete snapshot is skipped with a
    :class:`~chainermn_tpu_torch.utils.failure.CheckpointSkippedWarning`
    (never loaded, never a crash inside npz internals) and the next older
    one is tried.  An npz restores through ``serializers.resume_updater(
    path, updater, elastic=True, require_manifest=True)``, a step
    directory through :func:`_resume_orbax` (every process must take
    part: a collective); either way ZeRO-1 state written at another
    process count is resharded, and the iterator's position re-expressed
    at this run's shard size."""
    for kind, path, it in snapshot_chain(out, extra_prefixes):
        try:
            with _telemetry.span('checkpoint_resume', kind='checkpoint',
                                 path=path, snapshot_kind=kind) as sp:
                if kind == 'npz':
                    serializers.resume_updater(path, updater, elastic=True,
                                               require_manifest=True)
                else:
                    _resume_orbax(updater, path, it)
                sp.set(iteration=updater.iteration)
                return updater.iteration
        except failure.CheckpointCorruptError as e:
            _telemetry.event('checkpoint_skipped', kind='checkpoint',
                             path=path, reason=e.kind)
            warnings.warn(
                'auto_resume: skipping corrupt snapshot %s (%s: %s)'
                % (path, e.kind, e), failure.CheckpointSkippedWarning,
                stacklevel=2)
            continue
    return None

