"""Failure detection and the recovery-side failure taxonomy.

Counterpart of ``chainermn_tpu/utils/failure.py``: the same class names,
bases, ``status_name`` codes, constructor arguments, exit codes and file
formats, so a caller catches the same types on either package and each
package reads the other's heartbeat files.

- typed failures: :class:`ChannelTimeout` (a bounded wait expired, the
  peer MAY be alive) against :class:`PeerDeadError` (the peer is
  positively dead: its heartbeat went stale), :class:`ReplicaDeadError`,
  :class:`CheckpointCorruptError`, :class:`DataCorruptError`,
  :class:`OverloadError`, :class:`WeightSwapError`.  Each constructor but
  ``OverloadError``'s drops the telemetry flight record
  (:func:`_flight_dump`) where telemetry writes to a directory;
- the exit-code taxonomy (:data:`EXIT_NAMES`, :func:`exit_code_for`,
  :func:`classify_exit`): the typed failures flattened to the one channel
  that survives a process death, read by the supervisor
  (:mod:`chainermn_tpu_torch.training.supervisor`);
- liveness: :class:`Heartbeat` (``heartbeat-<rank>.json`` from a daemon
  thread), :func:`read_heartbeat`, :func:`detect_stall`,
  :func:`heartbeat_extension`;
- bounded waits: :class:`Deadline` and :class:`Backoff`;
- numeric divergence: :func:`check_finite` and :class:`NanGuard`, over
  the module's parameters (the updater's flax-named ``params``) and the
  observation.

The JAX package's ``jax.process_index()`` is the rank of the default
``torch.distributed`` group here, 0 when none is initialised.
"""

import json
import math
import os
import random
import signal as _signal
import sys
import threading
import time

import torch
import torch.distributed as dist

from chainermn_tpu_torch.models.flax_weights import _leaves


def process_index():
    """This process's rank in the default ``torch.distributed`` group, 0
    when none is initialised (the JAX package's
    ``jax.process_index()``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _flight_dump(reason, **attrs):
    """Drop the telemetry flight record at a typed-failure raise site:
    the typed constructors call this, so every raise path leaves the
    black box behind.  A no-op when telemetry is off or in-memory; never
    raises (a failing dump must not mask the typed verdict)."""
    try:
        from chainermn_tpu_torch import telemetry
        if telemetry._active is not None:
            telemetry.dump_flight(reason, **attrs)
    except Exception:
        pass


class CommFailure(RuntimeError):
    """Base of the failure taxonomy."""

    status_name = 'CMN_ERROR'


class ChannelTimeout(CommFailure, TimeoutError):
    """A bounded wait expired without evidence that the peer is dead.
    Retryable: the sequence cursor of the waiting stream is never
    advanced on timeout, so the same call can simply be issued again."""

    status_name = 'CMN_TIMEOUT'

    def __init__(self, *args):
        super().__init__(*args)
        _flight_dump('ChannelTimeout',
                     message=str(args[0]) if args else '')


class PeerDeadError(CommFailure):
    """A peer process is POSITIVELY detected dead (its heartbeat file
    went stale past the liveness window, or it is known to have exited).
    Unlike :class:`ChannelTimeout` this verdict is terminal for the
    conversation: retrying the same wait cannot succeed.

    ``process_index`` names the dead peer."""

    status_name = 'CMN_PEER_DEAD'

    def __init__(self, message, process_index=None):
        super().__init__(message)
        self.process_index = process_index
        _flight_dump('PeerDeadError', message=str(message),
                     process_index=process_index)


class ReplicaDeadError(CommFailure):
    """A serving replica is POSITIVELY detected dead (its output stream
    hit EOF, its process exited, or a call found the connection closed).
    ``replica`` names it; ``request_ids`` lists the in-flight requests it
    was carrying when it died (the requeue worklist)."""

    status_name = 'CMN_REPLICA_DEAD'

    def __init__(self, message, replica=None, request_ids=()):
        super().__init__(message)
        self.replica = replica
        self.request_ids = tuple(request_ids)
        _flight_dump('ReplicaDeadError', message=str(message),
                     replica=replica, request_ids=list(self.request_ids))


class OverloadError(CommFailure):
    """The serving admission layer REFUSED work instead of wedging: the
    bounded request queue is full, or a request's deadline expired
    before (or while) it could be executed.

    ``reason`` classifies the shed: ``'queue_full'`` | ``'deadline'`` |
    ``'shutdown'``.  ``queue_depth`` records the depth observed at the
    decision.  Unlike the other typed constructors this one drops no
    flight record: sheds fire at request rate when saturated.
    """

    status_name = 'CMN_OVERLOAD'

    def __init__(self, message, reason='queue_full', queue_depth=None):
        super().__init__(message)
        self.reason = reason
        self.queue_depth = queue_depth


class CheckpointCorruptError(ValueError):
    """A checkpoint failed integrity verification and must NOT be
    restored: truncated or unreadable file, per-leaf crc32 mismatch,
    missing write-complete sentinel, a leaf missing from the snapshot,
    or a shape / dtype mismatch against the restore template.

    ``path`` names the snapshot, ``leaf`` the offending tree path (when
    one is identifiable), and ``kind`` classifies the defect:
    ``'unreadable'`` | ``'incomplete'`` | ``'crc'`` | ``'missing'`` |
    ``'shape'`` | ``'dtype'``.  Subclasses ``ValueError``.
    """

    status_name = 'CMN_CKPT_CORRUPT'

    def __init__(self, message, path=None, leaf=None, kind=None):
        super().__init__(message)
        self.path = path
        self.leaf = leaf
        self.kind = kind
        _flight_dump('CheckpointCorruptError', message=str(message),
                     path=path, leaf=leaf, corruption_kind=kind)


class DataCorruptError(ValueError):
    """An input record failed integrity verification and must NOT be
    consumed: a flipped byte caught by the record crc32, a record
    extending past the shard's end (a torn file), or a missing or
    unparseable index sidecar.  The streaming loader catches it to skip
    and count the sample (``corrupt_skipped`` and a
    ``data_corrupt_skipped`` telemetry event).

    ``shard`` names the file, ``offset`` the byte offset and ``record``
    the in-shard record index (when identifiable); ``kind`` classifies
    the defect: ``'crc'`` | ``'truncated'`` | ``'unreadable'``.
    Subclasses ``ValueError``, as :class:`CheckpointCorruptError`."""

    status_name = 'CMN_DATA_CORRUPT'

    def __init__(self, message, shard=None, offset=None, record=None,
                 kind=None):
        super().__init__(message)
        self.shard = shard
        self.offset = offset
        self.record = record
        self.kind = kind
        _flight_dump('DataCorruptError', message=str(message),
                     shard=shard, offset=offset, record=record,
                     corruption_kind=kind)


class WeightSwapError(RuntimeError):
    """A live weight hot-swap was refused or failed validation before
    cutover: the engine still holds, and keeps serving, its previous
    parameter version.  Raised by ``swap_params`` when the new tree gives
    non-finite outputs on the validation forward, or when a generation
    engine is asked to swap with sequences still in flight (their KV
    caches were banked under the old weights).  ``version`` is the
    version that was refused."""

    def __init__(self, message, version=None):
        _flight_dump('weight_swap_failed', version=version)
        super().__init__(message)
        self.version = version


class CheckpointSkippedWarning(UserWarning):
    """Emitted (``warnings.warn``) each time ``auto_resume`` skips a
    corrupt or incomplete snapshot while walking the chain newest to
    oldest: the typed record that a fallback happened and why."""


class Deadline:
    """Absolute time budget for a (possibly multi-step) blocking
    operation.  ``timeout=None`` means unbounded (every query reports
    ``inf`` remaining); all arithmetic is on the monotonic clock.
    Slices handed to sub-waits are ``min(want, remaining)``, so the
    sum of the slices never exceeds the budget."""

    def __init__(self, timeout, clock=time.monotonic):
        self._clock = clock
        self.timeout = timeout
        self._t0 = clock()

    def elapsed(self):
        return self._clock() - self._t0

    def remaining(self):
        if self.timeout is None:
            return float('inf')
        return self.timeout - self.elapsed()

    def expired(self):
        return self.remaining() <= 0.0

    def slice(self, want, floor=1e-3):
        """Clamp a sub-wait to the remaining budget (never below
        ``floor``, so a wait API that rejects non-positive timeouts
        still gets a valid value; the caller checks :meth:`expired`
        before trusting the slice)."""
        return max(min(want, self.remaining()), floor)


class Backoff:
    """Deterministic exponential backoff: ``initial * factor**k`` capped
    at ``max_delay``, with optional jitter drawn from a SEEDED rng, so
    two processes given the same seed replay the same schedule.

    :meth:`next` gives the next delay (advancing the schedule),
    :meth:`sleep` also sleeps it, :meth:`reset` starts over."""

    def __init__(self, initial=0.05, factor=2.0, max_delay=2.0,
                 jitter=0.0, seed=0):
        if initial <= 0 or factor < 1.0 or max_delay < initial:
            raise ValueError(
                'need initial > 0, factor >= 1, max_delay >= initial')
        self.initial = initial
        self.factor = factor
        self.max_delay = max_delay
        self.jitter = jitter
        self._seed = seed
        self.reset()

    def reset(self):
        self.attempt = 0
        self._rng = random.Random(self._seed)

    def peek(self):
        """The delay :meth:`next` would return, without advancing
        (jitter left out: it is drawn when the step is taken)."""
        return min(self.initial * self.factor ** self.attempt,
                   self.max_delay)

    def next(self):
        base = self.peek()
        self.attempt += 1
        if self.jitter:
            base += base * self.jitter * self._rng.random()
        return min(base, self.max_delay * (1.0 + self.jitter))

    def sleep(self, deadline=None):
        """Sleep the next delay (clamped to ``deadline.remaining()``
        when given); returns the time slept."""
        d = self.next()
        if deadline is not None:
            d = max(min(d, deadline.remaining()), 0.0)
        if d > 0:
            time.sleep(d)
        return d

    def delays(self, n):
        """The first ``n`` delays without jitter (does not advance)."""
        return [min(self.initial * self.factor ** k, self.max_delay)
                for k in range(n)]


class DivergenceError(RuntimeError):
    """Raised by NanGuard when training produces non-finite values."""


# -- the exit-code taxonomy ------------------------------------------------
#
# The typed failures flattened to the one channel that survives a process
# death, its exit status: the supervisor classifies a dead worker from
# this code first and cross-checks the telemetry doctor's verdict second;
# ``worker_main`` maps the exceptions on the way out.  The codes live in
# the 70-79 band, clear of shells (126/127), signals (128+N) and the chaos
# injector's hard-kill defaults (42/43).

EXIT_OK = 0
EXIT_UNCAUGHT = 70         # untyped exception escaped worker_main
EXIT_PREEMPTED = 71        # clean SIGTERM evacuation, checkpoint written
EXIT_DIVERGENCE = 72       # NanGuard verdict (DivergenceError)
EXIT_CHANNEL_TIMEOUT = 73  # bounded wait expired (ChannelTimeout)
EXIT_PEER_DEAD = 74        # typed peer death observed (PeerDeadError)
EXIT_CKPT_CORRUPT = 75     # checkpoint trust failure (CheckpointCorruptError)

#: exit status -> taxonomy name (the supervisor's first classifier)
EXIT_NAMES = {
    EXIT_OK: 'clean',
    EXIT_UNCAUGHT: 'uncaught',
    EXIT_PREEMPTED: 'preempted',
    EXIT_DIVERGENCE: 'divergence',
    EXIT_CHANNEL_TIMEOUT: 'channel_timeout',
    EXIT_PEER_DEAD: 'peer_dead',
    EXIT_CKPT_CORRUPT: 'checkpoint_corrupt',
}


def exit_code_for(exc):
    """The taxonomy exit code of an exception: typed failures map to
    their own code, anything else to :data:`EXIT_UNCAUGHT` (most
    specific first: a ``PeerDeadError`` is a ``CommFailure``, a
    ``ChannelTimeout`` also a ``TimeoutError``)."""
    if isinstance(exc, PeerDeadError):
        return EXIT_PEER_DEAD
    if isinstance(exc, ChannelTimeout):
        return EXIT_CHANNEL_TIMEOUT
    if isinstance(exc, CheckpointCorruptError):
        return EXIT_CKPT_CORRUPT
    if isinstance(exc, DivergenceError):
        return EXIT_DIVERGENCE
    return EXIT_UNCAUGHT


def classify_exit(returncode):
    """The taxonomy name of a worker's exit status: ``'running'`` (None),
    ``'clean'``, a name from :data:`EXIT_NAMES`, ``'signal:NAME'`` for a
    signal death (``Popen`` reports it negative), else ``'crash'`` (the
    chaos injector's hard-kill codes 42/43 land here: an ``os._exit``
    mid-step looks like a machine loss, which the flight records
    refine)."""
    if returncode is None:
        return 'running'
    if returncode == 0:
        return 'clean'
    if returncode < 0:
        try:
            return 'signal:' + _signal.Signals(-returncode).name
        except ValueError:
            return 'signal:%d' % -returncode
    return EXIT_NAMES.get(returncode, 'crash')


def check_finite(tree, prefix=''):
    """The paths (``prefix`` + keys joined by ``/``) of the non-finite
    floating leaves of a nested dict of tensors or arrays (an empty list
    when all are finite)."""
    bad = []
    for path, leaf in _leaves(tree):
        t = torch.as_tensor(leaf)
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            bad.append(prefix + '/'.join(map(str, path)))
    return bad


class NanGuard:
    """Trainer extension: stop on non-finite metrics (every iteration)
    and, every ``param_interval`` iterations, audit the parameters
    themselves (catches corruption the metrics lag behind).  Metrics
    that are 0-d tensors (``Trainer(async_metrics=True)``) are checked
    at that audit, not every iteration.

    ``checkpoint_on_divergence``: a directory (or ``True`` for
    ``{trainer.out}/divergence``) that receives a forensic npz snapshot
    of the updater's state (``serializers.updater_state``) and a
    ``divergence.json`` naming the iteration and the offending keys,
    written BEFORE the raise.
    """

    trigger = (1, 'iteration')
    priority = 250  # before LogReport records garbage
    name = 'nan_guard'

    def __init__(self, param_interval=100, raise_on_divergence=True,
                 checkpoint_on_divergence=None):
        self.param_interval = param_interval
        self.raise_on_divergence = raise_on_divergence
        self.checkpoint_on_divergence = checkpoint_on_divergence
        self.divergence_checkpoint = None  # path once written

    def _snapshot_divergence(self, trainer, bad):
        out = self.checkpoint_on_divergence
        if out is True:
            out = os.path.join(trainer.out or '.', 'divergence')
        try:
            from chainermn_tpu_torch import serializers
            os.makedirs(out, exist_ok=True)
            it = trainer.updater.iteration
            path = serializers.save_npz(
                os.path.join(out, 'divergence_iter_%d' % it),
                serializers.updater_state(trainer.updater))
            with open(os.path.join(out, 'divergence.json'), 'w') as f:
                json.dump({'iteration': it, 'bad': bad,
                           'checkpoint': path, 'rank': process_index()},
                          f)
            self.divergence_checkpoint = path
        except Exception as e:  # forensics must not mask the verdict
            sys.stderr.write(
                'NanGuard: divergence checkpoint failed: %r\n' % e)

    def __call__(self, trainer):
        obs = trainer.observation
        bad = [k for k, v in obs.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if not bad and self.param_interval and (
                trainer.updater.iteration % self.param_interval == 0):
            # the 0-d tensor metrics of Trainer(async_metrics=True) are
            # read here only: every iteration would sync the host with
            # the device, and the audit reads the parameters anyway
            bad = [k for k, v in obs.items()
                   if getattr(v, 'ndim', None) == 0 and not isinstance(
                       v, float) and not math.isfinite(float(v))]
            if not bad:
                bad = check_finite(trainer.updater.params, 'params/')
        if bad:
            msg = ('non-finite values at iteration %d: %s'
                   % (trainer.updater.iteration, ', '.join(bad)))
            if self.checkpoint_on_divergence:
                self._snapshot_divergence(trainer, bad)
            if self.raise_on_divergence:
                raise DivergenceError(msg)
            sys.stderr.write('NanGuard: %s\n' % msg)


class Heartbeat:
    """Per-process liveness file, written from a daemon thread.

    ``path`` gets JSON ``{pid, process_index, time, iteration, stopped}``
    every ``interval`` seconds (tmp + rename, so a reader never sees a
    torn beat); pair it with :func:`detect_stall` on any observer."""

    def __init__(self, path, interval=10.0):
        self.path = path
        self.interval = interval
        self.iteration = 0
        self._stop = threading.Event()
        self._thread = None

    def start(self):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)),
                    exist_ok=True)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _write(self, stopped=False):
        tmp = self.path + '.tmp'
        with open(tmp, 'w') as f:
            json.dump({'pid': os.getpid(),
                       'process_index': process_index(),
                       'time': time.time(),
                       'iteration': self.iteration,
                       'stopped': stopped}, f)
        os.replace(tmp, self.path)

    def _run(self):
        while not self._stop.is_set():
            try:
                self._write()
            except OSError:
                pass
            self._stop.wait(self.interval)

    def beat(self, iteration=None):
        """Stamp progress (called from the training loop)."""
        if iteration is not None:
            self.iteration = iteration

    def stop(self):
        """Stop the beat thread and stamp a final ``stopped: true`` beat,
        so an observer tells a clean exit from a stall.  The final write
        is guarded as the thread's: teardown on a removed or read-only
        directory must not crash the process."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            try:
                self._write(stopped=True)
            except OSError:
                pass


def read_heartbeat(path):
    """The parsed heartbeat at ``path``, or None when the file is missing
    or unreadable."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def detect_stall(path, timeout=60.0, now=None, missing='stalled'):
    """True if the heartbeat at ``path`` is older than ``timeout``
    seconds.

    ``missing`` decides the never-started case (no file, or an unreadable
    one): ``'stalled'`` (default: no beat is a stall) or ``'alive'`` (the
    start-up grace the supervisor uses while a new worker boots)."""
    if missing not in ('stalled', 'alive'):
        raise ValueError(
            "detect_stall: missing= must be 'stalled' or 'alive', "
            'got %r' % (missing,))
    beat = read_heartbeat(path)
    if beat is None:
        return missing == 'stalled'
    now = time.time() if now is None else now
    return (now - beat.get('time', 0)) > timeout


def heartbeat_extension(out_dir, interval=10.0):
    """Trainer extension: one heartbeat file per process under
    ``out_dir`` (``heartbeat-<rank>.json``), the iteration stamped each
    call; its ``finalize`` (called by the Trainer when the run ends)
    stops the thread, so a long-lived process does not beat "alive"
    forever."""
    hb = Heartbeat(os.path.join(out_dir,
                                'heartbeat-%d.json' % process_index()),
                   interval=interval)
    hb.start()

    def ext(trainer):
        hb.beat(trainer.updater.iteration)
    ext.trigger = (1, 'iteration')
    ext.priority = 20
    ext.name = 'heartbeat'
    ext.heartbeat = hb
    ext.finalize = hb.stop
    return ext
