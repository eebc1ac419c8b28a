"""Typed failures of the port (the subset its ported paths raise), the
bounded-wait arithmetic of the eager channel, and the numeric
divergence detector.

Counterpart of ``chainermn_tpu/utils/failure.py``: the same class names,
bases, ``status_name`` codes and constructor arguments, so a caller
catches the same types on either package.  The JAX package's
constructors also drop a telemetry flight record; the flight recorder
is not ported yet (ROADMAP.md A9), so these only carry their fields.
:func:`check_finite` and :class:`NanGuard` run over the module's
parameters (the updater's flax-named ``params``) and the observation.
"""

import json
import math
import os
import random
import sys
import time

import torch
import torch.distributed as dist

from chainermn_tpu_torch.models.flax_weights import _leaves


class CommFailure(RuntimeError):
    """Base of the failure taxonomy."""

    status_name = 'CMN_ERROR'


class ChannelTimeout(CommFailure, TimeoutError):
    """A bounded wait expired without evidence that the peer is dead.
    Retryable: the sequence cursor of the waiting stream is never
    advanced on timeout, so the same call can simply be issued again.
    (Telling a dead peer from a slow one, ``PeerDeadError``, needs the
    liveness layer: ROADMAP.md A9.)"""

    status_name = 'CMN_TIMEOUT'


class OverloadError(CommFailure):
    """The serving admission layer REFUSED work instead of wedging: the
    bounded request queue is full, or a request's deadline expired
    before (or while) it could be executed.

    ``reason`` classifies the shed: ``'queue_full'`` | ``'deadline'`` |
    ``'shutdown'``.  ``queue_depth`` records the depth observed at the
    decision.
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


class WeightSwapError(RuntimeError):
    """A live weight hot-swap was refused or failed validation before
    cutover: the engine still holds, and keeps serving, its previous
    parameter version.  Raised by ``swap_params`` when the new tree gives
    non-finite outputs on the validation forward, or when a generation
    engine is asked to swap with sequences still in flight (their KV
    caches were banked under the old weights).  ``version`` is the
    version that was refused."""

    def __init__(self, message, version=None):
        super().__init__(message)
        self.version = version


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
            rank = dist.get_rank() if dist.is_initialized() else 0
            with open(os.path.join(out, 'divergence.json'), 'w') as f:
                json.dump({'iteration': it, 'bad': bad,
                           'checkpoint': path, 'rank': rank}, f)
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
