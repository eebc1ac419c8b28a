"""Typed failures of the port (the subset its ported paths raise), and
the numeric divergence detector.

Counterpart of ``chainermn_tpu/utils/failure.py``: the same class names,
bases, ``status_name`` codes and constructor arguments, so a caller
catches the same types on either package.  The JAX package's
constructors also drop a telemetry flight record; telemetry is not
ported yet (ROADMAP.md A9), so these only carry their fields.
:func:`check_finite` and :class:`NanGuard` run over the module's
parameters (the updater's flax-named ``params``) and the observation.
"""

import json
import math
import os
import sys

import torch
import torch.distributed as dist

from chainermn_tpu_torch.models.flax_weights import _leaves


class CommFailure(RuntimeError):
    """Base of the failure taxonomy."""

    status_name = 'CMN_ERROR'


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
    themselves (catches corruption the metrics lag behind).

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
        bad = [k for k, v in trainer.observation.items()
               if isinstance(v, float) and not math.isfinite(v)]
        if not bad and self.param_interval and (
                trainer.updater.iteration % self.param_interval == 0):
            bad = check_finite(trainer.updater.params, 'params/')
        if bad:
            msg = ('non-finite values at iteration %d: %s'
                   % (trainer.updater.iteration, ', '.join(bad)))
            if self.checkpoint_on_divergence:
                self._snapshot_divergence(trainer, bad)
            if self.raise_on_divergence:
                raise DivergenceError(msg)
            sys.stderr.write('NanGuard: %s\n' % msg)
