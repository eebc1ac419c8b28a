"""Trainer extensions.

Counterpart of ``chainermn_tpu/training/extensions.py``: the Chainer
extensions the reference examples register, ``LogReport`` /
``PrintReport`` (``train_mnist.py:107-115``, gated to rank 0),
``ProgressBar`` and ``snapshot`` (``train_mnist.py:117-118``, through
:mod:`chainermn_tpu_torch.serializers`).  The evaluator lives in
:mod:`chainermn_tpu_torch.training.evaluator`.
"""

import json
import os
import sys

import torch
import torch.distributed as dist

from chainermn_tpu_torch import serializers
from chainermn_tpu_torch.training import triggers as triggers_mod


def _rank():
    """This process's rank (0 outside a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def _as_float(v):
    """A host float from a metric value (a number or a 0-d tensor or
    array); None for anything else."""
    if isinstance(v, (int, float)) or getattr(v, 'ndim', None) == 0:
        return float(v)
    return None


class LogReport:
    """Accumulate observations every iteration and emit interval means
    to ``out/log`` (JSON) on the emit trigger (the constructor's
    ``trigger``, default per epoch) -- Chainer-LogReport semantics.

    ``keys`` (default: all) limits the keys it reports, as Chainer's
    does.  Each key keeps its own count, so a key reported once an
    epoch (the validation metrics) is not diluted by the iterations
    without it.
    Register it WITHOUT a trigger (``trainer.extend(LogReport())``) so
    it runs every iteration; the emitted entry also overwrites the
    same keys of ``trainer.observation``, so a lower-priority
    ``PrintReport`` prints interval means.  ``rank0_only`` writes the
    file on rank 0 alone (the reference gates by ``comm.rank == 0`` at
    ``train_mnist.py:107``).
    """

    trigger = (1, 'iteration')  # called every iteration; emits below
    priority = 200
    name = 'log_report'

    def __init__(self, keys=None, trigger=(1, 'epoch'), filename='log',
                 rank0_only=True):
        self.keys = keys
        self._emit_trigger = triggers_mod.get_trigger(trigger)
        self.filename = filename
        self.rank0_only = rank0_only
        self.log = []
        self._accum = {}
        self._counts = {}

    def accumulate(self, observation):
        """Add one iteration's values.  A 0-d tensor (the metrics of
        ``Trainer(async_metrics=True)``) is summed on its device in
        float64 -- the same sums as of host floats, with no host sync --
        and read at emit."""
        for k, v in observation.items():
            if self.keys is not None and k not in self.keys:
                continue
            if torch.is_tensor(v) and v.ndim == 0:
                v = v.detach().to(torch.float64)
            elif _as_float(v) is not None:
                v = float(v)
            else:
                continue
            self._accum[k] = self._accum.get(k, 0.0) + v
            self._counts[k] = self._counts.get(k, 0) + 1

    def __call__(self, trainer):
        self.accumulate(trainer.observation)
        if not self._emit_trigger(trainer):
            return None
        entry = {k: float(v) / self._counts[k]
                 for k, v in self._accum.items()}
        entry.update(epoch=trainer.updater.epoch,
                     iteration=trainer.updater.iteration,
                     elapsed_time=trainer.elapsed_time)
        self.log.append(entry)
        self._accum, self._counts = {}, {}
        if trainer.out and (not self.rank0_only or _rank() == 0):
            with open(os.path.join(trainer.out, self.filename), 'w') as f:
                json.dump(self.log, f, indent=1)
        return entry


class PrintReport:
    """Print selected observation keys as a table row, under a header
    printed once (the reference registers it at
    ``train_mnist.py:108-111``).  A 0-d tensor is read here, at this
    extension's own trigger."""

    trigger = (1, 'epoch')
    priority = 100
    name = 'print_report'

    def __init__(self, entries, rank0_only=True, out=sys.stdout):
        self.entries = entries
        self.rank0_only = rank0_only
        self._out = out
        self._header_done = False

    def __call__(self, trainer):
        if self.rank0_only and _rank() != 0:
            return
        if not self._header_done:
            self._out.write(''.join('%-16s' % e for e in self.entries)
                            + '\n')
            self._header_done = True
        obs = dict(trainer.observation,
                   epoch=trainer.updater.epoch,
                   iteration=trainer.updater.iteration,
                   elapsed_time=trainer.elapsed_time)
        row = []
        for e in self.entries:
            v = obs.get(e, '')
            f = _as_float(v)
            row.append('%-16s' % (('%.6g' % f) if f is not None else v))
        self._out.write(''.join(row) + '\n')
        self._out.flush()


def snapshot(filename='snapshot_iter_{iteration}', rank0_only=True):
    """Checkpoint the trainer's state -- the tree
    :func:`~chainermn_tpu_torch.serializers.updater_state` defines
    (parameters, optimizer state, counters) -- as an npz file under
    ``trainer.out`` (``filename`` is formatted with the iteration)."""

    def ext(trainer):
        u = trainer.updater
        # a ZeRO or tensor-parallel updater gathers its state across the
        # processes: every process takes part, rank 0 writes
        collective = getattr(u, 'collective_state', False)
        if rank0_only and _rank() != 0 and not collective:
            return
        state = serializers.updater_state(u)
        if rank0_only and _rank() != 0:
            return
        path = os.path.join(trainer.out,
                            filename.format(iteration=u.iteration))
        serializers.save_npz(path, state,
                             mesh_shape=serializers.mesh_shape_of(u))

    ext.trigger = (1, 'epoch')
    ext.priority = 50
    ext.name = 'snapshot'
    return ext


class ProgressBar:
    """Minimal stderr progress line (in place of Chainer's
    ``ProgressBar`` at ``train_mnist.py:115``)."""

    trigger = (1, 'iteration')
    priority = 10
    name = 'progress'

    def __init__(self, update_interval=100):
        self.update_interval = update_interval

    def __call__(self, trainer):
        u = trainer.updater
        if u.iteration % self.update_interval:
            return
        sys.stderr.write('\riter %d epoch %d' % (u.iteration, u.epoch))
        sys.stderr.flush()
