"""Trainer: the outer loop.

Counterpart of ``chainermn_tpu/training/trainer.py`` (the Chainer
``Trainer`` the reference wires up at ``train_mnist.py:99-121``): run
the updater until the stop trigger fires, calling extensions
(evaluation, logging, snapshots) on their own triggers in descending
priority, with each iteration's metrics in ``observation``.
"""

import os
import time
import traceback

from chainermn_tpu_torch.training import triggers as triggers_mod


class _ExtensionEntry:
    def __init__(self, extension, trigger, name, priority):
        self.extension = extension
        self.trigger = triggers_mod.get_trigger(trigger)
        self.name = name
        self.priority = priority


class Trainer:
    """``Trainer(updater, (N, 'epoch'), out='result').run()``.

    ``out`` is made when :meth:`run` starts; extensions write their
    files there.

    ``async_metrics=True`` calls ``updater.update(sync=False)``: each
    iteration's metrics stay 0-d device tensors, so the loop queues step
    n+1 while step n still runs on the device instead of waiting for it
    every iteration.  Extensions convert them where they use them
    (``LogReport`` at its emit, ``PrintReport`` at its trigger,
    ``NanGuard`` at its audit).  Every ``sync_interval`` iterations the
    loop reads one scalar, which waits for everything queued up to that
    step and so bounds how far the host runs ahead.
    """

    def __init__(self, updater, stop_trigger=(1, 'epoch'), out='result',
                 async_metrics=False, sync_interval=16):
        self.updater = updater
        self.stop_trigger = triggers_mod.get_trigger(stop_trigger)
        self.out = out
        self.async_metrics = bool(async_metrics)
        self.sync_interval = max(1, int(sync_interval))
        self.observation = {}
        self.elapsed_time = 0.0
        self._extensions = []
        self._stop_requested = False
        self.stop_reason = None

    def stop(self, reason=None):
        """Request a clean stop at the current iteration boundary (any
        extension may call it); :meth:`run` returns normally with
        ``stop_reason`` set."""
        self._stop_requested = True
        self.stop_reason = reason

    def extend(self, extension, trigger=None, name=None, priority=None):
        """Call ``extension(trainer)`` whenever ``trigger`` fires; a dict
        it returns is merged into ``observation``.  ``trigger``,
        ``priority`` and ``name`` default to the extension's own
        attributes of those names, else ``(1, 'epoch')``, 100 and its
        ``__name__``."""
        if trigger is None:
            trigger = getattr(extension, 'trigger', (1, 'epoch'))
        if priority is None:
            priority = getattr(extension, 'priority', 100)
        if name is None:
            name = getattr(extension, 'name', None) or getattr(
                extension, '__name__', type(extension).__name__)
        self._extensions.append(
            _ExtensionEntry(extension, trigger, name, priority))
        return self

    def run(self):
        if self.out:
            os.makedirs(self.out, exist_ok=True)
        start = time.time()
        entries = sorted(self._extensions, key=lambda e: -e.priority)
        try:
            while not (self._stop_requested or self.stop_trigger(self)):
                if self.async_metrics:
                    self.observation = self.updater.update(sync=False)
                    if self.updater.iteration % self.sync_interval == 0:
                        # one scalar: waits for every step queued so far
                        for v in self.observation.values():
                            float(v)
                            break
                else:
                    self.observation = self.updater.update()
                self.elapsed_time = time.time() - start
                for entry in entries:
                    if entry.trigger(self):
                        result = entry.extension(self)
                        if isinstance(result, dict):
                            self.observation.update(result)
                    if self._stop_requested:
                        break
        finally:
            self._finalize_extensions()

    def _finalize_extensions(self):
        """Each extension's ``finalize()``, however the loop ended; a
        raising finalizer is reported and does not mask the loop's own
        exception or skip its siblings."""
        for entry in self._extensions:
            fin = getattr(entry.extension, 'finalize', None)
            if fin is None:
                continue
            try:
                fin()
            except Exception:
                traceback.print_exc()
