"""Trainer: the outer loop.

Counterpart of ``chainermn_tpu/training/trainer.py``: run the updater
until the stop trigger fires, calling extensions on their own triggers,
with each iteration's metrics in ``observation``.
"""

import time

from chainermn_tpu_torch.training import triggers as triggers_mod


class Trainer:
    """``Trainer(updater, (N, 'iteration')).run()``."""

    def __init__(self, updater, stop_trigger=(1, 'epoch')):
        self.updater = updater
        self.stop_trigger = triggers_mod.get_trigger(stop_trigger)
        self.observation = {}
        self.elapsed_time = 0.0
        self._extensions = []

    def extend(self, extension, trigger=(1, 'iteration')):
        """Call ``extension(trainer)`` whenever ``trigger`` fires; a
        dict it returns is merged into ``observation``."""
        self._extensions.append(
            (extension, triggers_mod.get_trigger(trigger)))
        return self

    def run(self):
        start = time.time()
        while not self.stop_trigger(self):
            self.observation = self.updater.update()
            self.elapsed_time = time.time() - start
            for extension, trigger in self._extensions:
                if trigger(self):
                    result = extension(self)
                    if isinstance(result, dict):
                        self.observation.update(result)
