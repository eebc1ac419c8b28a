"""Trigger objects deciding when the loop stops and extensions fire
(counterpart of ``chainermn_tpu/training/triggers.py``, interval trigger
only)."""


class IntervalTrigger:
    """Fires every ``period`` epochs or iterations.

    Edge-triggered on the count *advancing* past a multiple of the
    period, so it cannot fire at count 0 (a ``(N, 'iteration')`` stop
    trigger must not stop the run before the first update)."""

    def __init__(self, period, unit):
        if unit not in ('epoch', 'iteration'):
            raise ValueError("unit must be 'epoch' or 'iteration'")
        self.period = period
        self.unit = unit
        self._previous = 0

    def __call__(self, trainer):
        u = trainer.updater
        if self.unit == 'iteration':
            count = u.iteration
            fire = count // self.period > self._previous // self.period
            self._previous = count
            return fire
        return bool(u.is_new_epoch and u.epoch % self.period == 0)


def get_trigger(trigger):
    """Normalize ``(n, 'epoch'|'iteration')`` tuples to a trigger."""
    if trigger is None:
        return lambda trainer: False
    if callable(trigger):
        return trigger
    period, unit = trigger
    return IntervalTrigger(period, unit)
