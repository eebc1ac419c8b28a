"""Trigger objects deciding when the loop stops and extensions fire
(counterpart of ``chainermn_tpu/training/triggers.py``): the interval
trigger, the best-value triggers and the early-stopping trigger, each
with ``state_dict`` / ``load_state_dict`` so that a resumed run keeps
its counters."""


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

    def state_dict(self):
        return {'previous': self._previous}

    def load_state_dict(self, state):
        self._previous = int(state.get('previous', 0))

    def __call__(self, trainer):
        u = trainer.updater
        if self.unit == 'iteration':
            count = u.iteration
            fire = count // self.period > self._previous // self.period
            self._previous = count
            return fire
        return bool(u.is_new_epoch and u.epoch % self.period == 0)


class BestValueTrigger:
    """Fires when a monitored observation improves (``compare`` decides
    what "better" means); checked on ``check_trigger`` intervals.

    The Chainer-surface trigger behind "snapshot the best model"
    (``MaxValueTrigger('validation/main/accuracy')``).

    RESUME CAVEAT: trainer snapshots persist updater state only, not
    trigger state -- after a crash+resume a fresh trigger has
    ``best=None`` and would overwrite the best-model snapshot with the
    first post-resume value.  Persist ``state_dict()`` alongside your
    snapshot and ``load_state_dict()`` it on resume to keep the
    high-water mark.
    """

    def __init__(self, key, compare, check_trigger=(1, 'epoch')):
        self.key = key
        self.compare = compare
        self.check = get_trigger(check_trigger)
        self.best = None

    def state_dict(self):
        # the check trigger's interval counter rides along: without it
        # a resumed trigger would fire at the first mid-interval
        # iteration instead of the next true check point
        s = {'best': self.best}
        if hasattr(self.check, 'state_dict'):
            s['check'] = self.check.state_dict()
        return s

    def load_state_dict(self, state):
        self.best = state.get('best')
        if 'check' in state and hasattr(self.check, 'load_state_dict'):
            self.check.load_state_dict(state['check'])

    def __call__(self, trainer):
        if not self.check(trainer):
            return False
        v = trainer.observation.get(self.key)
        if v is None:
            return False
        v = float(v)
        if self.best is None or self.compare(v, self.best):
            self.best = v
            return True
        return False


class MaxValueTrigger(BestValueTrigger):
    def __init__(self, key, check_trigger=(1, 'epoch')):
        super().__init__(key, lambda a, b: a > b, check_trigger)


class MinValueTrigger(BestValueTrigger):
    def __init__(self, key, check_trigger=(1, 'epoch')):
        super().__init__(key, lambda a, b: a < b, check_trigger)


class EarlyStoppingTrigger:
    """STOP trigger: fires (ends the run) when the monitored metric has
    not improved for ``patience`` consecutive checks, or when
    ``max_trigger`` is reached -- use as ``Trainer``'s
    ``stop_trigger``.

    ``mode``: 'max' (accuracy-like) or 'min' (loss-like).  On
    crash+resume, persist/restore ``state_dict()`` like
    :class:`BestValueTrigger` or accumulated patience is forgotten.
    """

    def __init__(self, key, patience=3, mode='max',
                 check_trigger=(1, 'epoch'),
                 max_trigger=(100, 'epoch')):
        if mode not in ('max', 'min'):
            raise ValueError("mode must be 'max' or 'min'")
        self.key = key
        self.patience = patience
        self.better = ((lambda a, b: a > b) if mode == 'max'
                       else (lambda a, b: a < b))
        self.check = get_trigger(check_trigger)
        self.max_trigger = get_trigger(max_trigger)
        self.best = None
        self._bad_checks = 0

    def state_dict(self):
        s = {'best': self.best, 'bad_checks': self._bad_checks}
        for name, trig in (('check', self.check),
                           ('max_trigger', self.max_trigger)):
            if hasattr(trig, 'state_dict'):
                s[name] = trig.state_dict()
        return s

    def load_state_dict(self, state):
        self.best = state.get('best')
        self._bad_checks = int(state.get('bad_checks', 0))
        for name, trig in (('check', self.check),
                           ('max_trigger', self.max_trigger)):
            if name in state and hasattr(trig, 'load_state_dict'):
                trig.load_state_dict(state[name])

    def __call__(self, trainer):
        if self.max_trigger(trainer):
            return True
        if not self.check(trainer):
            return False
        v = trainer.observation.get(self.key)
        if v is None:
            return False
        v = float(v)
        if self.best is None or self.better(v, self.best):
            self.best = v
            self._bad_checks = 0
            return False
        self._bad_checks += 1
        return self._bad_checks >= self.patience


def get_trigger(trigger):
    """Normalize ``(n, 'epoch'|'iteration')`` tuples to a trigger."""
    if trigger is None:
        return lambda trainer: False
    if callable(trigger):
        return trigger
    period, unit = trigger
    return IntervalTrigger(period, unit)
