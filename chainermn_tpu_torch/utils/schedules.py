"""Distributed learning-rate recipes.

Counterpart of ``chainermn_tpu/utils/schedules.py``: scale the learning
rate linearly with the global batch and ramp it up over the first
epochs (the large-batch recipe behind the reference's 128-GPU ResNet-50
run).  Every helper returns a plain ``step -> lr`` callable, which
``ops.FusedMomentumSGD`` takes as its ``lr``; ``step`` counts optimizer
updates (one per global batch), from 0.

The JAX helpers return ``optax`` schedules.  This module gives the same
values without optax: :func:`linear_schedule`,
:func:`cosine_decay_schedule`, :func:`join_schedules`,
:func:`piecewise_constant_schedule` and :func:`constant_schedule` follow
optax's definitions operation for operation, in float32 as optax
computes them under JAX's default 32-bit mode (the cosine is rounded to
float32 from a double), so the rates agree with the JAX package's to
the last bit or so, also where the cosine tail cancels.
"""

import math

import numpy as np

__all__ = ['linear_scaled_lr', 'gradual_warmup',
           'distributed_sgd_schedule', 'constant_schedule',
           'linear_schedule', 'cosine_decay_schedule', 'join_schedules',
           'piecewise_constant_schedule']

_f32 = np.float32


def constant_schedule(value):
    """``optax.constant_schedule``."""
    return lambda count: float(_f32(value))


def linear_schedule(init_value, end_value, transition_steps,
                    transition_begin=0):
    """``optax.linear_schedule``: ``init_value`` before
    ``transition_begin``, then linear to ``end_value`` over
    ``transition_steps`` steps, then ``end_value``.  With
    ``transition_steps <= 0`` it stays at ``init_value``."""
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(transition_begin, 0)
    span = _f32(init_value - end_value)

    def schedule(count):
        count = min(max(count - transition_begin, 0), transition_steps)
        frac = _f32(1) - _f32(count) / _f32(transition_steps)
        return float(span * frac + _f32(end_value))

    return schedule


def cosine_decay_schedule(init_value, decay_steps, alpha=0.0,
                          exponent=1.0):
    """``optax.cosine_decay_schedule``: ``init_value`` times
    ``(1 - alpha) * (0.5 * (1 + cos(pi * t / T))) ** exponent + alpha``,
    ``t`` clipped at ``T = decay_steps``."""
    if not decay_steps > 0:
        raise ValueError('cosine_decay_schedule needs positive decay_steps, '
                         'got %r' % (decay_steps,))

    def schedule(count):
        t = _f32(min(count, decay_steps))
        x = _f32(np.pi) * t / _f32(decay_steps)
        cosine = _f32(0.5) * (_f32(1) + _f32(math.cos(float(x))))
        decayed = (_f32(1 - alpha) * cosine ** _f32(exponent)
                   + _f32(alpha))
        return float(_f32(init_value) * decayed)

    return schedule


def join_schedules(schedules, boundaries):
    """``optax.join_schedules``: ``schedules[i + 1]`` from
    ``boundaries[i]`` on, counting its steps from that boundary."""

    def schedule(step):
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def piecewise_constant_schedule(init_value, boundaries_and_scales=None):
    """``optax.piecewise_constant_schedule``: ``init_value`` scaled by
    every ``scale`` whose boundary ``count`` has reached."""
    if boundaries_and_scales is not None and any(
            s < 0.0 for s in boundaries_and_scales.values()):
        raise ValueError('piecewise_constant_schedule expects non-negative '
                         'scale factors')
    steps = sorted((boundaries_and_scales or {}).items())

    def schedule(count):
        v = _f32(init_value)
        for threshold, scale in steps:
            if count >= threshold:
                v = _f32(scale) * v
        return float(v)

    return schedule


def linear_scaled_lr(base_lr, global_batch, base_batch=256):
    """Linear scaling rule: ``lr = base_lr * global_batch / base_batch``.

    ``base_lr`` is the single-device recipe's rate at ``base_batch``;
    growing the world grows the global batch and the rate with it."""
    if global_batch <= 0 or base_batch <= 0:
        raise ValueError('batch sizes must be positive')
    return base_lr * (global_batch / float(base_batch))


def gradual_warmup(target_lr, warmup_steps, after=None, init_factor=0.1):
    """Ramp from ``init_factor * target_lr`` to ``target_lr`` over
    ``warmup_steps``, then follow ``after`` (a schedule of the
    post-warmup steps; default: constant ``target_lr``).  With
    ``warmup_steps=0`` it is just ``after``."""
    if after is None:
        after = constant_schedule(target_lr)
    if warmup_steps <= 0:
        return after
    ramp = linear_schedule(init_factor * target_lr, target_lr,
                           warmup_steps)
    return join_schedules([ramp, after], [warmup_steps])


def distributed_sgd_schedule(global_batch, steps_per_epoch,
                             base_lr=0.1, base_batch=256,
                             warmup_epochs=5, total_epochs=90,
                             decay='cosine'):
    """The whole large-batch recipe: linear-scaled peak rate,
    ``warmup_epochs`` of gradual warmup, then cosine decay to 0 (or
    ``decay='step'``: /10 at epochs 30, 60 and 80)."""
    peak = linear_scaled_lr(base_lr, global_batch, base_batch)
    warmup_steps = warmup_epochs * steps_per_epoch
    rest = max(1, (total_epochs - warmup_epochs) * steps_per_epoch)
    if decay == 'cosine':
        after = cosine_decay_schedule(peak, decay_steps=rest)
    elif decay == 'step':
        after = piecewise_constant_schedule(
            peak, {(e - warmup_epochs) * steps_per_epoch: 0.1
                   for e in (30, 60, 80) if e > warmup_epochs})
    else:
        raise ValueError("decay must be 'cosine' or 'step'")
    return gradual_warmup(peak, warmup_steps, after)
