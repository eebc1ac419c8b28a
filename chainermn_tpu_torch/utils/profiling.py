"""Profiling and tracing: device traces, named regions, a step timer and
an op microbenchmark.

Counterpart of ``chainermn_tpu/utils/profiling.py``:

- :func:`trace` records the enclosed block with ``torch.profiler`` (CPU,
  and CUDA when the card is there) and writes a Chrome trace
  (``trace.json``, viewable in Perfetto) under ``logdir``;
- :func:`annotate` is a named region in that trace
  (``torch.profiler.record_function``);
- :class:`StepTimer` is throughput accounting for a training loop, as a
  trainer extension or standalone;
- :func:`benchmark_op` times a callable: on CUDA outputs between CUDA
  events with one synchronisation at the end, else on the host clock;
- :func:`memory_stats` is ``torch.cuda.memory_stats`` of a device (``{}``
  for the CPU); :func:`save_device_profile` traces one call.

Timing source of truth: :mod:`chainermn_tpu_torch.telemetry`.
``StepTimer`` and ``benchmark_op`` record into a telemetry histogram, the
active session's (so step times ride the session's ``metrics.json`` and
Prometheus exports) or a standalone one; ``StepTimer`` also records one
``step`` span per tick into an active session's timeline.
"""

import contextlib
import json
import os
import time

import torch

from chainermn_tpu_torch import telemetry as _telemetry


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(logdir):
    """Record the enclosed block with ``torch.profiler`` and write its
    Chrome trace as ``logdir/trace.json``; yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=_activities())
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, 'trace.json'))


def annotate(name):
    """Named region visible in the trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Throughput accounting for a training loop.

    Trainer extension and standalone: call ``tick(n_items)`` per step;
    ``summary()`` gives steps/s, items/s and the step-time percentiles
    (the first ``warmup`` steps, which pay for set-up, excluded).  Step
    durations land in a telemetry histogram (the active session's
    registry under ``metric_name``, else a standalone
    :class:`~chainermn_tpu_torch.telemetry.Histogram`); each tick also
    records a ``step`` span into an active session's timeline.
    """

    trigger = (1, 'iteration')
    priority = 150
    name = 'step_timer'

    def __init__(self, items_per_step=None, warmup=2,
                 metric_name='step_time_seconds'):
        self.items_per_step = items_per_step
        self.warmup = warmup
        self.metric_name = metric_name
        reg = _telemetry.registry()
        self._hist = (reg.histogram(metric_name) if reg is not None
                      else _telemetry.Histogram(metric_name))
        self._last = None
        self._ticks = 0

    def __call__(self, trainer):  # extension protocol
        self.tick()
        if self._hist.samples:
            trainer.observation.setdefault(
                'steps_per_sec', 1.0 / self._hist.samples[-1])

    def tick(self, n_items=None):
        del n_items
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._hist.observe(dt)
            rec = _telemetry.active()
            if rec is not None:
                rec._append({'type': 'span', 'name': 'step',
                             'kind': 'compute',
                             't0': rec.now() - dt, 't1': rec.now(),
                             'timer': self.metric_name,
                             'tick': self._ticks})
        self._last = now
        self._ticks += 1

    def summary(self):
        times = (self._hist.samples[self.warmup:]
                 or self._hist.samples)
        if not times:
            return {}
        times = sorted(times)
        n = len(times)
        mean = sum(times) / n
        out = {
            'steps': n,
            'mean_step_s': mean,
            'steps_per_sec': 1.0 / mean,
            'p50_step_s': times[n // 2],
            'p99_step_s': times[min(n - 1, int(n * 0.99))],
        }
        if self.items_per_step:
            out['items_per_sec'] = self.items_per_step / mean
        return out

    def dump(self, path):
        with open(path, 'w') as f:
            json.dump(self.summary(), f, indent=1)


def _cuda_device(out):
    """The device of the first CUDA tensor in ``out`` (a tensor, or a
    tuple / list / dict holding tensors), else None."""
    if torch.is_tensor(out):
        return out.device if out.is_cuda else None
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        for item in out:
            dev = _cuda_device(item)
            if dev is not None:
                return dev
    return None


def benchmark_op(fn, *args, n_steps=20, warmup=3,
                 metric_name='benchmark_op_seconds'):
    """Mean seconds per call of ``fn(*args)``.  When the warm-up's output
    holds a CUDA tensor, the timed calls run between two CUDA events on
    its device's current stream with one synchronisation at the end;
    otherwise the host clock times them.  The mean is also recorded into
    an active telemetry session's ``metric_name`` histogram."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    dev = _cuda_device(out)
    if dev is not None:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        for _ in range(n_steps):
            out = fn(*args)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        mean = start.elapsed_time(end) / 1e3 / n_steps
    else:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            out = fn(*args)
        mean = (time.perf_counter() - t0) / n_steps
    reg = _telemetry.registry()
    if reg is not None:
        reg.histogram(metric_name).observe(mean)
    return mean


def memory_stats(device=None):
    """``torch.cuda.memory_stats`` of ``device`` (default: the current
    CUDA device); ``{}`` for the CPU or without a card."""
    if device is not None and torch.device(device).type != 'cuda':
        return {}
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def save_device_profile(logdir, fn, *args):
    """Trace one call of ``fn(*args)`` into ``logdir`` (:func:`trace`),
    waiting for the card's work before the trace closes; returns the
    output."""
    with trace(logdir):
        out = fn(*args)
        dev = _cuda_device(out)
        if dev is not None:
            torch.cuda.synchronize(dev)
    return out
