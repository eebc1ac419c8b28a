"""Span/event recorder and metrics registry.

Counterpart of the part of ``chainermn_tpu/telemetry/recorder.py`` the
serving path uses: :class:`Counter`, :class:`Gauge`, :class:`Histogram`
(raw samples, nearest-rank p50/p90/p99), :class:`Registry`,
:func:`snapshot_to_prometheus`, and :class:`Recorder` with ``span`` /
``event`` / ``child_span`` / ``now`` / ``flush``.

- **Zero cost when off.**  Call sites go through the package-level
  functions of :mod:`chainermn_tpu_torch.telemetry`, whose disabled path
  returns a preallocated no-op context.
- **Monotonic spans, wall-aligned.**  Durations come from
  ``time.perf_counter()``; every recorded time is on the wall clock
  through an anchor pair taken at construction.
- **Optional device fences.**  A span around device work measures the
  launch unless the session asked for fences: then ``span.sync(out)``
  waits for the work queued on the calling thread's current stream of
  the device of a CUDA tensor (a prefetch thread's copy stream, the
  training loop's compute stream) before the span closes, and the span
  is tagged ``synced=True``.  Waiting for that stream alone keeps a
  fenced copy span from swallowing the step running beside it.

Event-log schema (JSONL, one file per rank, first line ``meta``)::

    {"type": "meta", "rank": 0, "pid": 123, "wall0": ..., "argv": ...}
    {"type": "span", "name": "serve_execute", "kind": "serve",
     "t0": <wall s>, "t1": <wall s>, "rank": 0, ...attrs}
    {"type": "event", "name": "weight_swap", "kind": "serve",
     "t": <wall s>, "rank": 0, ...attrs}

The flight recorder (``dump_flight``, the ring of the last records, open
spans) and the streaming listeners of the SLO monitor are ROADMAP.md A9.
"""

import contextlib
import json
import os
import sys
import threading
import time

#: histogram sample retention cap (the newest samples win)
MAX_SAMPLES = 65536
#: event-log retention cap per rank (the newest window wins)
MAX_EVENTS = 1 << 20


def _percentile(sorted_vals, q):
    """Nearest-rank percentile of an ascending list."""
    if not sorted_vals:
        return None
    n = len(sorted_vals)
    return sorted_vals[min(n - 1, int(n * q))]


class Counter:
    """Monotonically increasing count (Prometheus ``counter``)."""

    kind = 'counter'

    def __init__(self, name, help=''):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n=1.0):
        self.value += n

    def snapshot(self):
        snap = {'type': 'counter', 'value': self.value}
        if self.help:
            snap['help'] = self.help
        return snap


class Gauge:
    """Last-written value (Prometheus ``gauge``)."""

    kind = 'gauge'

    def __init__(self, name, help=''):
        self.name = name
        self.help = help
        self.value = None

    def set(self, v):
        self.value = float(v)

    def snapshot(self):
        snap = {'type': 'gauge', 'value': self.value}
        if self.help:
            snap['help'] = self.help
        return snap


class Histogram:
    """Sample-retaining distribution with p50/p90/p99 summaries: the raw
    samples (the newest :data:`MAX_SAMPLES`) are kept, so snapshots of
    several ranks merge exactly."""

    kind = 'histogram'

    def __init__(self, name, help=''):
        self.name = name
        self.help = help
        self.samples = []
        self.count = 0
        self.total = 0.0

    def observe(self, v):
        v = float(v)
        self.count += 1
        self.total += v
        self.samples.append(v)
        if len(self.samples) > MAX_SAMPLES:
            del self.samples[:len(self.samples) - MAX_SAMPLES]

    def summary(self):
        s = sorted(self.samples)
        if not s:
            return {'count': 0, 'sum': 0.0}
        return {
            'count': self.count,
            'sum': self.total,
            'min': s[0],
            'max': s[-1],
            'mean': sum(s) / len(s),
            'p50': _percentile(s, 0.50),
            'p90': _percentile(s, 0.90),
            'p99': _percentile(s, 0.99),
        }

    def snapshot(self):
        snap = {'type': 'histogram', 'count': self.count,
                'sum': self.total, 'samples': list(self.samples),
                'summary': self.summary()}
        if self.help:
            snap['help'] = self.help
        return snap


class Registry:
    """Named metrics, one instance per recorder."""

    def __init__(self):
        self._metrics = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help)
            elif not isinstance(m, cls):
                raise TypeError(
                    'metric %r already registered as %s, requested %s'
                    % (name, type(m).__name__, cls.__name__))
            return m

    def counter(self, name, help=''):
        return self._get(Counter, name, help)

    def gauge(self, name, help=''):
        return self._get(Gauge, name, help)

    def histogram(self, name, help=''):
        return self._get(Histogram, name, help)

    def names(self):
        return sorted(self._metrics)

    def snapshot(self):
        with self._lock:
            items = sorted(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def to_prometheus(self, prefix='chainermn_tpu_'):
        """Prometheus text exposition (0.0.4); histograms export as
        summaries."""
        return snapshot_to_prometheus(self.snapshot(), prefix=prefix)


def _prom_name(prefix, name):
    out = []
    for ch in prefix + name:
        out.append(ch if (ch.isalnum() and ch.isascii()) or ch in '_:'
                   else '_')
    head = out[0] if out else '_'
    if not (head.isalpha() or head in '_:'):
        out.insert(0, '_')
    return ''.join(out)


def escape_label_value(value):
    """Prometheus label-value escaping: backslash, quote, newline."""
    return (str(value).replace('\\', r'\\').replace('"', r'\"')
            .replace('\n', r'\n'))


def escape_help(text):
    """``# HELP`` line escaping: backslash and newline."""
    return str(text).replace('\\', r'\\').replace('\n', r'\n')


def _labels_text(labels):
    if not labels:
        return ''
    return '{%s}' % ','.join(
        '%s="%s"' % (k, escape_label_value(v))
        for k, v in sorted(labels.items()))


def snapshot_to_prometheus(snapshot, prefix='chainermn_tpu_'):
    """Render a registry snapshot as Prometheus text: ``# HELP`` beside
    ``# TYPE`` where a metric has help text, a snapshot's optional
    ``labels`` on counter and gauge lines, histograms as summaries
    (``{quantile="0.5"}``, ``_count``, ``_sum``)."""
    lines = []
    for name, snap in sorted(snapshot.items()):
        pname = _prom_name(prefix, name)
        kind = snap.get('type')
        help_text = snap.get('help')
        if kind in ('counter', 'gauge'):
            v = snap.get('value')
            if v is None:
                continue
            if help_text:
                lines.append('# HELP %s %s'
                             % (pname, escape_help(help_text)))
            lines.append('# TYPE %s %s' % (pname, kind))
            lines.append('%s%s %s' % (pname,
                                      _labels_text(snap.get('labels')),
                                      repr(float(v))))
        elif kind == 'histogram':
            summ = snap.get('summary') or {}
            if help_text:
                lines.append('# HELP %s %s'
                             % (pname, escape_help(help_text)))
            lines.append('# TYPE %s summary' % pname)
            for q in ('p50', 'p90', 'p99'):
                if summ.get(q) is not None:
                    lines.append('%s{quantile="0.%s"} %s'
                                 % (pname, q[1:], repr(summ[q])))
            lines.append('%s_count %s'
                         % (pname, repr(float(snap.get('count', 0)))))
            lines.append('%s_sum %s'
                         % (pname, repr(float(snap.get('sum', 0.0)))))
    return '\n'.join(lines) + '\n' if lines else ''


class _SpanHandle:
    """What ``with recorder.span(...) as sp`` yields: attributes found
    mid-span (``sp.set``) and the device fence (``sp.sync``)."""

    __slots__ = ('_recorder', 'attrs', 'synced')

    def __init__(self, recorder, attrs):
        self._recorder = recorder
        self.attrs = attrs
        self.synced = False

    def set(self, **attrs):
        self.attrs.update(attrs)

    def sync(self, value):
        """Wait for the current stream of the card before the span
        closes -- only when the session asked for fences and ``value`` is
        a CUDA tensor (or a tuple or list holding one); otherwise a
        no-op."""
        if self._recorder.sync_fences and value is not None:
            items = value if isinstance(value, (tuple, list)) else (value,)
            for t in items:
                if getattr(t, 'is_cuda', False):
                    import torch
                    torch.cuda.current_stream(t.device).synchronize()
                    self.synced = True
                    break
        return value


class _NullSpan:
    """Preallocated no-op context for the disabled path."""

    __slots__ = ()
    attrs = None
    synced = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def sync(self, value):
        return value


NULL_SPAN = _NullSpan()


class Recorder:
    """One process's telemetry session: spans, events, metrics, and the
    per-rank JSONL / JSON flush."""

    def __init__(self, outdir=None, sync_fences=False):
        self.outdir = outdir
        self.sync_fences = bool(sync_fences)
        self.registry = Registry()
        self.events = []
        self._lock = threading.Lock()
        # every recorded time is wall0 + (perf_counter() - mono0)
        self._mono0 = time.perf_counter()
        self._wall0 = time.time()
        self._flushed_upto = 0
        self._meta_written = False

    def now(self):
        return self._wall0 + (time.perf_counter() - self._mono0)

    def _append(self, rec):
        with self._lock:
            self.events.append(rec)
            if len(self.events) > MAX_EVENTS:
                # flushed records are on disk already: trim the front and
                # move the flush cursor with it
                drop = len(self.events) - MAX_EVENTS
                del self.events[:drop]
                self._flushed_upto = max(0, self._flushed_upto - drop)

    @contextlib.contextmanager
    def span(self, name, kind='generic', **attrs):
        handle = _SpanHandle(self, attrs)
        t0 = self.now()
        try:
            yield handle
        finally:
            rec = {'type': 'span', 'name': name, 'kind': kind,
                   't0': t0, 't1': self.now()}
            if handle.synced:
                rec['synced'] = True
            if handle.attrs:
                rec.update(handle.attrs)
            self._append(rec)

    def event(self, name, kind='event', **attrs):
        rec = {'type': 'event', 'name': name, 'kind': kind,
               't': self.now()}
        if attrs:
            rec.update(attrs)
        self._append(rec)

    def child_span(self, request_id, name, t0, t1=None, kind='request',
                   **attrs):
        """Record one already-timed stage of a request's trace (one dict
        and an append): ``t0`` (and ``t1``, default now) on this
        recorder's clock (:meth:`now`), so that each stage starts where
        the previous one ended and the stages tile the request's
        end-to-end latency."""
        rec = {'type': 'span', 'name': name, 'kind': kind,
               'request_id': request_id, 't0': t0,
               't1': self.now() if t1 is None else t1}
        if attrs:
            rec.update(attrs)
        self._append(rec)

    @staticmethod
    def _rank():
        import torch.distributed as dist
        return dist.get_rank() if dist.is_initialized() else 0

    def flush(self, outdir=None):
        """Append the unwritten events to ``events-rank<N>.jsonl`` and
        rewrite ``metrics-rank<N>.json`` under ``outdir`` (default the
        session's); incremental and idempotent.  Returns the event log's
        path, or None for an in-memory session."""
        outdir = outdir or self.outdir
        if outdir is None:
            return None
        os.makedirs(outdir, exist_ok=True)
        rank = self._rank()
        epath = os.path.join(outdir, 'events-rank%d.jsonl' % rank)
        with self._lock:
            pending = self.events[self._flushed_upto:]
            self._flushed_upto = len(self.events)
        with open(epath, 'a') as f:
            if not self._meta_written:
                f.write(json.dumps({
                    'type': 'meta', 'rank': rank, 'pid': os.getpid(),
                    'wall0': self._wall0, 'sync_fences': self.sync_fences,
                    'argv': list(sys.argv)}) + '\n')
                self._meta_written = True
            for rec in pending:
                f.write(json.dumps(dict(rec, rank=rank)) + '\n')
        mpath = os.path.join(outdir, 'metrics-rank%d.json' % rank)
        tmp = mpath + '.tmp'
        with open(tmp, 'w') as f:
            json.dump({'rank': rank,
                       'metrics': self.registry.snapshot()}, f)
        os.replace(tmp, mpath)
        return epath
