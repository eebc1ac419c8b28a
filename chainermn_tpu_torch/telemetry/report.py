"""Offline views of a telemetry capture.

Counterpart of part of ``chainermn_tpu/telemetry/report.py``:

- the interval arithmetic of the overlap fraction (:func:`merge_intervals`,
  :func:`exposed_time`, :func:`overlap_from_intervals`): the share of one
  set of spans hidden behind another, e.g. the input side's
  ``host_batch_prep`` / ``h2d`` spans behind the ``jitted_step`` spans;
- :func:`load_rank_logs`, which reads a session directory's per-rank
  event logs back;
- the request-centric views: per-request span trees rebuilt from the
  ``kind='request'`` records, and the summary that names the worst
  request's stages;
- :func:`pipeline_summary`, the per-stage bubble rows of the pipeline
  updaters' ``pipeline:schedule`` events.

The rest of the JAX package's report (the merged step timeline, the
input-bound verdict, the doctor, the Prometheus export of a capture
directory) is ROADMAP.md A9.
"""

import glob
import json
import os

from chainermn_tpu_torch.telemetry.recorder import _percentile

#: the training step's span names, in the order a step runs them;
#: ``data_decode`` is the streaming loader's per-batch decode wait
STEP_PHASES = ('data_decode', 'host_batch_prep', 'h2d',
               'jitted_step', 'metrics_sync')

#: per-request stage vocabulary, in lifecycle order
REQUEST_STAGES = ('queue_wait', 'bucket_pack', 'prefill', 'decode',
                  'execute')

#: terminal ``kind='request'`` event vocabulary
REQUEST_OUTCOMES = ('complete', 'shed', 'error')


def request_traces(records):
    """Per-request traces from any iterable of record dicts (a live
    recorder's ``events``, or records read back from a capture), keyed
    by ``request_id``; records that are not request records are ignored.

    Each trace has the ordered ``stages``, per-stage budgets
    ``stage_ms``, the decode tick count ``n_decode``, the ``outcome``
    (``complete`` / ``shed`` / ``error`` / ``in_flight``) and ``e2e_ms``,
    the last stage's end minus the first stage's start."""
    traces = {}
    for rec in records:
        if rec.get('kind') != 'request':
            continue
        rid = rec.get('request_id')
        if rid is None:
            continue
        tr = traces.setdefault(str(rid), {
            'request_id': str(rid), 'stages': [], 'outcome': 'in_flight',
            'outcome_attrs': None})
        if 't0' in rec and 't1' in rec:
            tr['stages'].append(rec)
        elif rec.get('name') in REQUEST_OUTCOMES:
            tr['outcome'] = rec['name']
            tr['outcome_attrs'] = {
                k: v for k, v in rec.items()
                if k not in ('type', 'name', 'kind', 'request_id')}
    for tr in traces.values():
        tr['stages'].sort(key=lambda s: (s['t0'], s['t1']))
        stage_ms = {}
        n_decode = 0
        for s in tr['stages']:
            dur = max(s['t1'] - s['t0'], 0.0) * 1e3
            stage_ms[s['name']] = stage_ms.get(s['name'], 0.0) + dur
            if s['name'] == 'decode':
                n_decode += 1
        tr['stage_ms'] = {k: round(v, 3)
                          for k, v in sorted(stage_ms.items())}
        tr['n_decode'] = n_decode
        if tr['stages']:
            tr['t0'] = min(s['t0'] for s in tr['stages'])
            tr['t1'] = max(s['t1'] for s in tr['stages'])
            tr['e2e_ms'] = round((tr['t1'] - tr['t0']) * 1e3, 3)
        else:
            tr['t0'] = tr['t1'] = None
            tr['e2e_ms'] = None
    return traces


def request_summary(records):
    """How many requests were traced, their end-to-end latency
    distribution, per-stage p99 budgets and the worst completed request's
    decomposition; None when the records hold no request record."""
    traces = request_traces(records)
    if not traces:
        return None
    timed = [t for t in traces.values() if t['e2e_ms'] is not None]
    done = [t for t in timed if t['outcome'] == 'complete']
    shed = [t for t in traces.values() if t['outcome'] == 'shed']
    e2e = sorted(t['e2e_ms'] for t in done)
    stage_samples = {}
    for t in done:
        for name, ms in t['stage_ms'].items():
            stage_samples.setdefault(name, []).append(ms)
    worst = max(done, key=lambda t: t['e2e_ms']) if done else None
    out = {
        'count': len(traces),
        'completed': len(done),
        'shed': len(shed),
        'in_flight': sum(1 for t in traces.values()
                         if t['outcome'] == 'in_flight'),
        'e2e_ms': ({} if not e2e else {
            'count': len(e2e),
            'p50': round(_percentile(e2e, 0.50), 3),
            'p99': round(_percentile(e2e, 0.99), 3),
            'max': round(e2e[-1], 3)}),
        'stage_p99_ms': {
            name: round(_percentile(sorted(vals), 0.99), 3)
            for name, vals in sorted(stage_samples.items())},
    }
    if worst is not None:
        out['worst'] = {
            'request_id': worst['request_id'],
            'e2e_ms': worst['e2e_ms'],
            'stage_ms': worst['stage_ms'],
            'stage_sum_ms': round(sum(worst['stage_ms'].values()), 3),
            'n_decode': worst['n_decode'],
            'outcome': worst['outcome'],
        }
    return out


# ---------------------------------------------------------------------
# interval arithmetic

def merge_intervals(intervals):
    """Union of ``(t0, t1)`` pairs as a sorted disjoint list."""
    ivs = sorted((t0, t1) for t0, t1 in intervals if t1 > t0)
    out = []
    for t0, t1 in ivs:
        if out and t0 <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], t1))
        else:
            out.append((t0, t1))
    return out


def exposed_time(span, merged):
    """Length of ``span`` not covered by the merged interval union."""
    t0, t1 = span
    exposed = t1 - t0
    for m0, m1 in merged:
        if m1 <= t0:
            continue
        if m0 >= t1:
            break
        exposed -= min(t1, m1) - max(t0, m0)
    return max(exposed, 0.0)


def overlap_from_intervals(collective, compute):
    """Overlap statistics of two interval lists (seconds in, seconds
    out): how much of the first list's time (unioned first, so nested or
    concurrent spans count wall time once) ran while an interval of the
    second was open.  The names are the JAX package's, whose report
    holds collectives against compute; ``overlap_fraction`` is None when
    the first list is empty."""
    coll = merge_intervals(collective)
    total = sum(t1 - t0 for t0, t1 in coll)
    merged = merge_intervals(compute)
    exposed = sum(exposed_time((t0, t1), merged) for t0, t1 in coll)
    return {
        'total_collective_s': total,
        'exposed_collective_s': exposed,
        'hidden_collective_s': max(total - exposed, 0.0),
        'overlap_fraction': (None if total <= 0.0
                             else max(0.0, min(1.0, 1.0 - exposed
                                               / total))),
    }


# ---------------------------------------------------------------------
# loading

def load_rank_logs(outdir):
    """``(metas, spans, events, bad)`` from every ``events-rank*.jsonl``
    under a session directory; ``bad`` counts unparseable lines, which
    are skipped (a crashed rank leaves a torn tail)."""
    metas, spans, events = [], [], []
    bad = 0
    for path in sorted(glob.glob(
            os.path.join(outdir, 'events-rank*.jsonl'))):
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    bad += 1
                    continue
                t = rec.get('type')
                if t == 'meta':
                    metas.append(rec)
                elif t == 'span':
                    spans.append(rec)
                elif t == 'event':
                    events.append(rec)
    return metas, spans, events, bad


def pipeline_summary(events):
    """The pipeline view of a capture: one row per distinct pipelined
    step configuration, from the ``pipeline:schedule`` events the
    pipeline updaters emit at their first step (``kind='pipeline'``;
    schedule, micro-batch count, stage count, ticks, stage axis).

    The bubble fraction (idle work slots per stage per step) is the
    schedule's arithmetic
    (:func:`chainermn_tpu_torch.parallel.pipeline.bubble_fraction`), a
    property of ``(n_micro, n_stages)``: in ``[0, 1]`` per stage and
    strictly decreasing in the micro-batch count at fixed stages.  None
    when the capture holds no pipeline event."""
    scheds = [e for e in events
              if e.get('kind') == 'pipeline'
              and e.get('name') == 'pipeline:schedule']
    if not scheds:
        return None
    from chainermn_tpu_torch.parallel.pipeline import (
        bubble_fractions_per_stage)
    out, seen = [], set()
    for e in scheds:
        try:
            key = (e.get('schedule') or '1f1b',
                   int(e.get('n_micro') or 0),
                   int(e.get('n_stages') or 0))
        except (TypeError, ValueError):
            continue
        if key in seen or key[1] < 1 or key[2] < 1:
            continue
        seen.add(key)
        per_stage = bubble_fractions_per_stage(key[1], key[2], key[0])
        axes = e.get('axes')
        out.append({
            'schedule': key[0],
            'n_micro': key[1],
            'n_stages': key[2],
            'total_ticks': e.get('total_ticks'),
            'axis': (axes[0] if isinstance(axes, (list, tuple))
                     and axes else 'stage'),
            'bubble_fraction': round(per_stage[0], 6),
            'bubble_fraction_per_stage': [round(b, 6)
                                          for b in per_stage],
        })
    return out or None
