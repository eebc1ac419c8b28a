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
  updaters' ``pipeline:schedule`` events;
- :func:`overlap_stats` (per rank and per mesh axis) and the merged
  session report of ``python -m chainermn_tpu_torch.telemetry report``:
  :func:`build_report`, :func:`render_text`, :func:`render_request_text`,
  the strict :func:`validate_prometheus` and :func:`export`
  (``merged_report.json``, ``metrics.json``, ``metrics.prom``);
- what the doctor (:mod:`~chainermn_tpu_torch.telemetry.diagnosis`)
  reads: the per-rank metrics snapshots and their merge
  (:func:`load_rank_metrics`, :func:`aggregate_metrics`), the per-step
  phase table (:func:`step_table`), the input-bound verdict
  (:func:`input_bound_stats`) and the serving summary
  (:func:`serve_summary`).
"""

import glob
import json
import os
import re

from chainermn_tpu_torch.telemetry.recorder import (_percentile,
                                                    snapshot_to_prometheus)

#: the training step's span names, in the order a step runs them;
#: ``data_decode`` is the streaming loader's per-batch decode wait
STEP_PHASES = ('data_decode', 'host_batch_prep', 'h2d',
               'jitted_step', 'metrics_sync')

#: serve-phase vocabulary: the serving engines' per-batch spans and the
#: registry histograms of the same names
SERVE_PHASES = ('serve_queue_wait', 'serve_h2d', 'serve_execute',
                'serve_warmup', 'serve_prefill', 'serve_decode',
                'serve_draft', 'serve_verify')

#: span kinds that hide a collective (the training step)
COMPUTE_KINDS = ('compute',)

#: span kinds audited for exposure (goodput's exposed collective time)
COLLECTIVE_KINDS = ('collective',)

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


def span_axes_key(span):
    """The mesh-axis tag of a collective span (``'data'``, ``'model'``,
    ``'inter,intra'`` ...), from the ``axes`` attribute the
    communicator layer records; ``'untagged'`` for spans that predate
    the tagging."""
    axes = span.get('axes')
    if isinstance(axes, (list, tuple)) and axes:
        return ','.join(str(a) for a in axes)
    return 'untagged'


def overlap_stats(spans):
    """Overlap statistics over merged telemetry spans, exposure
    judged per rank (a collective is hidden only by compute running
    on the SAME rank).  ``per_axis`` splits the same accounting by
    the collective spans' mesh-axis tag, so a composed dp x tp run
    shows WHICH axis's communication is exposed (the data-parallel
    gradient reduction vs the tensor-parallel block psums)."""
    ranks = sorted({s.get('rank', 0) for s in spans})
    total = exposed = 0.0
    per_axis = {}
    for rank in ranks:
        comp = [(s['t0'], s['t1']) for s in spans
                if s.get('rank', 0) == rank
                and s.get('kind') in COMPUTE_KINDS]
        merged = merge_intervals(comp)
        coll_spans = [s for s in spans
                      if s.get('rank', 0) == rank
                      and s.get('kind') in COLLECTIVE_KINDS]
        st = overlap_from_intervals(
            [(s['t0'], s['t1']) for s in coll_spans], comp)
        total += st['total_collective_s']
        exposed += st['exposed_collective_s']
        for s in coll_spans:
            key = span_axes_key(s)
            agg = per_axis.setdefault(
                key, {'total_collective_s': 0.0,
                      'exposed_collective_s': 0.0, 'spans': 0})
            agg['spans'] += 1
            agg['total_collective_s'] += max(s['t1'] - s['t0'], 0.0)
            agg['exposed_collective_s'] += exposed_time(
                (s['t0'], s['t1']), merged)
    for agg in per_axis.values():
        t, e = agg['total_collective_s'], agg['exposed_collective_s']
        agg['overlap_fraction'] = (
            None if t <= 0.0 else max(0.0, min(1.0, 1.0 - e / t)))
    return {
        'total_collective_s': total,
        'exposed_collective_s': exposed,
        'hidden_collective_s': max(total - exposed, 0.0),
        'overlap_fraction': (None if total <= 0.0
                             else max(0.0, min(1.0,
                                               1.0 - exposed / total))),
        'per_axis': per_axis,
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


def load_rank_metrics(outdir):
    """Per-rank metrics snapshots (``metrics-rank*.json``)."""
    out = []
    for path in sorted(glob.glob(
            os.path.join(outdir, 'metrics-rank*.json'))):
        try:
            with open(path) as f:
                out.append(json.load(f))
        except (ValueError, OSError):
            continue
    return out


def aggregate_metrics(rank_metrics):
    """One merged snapshot from per-rank snapshots: counters sum,
    gauges keep per-rank values plus the max, histograms merge raw
    samples and recompute the percentile summary (averaging per-rank
    percentiles would be wrong for skewed distributions)."""
    merged = {}
    for rm in rank_metrics:
        for name, snap in (rm.get('metrics') or {}).items():
            kind = snap.get('type')
            cur = merged.get(name)
            if kind == 'counter':
                if cur is None:
                    cur = merged[name] = {'type': 'counter',
                                          'value': 0.0}
                cur['value'] += snap.get('value') or 0.0
            elif kind == 'gauge':
                if cur is None:
                    cur = merged[name] = {'type': 'gauge',
                                          'value': None,
                                          'per_rank': []}
                v = snap.get('value')
                cur['per_rank'].append(v)
                if v is not None:
                    cur['value'] = (v if cur['value'] is None
                                    else max(cur['value'], v))
            elif kind == 'histogram':
                if cur is None:
                    cur = merged[name] = {'type': 'histogram',
                                          'count': 0, 'sum': 0.0,
                                          'samples': []}
                cur['count'] += snap.get('count') or 0
                cur['sum'] += snap.get('sum') or 0.0
                cur['samples'].extend(snap.get('samples') or [])
            if name in merged and snap.get('help'):
                merged[name].setdefault('help', snap['help'])
    for snap in merged.values():
        if snap.get('type') == 'histogram':
            s = sorted(snap['samples'])
            snap['summary'] = ({} if not s else {
                'count': snap['count'], 'sum': snap['sum'],
                'min': s[0], 'max': s[-1],
                'mean': sum(s) / len(s),
                'p50': _percentile(s, 0.50),
                'p90': _percentile(s, 0.90),
                'p99': _percentile(s, 0.99)})
    return merged


def step_table(spans):
    """Per-(rank, iteration) phase durations from the step-phase
    spans both updaters emit.  Rows sorted by (iteration, rank)."""
    rows = {}
    for s in spans:
        if s.get('name') not in STEP_PHASES or 'iteration' not in s:
            continue
        key = (int(s['iteration']), int(s.get('rank', 0)))
        row = rows.setdefault(key, {'iteration': key[0],
                                    'rank': key[1], 't0': s['t0']})
        row[s['name'] + '_ms'] = round((s['t1'] - s['t0']) * 1e3, 3)
        row['t0'] = min(row['t0'], s['t0'])
    return [rows[k] for k in sorted(rows)]


#: per-step input-side phases charged against the device step by the
#: input-bound verdict (decode overlaps prep when the loader runs
#: under a prefetch iterator, so prep -- the span on the consuming
#: thread -- is the charged one; data_decode is reported alongside)
INPUT_PHASES = ('host_batch_prep',)


def input_bound_stats(steps, warmup=1):
    """The input-bound verdict of a training capture: per-rank p50 of
    the input-side phases (``host_batch_prep``) vs the device step
    (``jitted_step``), worst rank reported.  ``input_bound`` is True
    when input prep's p50 meets or exceeds the step's -- the loader,
    not the device, is pacing the run.  The first ``warmup``
    iterations are exempt per (phase, rank), mirroring the doctor's
    compile-step discipline.  ``None`` when the capture has no
    step-phase rows to judge."""
    per_rank = {}
    for row in steps:
        if int(row.get('iteration', 0)) < warmup:
            continue
        d = per_rank.setdefault(int(row.get('rank', 0)),
                                {'prep': [], 'step': [],
                                 'decode': []})
        prep = sum(row.get(p + '_ms', 0.0) for p in INPUT_PHASES)
        if prep > 0.0:
            d['prep'].append(prep)
        if 'jitted_step_ms' in row:
            d['step'].append(row['jitted_step_ms'])
        if 'data_decode_ms' in row:
            d['decode'].append(row['data_decode_ms'])
    worst = None
    for rank, d in sorted(per_rank.items()):
        if not d['prep'] or not d['step']:
            continue
        prep50 = _percentile(sorted(d['prep']), 0.50)
        step50 = _percentile(sorted(d['step']), 0.50)
        frac = prep50 / max(prep50 + step50, 1e-9)
        cand = {
            'rank': rank,
            'host_batch_prep_p50_ms': round(prep50, 3),
            'jitted_step_p50_ms': round(step50, 3),
            'data_decode_p50_ms': (
                round(_percentile(sorted(d['decode']), 0.50), 3)
                if d['decode'] else None),
            'input_fraction': round(frac, 4),
            'n_steps': len(d['step']),
            'input_bound': prep50 >= step50,
        }
        if worst is None or cand['input_fraction'] > \
                worst['input_fraction']:
            worst = cand
    return worst


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


def serve_summary(metrics):
    """The serving view of an aggregated metrics snapshot: request /
    batch / shed totals and the latency / queue-wait / pad-waste
    distributions the ``serve_*`` histograms carry (p50/p99 from the
    merged raw samples).  ``None`` when the snapshot records no
    serving activity -- the presence test the empty-capture checks
    consult."""
    if not metrics:
        return None
    serve = {k: v for k, v in metrics.items()
             if k.startswith('serve_')}
    if not serve:
        return None

    def summ(name):
        return (serve.get(name) or {}).get('summary') or {}

    def total(name):
        return (serve.get(name) or {}).get('value') or 0.0

    lat, wait, pad = (summ('serve_latency_seconds'),
                      summ('serve_queue_wait'),
                      summ('serve_pad_waste'))
    # shed forensics: the admission layers bump a per-reason counter
    # next to the aggregate, so an overload capture says WHY requests
    # were turned away (queue_full vs deadline vs shutdown) -- only
    # reasons that actually fired appear
    shed_reasons = {
        reason: total('serve_shed_%s_total' % reason)
        for reason in ('queue_full', 'deadline', 'shutdown')
        if ('serve_shed_%s_total' % reason) in serve}
    out = {
        'requests': total('serve_requests_total'),
        'batches': total('serve_batches_total'),
        'shed': total('serve_shed_total'),
        'shed_reasons': shed_reasons or None,
        'latency_ms': {
            'count': lat.get('count', 0),
            'p50': (lat.get('p50') or 0.0) * 1e3 if lat else None,
            'p99': (lat.get('p99') or 0.0) * 1e3 if lat else None,
        } if lat else None,
        'queue_wait_ms': {
            'p50': (wait.get('p50') or 0.0) * 1e3,
            'p99': (wait.get('p99') or 0.0) * 1e3,
        } if wait else None,
        'pad_waste_mean': pad.get('mean') if pad else None,
        'metrics': sorted(serve),
    }
    # the autoregressive-decode view (serving/generate.py): tokens
    # generated, TTFT and inter-token distributions, and tokens/s
    # derived from the decode-step histogram's own wall time (sum =
    # mean * count -- raw samples, never an averaged percentile)
    ttft = summ('serve_ttft_seconds')
    itl = summ('serve_intertoken_seconds')
    dstep = summ('serve_decode_seconds')
    tokens = total('serve_tokens_total')
    if tokens or ttft or itl:
        decode_wall = ((dstep.get('mean') or 0.0)
                       * dstep.get('count', 0)) if dstep else 0.0
        # the gauge is named per the scheduler's vocabulary (no
        # serve_ prefix), so read it off the full snapshot
        gauge = metrics.get('active_slots') or {}
        out['generate'] = {
            'tokens': tokens,
            'ttft_ms': {
                'count': ttft.get('count', 0),
                'p50': (ttft.get('p50') or 0.0) * 1e3,
                'p99': (ttft.get('p99') or 0.0) * 1e3,
            } if ttft else None,
            'intertoken_ms': {
                'count': itl.get('count', 0),
                'p50': (itl.get('p50') or 0.0) * 1e3,
                'p99': (itl.get('p99') or 0.0) * 1e3,
            } if itl else None,
            'decode_steps': dstep.get('count', 0) if dstep else 0,
            'tokens_per_s': (tokens / decode_wall
                             if tokens and decode_wall > 0 else None),
            'active_slots': gauge.get('value'),
        }
        # the speculative-decoding view: draft tokens submitted to
        # the target verify pass vs those whose target argmax agreed
        # -- the rate is the amortization lever (accepted tokens per
        # expensive target pass); ``None`` rate when the engine
        # proposed nothing (non-speculative captures omit the block)
        proposed = total('serve_draft_proposed_total')
        accepted = total('serve_draft_accepted_total')
        if 'serve_draft_proposed_total' in serve:
            out['generate']['speculative'] = {
                'draft_proposed': proposed,
                'draft_accepted': accepted,
                'accepted_draft_rate': (accepted / proposed
                                        if proposed else None),
            }
    return out


def render_request_text(trace):
    """One request's timeline, stage by stage (``telemetry report
    --request ID``)."""
    lines = ['request %s: e2e %s ms over %d stage(s), outcome %s'
             % (trace['request_id'],
                '-' if trace['e2e_ms'] is None else
                '%.3f' % trace['e2e_ms'],
                len(trace['stages']), trace['outcome'])]
    t_base = trace.get('t0')
    for s in trace['stages']:
        attrs = ', '.join(
            '%s=%s' % (k, v) for k, v in sorted(s.items())
            if k not in ('type', 'name', 'kind', 'request_id',
                         't0', 't1', 'rank'))
        lines.append(
            '  t+%9.3f ms  %-12s %9.3f ms%s'
            % ((s['t0'] - t_base) * 1e3, s['name'],
               (s['t1'] - s['t0']) * 1e3,
               ('  (%s)' % attrs) if attrs else ''))
    if trace.get('outcome_attrs'):
        lines.append('  outcome attrs: %s' % ', '.join(
            '%s=%s' % (k, v)
            for k, v in sorted(trace['outcome_attrs'].items())))
    return '\n'.join(lines)


def build_report(outdir):
    """The merged session report: timeline summary, per-step phase
    table, overlap statistics, aggregated metrics, chaos events."""
    metas, spans, events, bad = load_rank_logs(outdir)
    rank_metrics = load_rank_metrics(outdir)
    spans.sort(key=lambda s: s.get('t0', 0.0))
    events.sort(key=lambda e: e.get('t', 0.0))
    by_kind = {}
    for s in spans:
        k = by_kind.setdefault(s.get('kind', '?'),
                               {'spans': 0, 'total_s': 0.0})
        k['spans'] += 1
        k['total_s'] += max(s['t1'] - s['t0'], 0.0)
    steps = step_table(spans)
    step_ms = sorted((s['t1'] - s['t0']) * 1e3 for s in spans
                     if s.get('name') == 'jitted_step')
    chaos_events = [e for e in events if e.get('kind') == 'chaos']
    report = {
        'outdir': outdir,
        'ranks': sorted({m.get('rank', 0) for m in metas}
                        | {s.get('rank', 0) for s in spans}),
        'n_spans': len(spans),
        'n_events': len(events),
        'n_unparseable_lines': bad,
        'kinds': {k: {'spans': v['spans'],
                      'total_ms': round(v['total_s'] * 1e3, 3)}
                  for k, v in sorted(by_kind.items())},
        'steps': steps,
        'step_time_ms': ({} if not step_ms else {
            'count': len(step_ms),
            'p50': round(_percentile(step_ms, 0.50), 3),
            'p99': round(_percentile(step_ms, 0.99), 3),
            'mean': round(sum(step_ms) / len(step_ms), 3)}),
        'overlap': overlap_stats(spans),
        'chaos_events': [
            {'t': e['t'], 'rank': e.get('rank', 0),
             'name': e.get('name')} for e in chaos_events],
        'metrics': aggregate_metrics(rank_metrics),
    }
    report['serve'] = serve_summary(report['metrics'])
    report['requests'] = request_summary(spans + events)
    report['pipeline'] = pipeline_summary(events)
    report['input_bound'] = input_bound_stats(steps)
    return report


# ---------------------------------------------------------------------
# rendering + export

def render_text(report, max_steps=24):
    lines = ['telemetry session: %s' % report['outdir'],
             'ranks: %s   spans: %d   events: %d'
             % (report['ranks'], report['n_spans'],
                report['n_events'])]
    for kind, agg in report['kinds'].items():
        lines.append('  %-18s %6d spans  %10.3f ms total'
                     % (kind, agg['spans'], agg['total_ms']))
    if report['steps']:
        lines.append('step timeline (first %d of %d rows):'
                     % (min(max_steps, len(report['steps'])),
                        len(report['steps'])))
        hdr = ('  %6s %4s' % ('iter', 'rank')
               + ''.join(' %16s' % p for p in STEP_PHASES))
        lines.append(hdr)
        for row in report['steps'][:max_steps]:
            cells = ''.join(
                ' %13.3f ms' % row[p + '_ms']
                if p + '_ms' in row else ' %16s' % '-'
                for p in STEP_PHASES)
            lines.append('  %6d %4d%s' % (row['iteration'],
                                          row['rank'], cells))
    st = report.get('step_time_ms') or {}
    if st:
        lines.append('jitted step: %d samples, p50 %.3f ms, '
                     'p99 %.3f ms' % (st['count'], st['p50'],
                                      st['p99']))
    ib = report.get('input_bound')
    if ib is not None:
        if ib['input_bound']:
            lines.append(
                'INPUT-BOUND: rank %d host_batch_prep p50 %.3f ms >= '
                'jitted_step p50 %.3f ms (%.0f%% of the step) -- the '
                'input pipeline, not the device, paces this run; '
                'scale decode workers/prefetch '
                '(docs/data_pipeline.md)'
                % (ib['rank'], ib['host_batch_prep_p50_ms'],
                   ib['jitted_step_p50_ms'],
                   ib['input_fraction'] * 100))
        else:
            lines.append(
                'input: host_batch_prep p50 %.3f ms vs jitted_step '
                'p50 %.3f ms (rank %d, %.0f%% of the step) -- not '
                'input-bound'
                % (ib['host_batch_prep_p50_ms'],
                   ib['jitted_step_p50_ms'], ib['rank'],
                   ib['input_fraction'] * 100))
    ov = report['overlap']
    if ov['overlap_fraction'] is None:
        lines.append('overlap: no collective spans in capture')
    else:
        lines.append(
            'overlap fraction: %.3f  (collective %.3f ms total, '
            '%.3f ms exposed, %.3f ms hidden behind compute)'
            % (ov['overlap_fraction'], ov['total_collective_s'] * 1e3,
               ov['exposed_collective_s'] * 1e3,
               ov['hidden_collective_s'] * 1e3))
        for key, agg in sorted((ov.get('per_axis') or {}).items()):
            frac = agg.get('overlap_fraction')
            lines.append(
                '  axis %-12s %4d spans  %10.3f ms total  '
                '%10.3f ms exposed  overlap %s'
                % (key, agg['spans'],
                   agg['total_collective_s'] * 1e3,
                   agg['exposed_collective_s'] * 1e3,
                   '-' if frac is None else '%.3f' % frac))
    for row in report.get('pipeline') or ():
        # the pipe-axis row of the per-axis story: the schedule's
        # collectives live inside the jit (trace marks, not spans),
        # so its cost is the static bubble, reported per stage
        lines.append(
            'pipeline [%s] %d stage(s) x %d micro-batch(es) over '
            "axis '%s': bubble fraction %.3f per stage "
            '(%s ticks/step; shrink it with more micro-batches)'
            % (row['schedule'], row['n_stages'], row['n_micro'],
               row['axis'], row['bubble_fraction'],
               row.get('total_ticks')))
    serve = report.get('serve')
    if serve:
        lat = serve.get('latency_ms') or {}
        lines.append(
            'serving: %.0f requests in %.0f batches, %.0f shed'
            % (serve['requests'], serve['batches'], serve['shed'])
            + ('; latency p50 %.3f ms p99 %.3f ms'
               % (lat['p50'], lat['p99'])
               if lat.get('p50') is not None else '')
            + ('; pad waste %.1f%%' % (serve['pad_waste_mean'] * 100)
               if serve.get('pad_waste_mean') is not None else ''))
        if serve.get('shed_reasons'):
            lines.append('  shed reasons: ' + ', '.join(
                '%s=%.0f' % (k, v) for k, v
                in sorted(serve['shed_reasons'].items())))
        gen = serve.get('generate')
        if gen:
            ttft = gen.get('ttft_ms') or {}
            itl = gen.get('intertoken_ms') or {}
            lines.append(
                'generation: %.0f tokens / %.0f decode steps'
                % (gen['tokens'], gen['decode_steps'])
                + ('  %.0f tok/s' % gen['tokens_per_s']
                   if gen.get('tokens_per_s') else '')
                + ('; TTFT p50 %.3f ms p99 %.3f ms'
                   % (ttft['p50'], ttft['p99'])
                   if ttft.get('p50') is not None else '')
                + ('; inter-token p50 %.3f ms p99 %.3f ms'
                   % (itl['p50'], itl['p99'])
                   if itl.get('p50') is not None else ''))
    reqs = report.get('requests')
    if reqs:
        e2e = reqs.get('e2e_ms') or {}
        lines.append(
            'request traces: %d (%d completed, %d shed, %d in flight)'
            % (reqs['count'], reqs['completed'], reqs['shed'],
               reqs['in_flight'])
            + ('; e2e p50 %.3f ms p99 %.3f ms'
               % (e2e['p50'], e2e['p99'])
               if e2e.get('p50') is not None else ''))
        worst = reqs.get('worst')
        if worst:
            lines.append(
                '  worst request %s: e2e %.3f ms = %s  '
                '(%d decode ticks; stage sum %.3f ms)'
                % (worst['request_id'], worst['e2e_ms'],
                   ' + '.join(
                       '%s %.3f' % (k, worst['stage_ms'][k])
                       for k in (tuple(REQUEST_STAGES)
                                 + tuple(sorted(
                                     set(worst['stage_ms'])
                                     - set(REQUEST_STAGES))))
                       if k in worst['stage_ms']),
                   worst['n_decode'], worst['stage_sum_ms']))
    if report['chaos_events']:
        lines.append('chaos events in timeline: %d (%s)'
                     % (len(report['chaos_events']),
                        ', '.join(sorted({e['name'] for e in
                                          report['chaos_events']}))))
    for name, snap in report['metrics'].items():
        if snap.get('type') == 'histogram':
            summ = snap.get('summary') or {}
            if summ:
                lines.append(
                    '  metric %-28s n=%-6d p50=%.6g p99=%.6g'
                    % (name, summ['count'], summ['p50'], summ['p99']))
        else:
            lines.append('  metric %-28s %s=%s'
                         % (name, snap.get('type'), snap.get('value')))
    return '\n'.join(lines)


#: one label pair: a value may hold only the escaped sequences
#: ``\\``, ``\"`` and ``\n``
_PROM_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:\\[\\"n]|[^"\\])*"'
_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*'
    r'(\{(?:%(l)s)(?:,(?:%(l)s))*,?\})? '
    r'[-+]?([0-9]*\.?[0-9]+([eE][-+]?[0-9]+)?|[Nn]a[Nn]|[Ii]nf)$'
    % {'l': _PROM_LABEL})
_PROM_COMMENT = re.compile(
    r'^# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]*( .*)?$')


def validate_prometheus(text):
    """Offending lines of a Prometheus text exposition (empty list:
    valid).  Strict: a label value with an unescaped quote or backslash
    is malformed."""
    bad = []
    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith('#'):
            if (line.startswith(('# HELP', '# TYPE'))
                    and not _PROM_COMMENT.match(line)):
                bad.append(line)
            continue
        if not _PROM_LINE.match(line):
            bad.append(line)
    return bad


def export(outdir, report=None):
    """Write the merged artifacts next to the per-rank logs:
    ``merged_report.json``, ``metrics.json`` (aggregated) and
    ``metrics.prom`` (Prometheus text).  Returns the report."""
    report = report or build_report(outdir)
    with open(os.path.join(outdir, 'merged_report.json'), 'w') as f:
        json.dump(report, f, indent=1)
    with open(os.path.join(outdir, 'metrics.json'), 'w') as f:
        json.dump(report['metrics'], f, indent=1)
    prom = snapshot_to_prometheus(report['metrics'])
    with open(os.path.join(outdir, 'metrics.prom'), 'w') as f:
        f.write(prom)
    return report
