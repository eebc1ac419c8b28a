"""Request-centric views of a telemetry capture.

Counterpart of ``request_traces`` / ``request_summary`` of
``chainermn_tpu/telemetry/report.py``: per-request span trees rebuilt
from the ``kind='request'`` records, and the summary that names the
worst request's stages.  The rest of the JAX package's report (the
merged step timeline, overlap, the doctor, the Prometheus export of a
capture directory) is ROADMAP.md A9.
"""

from chainermn_tpu_torch.telemetry.recorder import _percentile

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
