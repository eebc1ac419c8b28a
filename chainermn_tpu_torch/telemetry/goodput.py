"""Goodput: one number for "how much of the wall clock trained".

Counterpart of ``chainermn_tpu/telemetry/goodput.py``, over the same
ledger and capture formats.

A fault-tolerant run's headline is not its step time -- it is the
fraction of elapsed wall clock that produced useful training steps
after everything the robustness machinery COSTS (checkpoint stalls,
exposed communication, input stalls, restart downtime) is charged
against it.  This module joins the supervisor ledger
(``supervisor_ledger.jsonl``) with the merged step timeline of every
attempt's telemetry capture and decomposes the run's wall clock into
disjoint buckets::

    wall = useful_step + bubble + exposed_collective + checkpoint
         + input_bound + restart_downtime + other

- **useful_step**: wall time covered by at least one rank's
  ``jitted_step`` span (union across ranks and attempts), minus the
  pipeline bubble;
- **bubble**: the static pipe-idle share of that step time, from the
  ``pipeline:schedule`` trace events (0 when the run has no pipeline
  axis);
- **exposed_collective**: eager-collective span time no step span
  overlaps -- communication the device visibly waited on;
- **checkpoint**: checkpoint span time on the critical path: snapshot
  + synchronous writes + resume restores, NOT overlapped by a step.
  Spans stamped ``background=True`` (the async writer's thread) are
  excluded -- hidden checkpoint I/O is the point of async
  checkpointing and is not charged;
- **input_bound**: input-side span time (``host_batch_prep``,
  ``data_decode``) not hidden behind a step;
- **restart_downtime**: the ledger's failure -> first-progress
  windows (one per ``recovered`` event);
- **other**: the exact remainder (launch/compile/teardown, backoff
  sleep beyond measured downtime).  Buckets are computed by interval
  subtraction against a running covered-union, so they are disjoint
  by construction and sum to the wall clock exactly.

``goodput_fraction = useful_step / wall``.  :func:`render_text`
renders the decomposition and :func:`export` writes
``goodput_report.json`` next to the ledger; ``python -m
chainermn_tpu_torch.telemetry goodput OUT`` runs both.

Accepts either a supervisor out dir (ledger + ``telemetry/a*``
attempt captures) or a single plain telemetry session directory
(no ledger: the wall window is the span extent and
``restart_downtime`` is 0).
"""

import glob
import json
import os

from chainermn_tpu_torch.telemetry import report as report_mod

#: decomposition vocabulary, charge order (earlier buckets win ties)
BUCKETS = ('useful_step', 'bubble', 'exposed_collective',
           'checkpoint', 'input_bound', 'restart_downtime', 'other')

#: span names charged to the input_bound bucket when exposed
INPUT_SPAN_NAMES = ('host_batch_prep', 'data_decode')


# ---------------------------------------------------------------------
# interval arithmetic on top of report.merge_intervals

def subtract_intervals(intervals, covered):
    """The parts of ``intervals`` (merged, disjoint) not covered by
    ``covered`` (merged, disjoint)."""
    out = []
    for t0, t1 in intervals:
        cur = t0
        for c0, c1 in covered:
            if c1 <= cur:
                continue
            if c0 >= t1:
                break
            if c0 > cur:
                out.append((cur, c0))
            cur = max(cur, c1)
            if cur >= t1:
                break
        if cur < t1:
            out.append((cur, t1))
    return out


def clip_intervals(intervals, lo, hi):
    """Intervals intersected with the ``[lo, hi]`` window."""
    return [(max(t0, lo), min(t1, hi)) for t0, t1 in intervals
            if min(t1, hi) > max(t0, lo)]


def _total(intervals):
    return sum(t1 - t0 for t0, t1 in intervals)


# ---------------------------------------------------------------------
# loading

def load_ledger(path):
    """Ledger events (list of dicts) from a supervisor ledger jsonl;
    unparseable lines skipped (a torn tail must not hide the run)."""
    events = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    events.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        pass
    return events


def find_captures(out):
    """The telemetry capture directories of a run: the supervisor's
    per-attempt ``telemetry/a*`` subdirs, or ``out`` itself when it
    holds per-rank event logs directly (attempt order preserved)."""
    adirs = sorted(
        glob.glob(os.path.join(out, 'telemetry', 'a*')),
        key=lambda p: (len(os.path.basename(p)), p))
    caps = [d for d in adirs
            if glob.glob(os.path.join(d, 'events-rank*.jsonl'))]
    if caps:
        return caps
    if glob.glob(os.path.join(out, 'events-rank*.jsonl')):
        return [out]
    return []


def downtime_intervals(ledger, first_progress=None):
    """``(intervals, total_s)`` -- one downtime window per
    ``recovered`` ledger event.  ``downtime_s`` is measured by the
    supervisor from the moment progress STOPPED (the victim's last
    heartbeat advance -- before detection, which lags by the stall/
    drain grace) to the first iteration advance of the recovered
    attempt; the window is therefore anchored at its END: the
    recovered attempt's first completed step (``first_progress``
    maps attempt index -> that wall time; the event's own stamp --
    attempt teardown -- is the fallback).  ``total_s`` is the
    ledger's own sum (the MTTR numerator), independent of the
    interval accounting."""
    first_progress = first_progress or {}
    intervals, total = [], 0.0
    for ev in ledger:
        if ev.get('event') != 'recovered':
            continue
        d = ev.get('downtime_s')
        if d is None:
            continue
        total += d
        end = first_progress.get(ev.get('attempt'), ev.get('t', 0.0))
        intervals.append((end - d, end))
    return report_mod.merge_intervals(intervals), total


# ---------------------------------------------------------------------
# the decomposition

def build_goodput(out):
    """The goodput report for a run directory (see module
    docstring).  Returns a dict; ``wall_s`` is None when neither a
    ledger window nor any spans exist (an empty capture)."""
    out = os.path.normpath(out)
    ledger = load_ledger(os.path.join(out, 'supervisor_ledger.jsonl'))
    caps = find_captures(out)

    spans, events = [], []
    attempts = []
    first_progress = {}
    for cap in caps:
        _metas, s, e, _bad = report_mod.load_rank_logs(cap)
        spans.extend(s)
        events.extend(e)
        steps_t1 = [rec['t1'] for rec in s
                    if rec.get('name') == 'jitted_step']
        base = os.path.basename(cap)
        if base.startswith('a') and base[1:].isdigit() and steps_t1:
            first_progress[int(base[1:])] = min(steps_t1)
        attempts.append({
            'capture': cap,
            'n_spans': len(s),
            'ranks': sorted({rec.get('rank', 0) for rec in s}),
        })

    # wall window: ledger start -> terminal event when supervised,
    # else the span extent of a bare capture
    t_lo = t_hi = None
    terminal = None
    for ev in ledger:
        if ev.get('event') == 'start':
            t_lo = ev.get('t')
        elif ev.get('event') in ('complete', 'abort', 'timeout'):
            t_hi = ev.get('t')
            terminal = ev.get('event')
    if spans:
        s_lo = min(s['t0'] for s in spans)
        s_hi = max(s['t1'] for s in spans)
        if t_lo is None:
            t_lo, t_hi = s_lo, s_hi
        elif t_hi is None:
            t_hi = s_hi  # supervisor killed mid-run: best evidence
    if t_lo is None or t_hi is None or t_hi <= t_lo:
        return {'out': out, 'wall_s': None, 'attempts': attempts,
                'ledger_events': len(ledger)}
    wall = t_hi - t_lo

    def union(pred):
        return clip_intervals(report_mod.merge_intervals(
            [(s['t0'], s['t1']) for s in spans if pred(s)]),
            t_lo, t_hi)

    step_u = union(lambda s: s.get('name') == 'jitted_step')
    step_s = _total(step_u)

    # pipeline bubble: the static pipe-idle share of the step time
    pipe = report_mod.pipeline_summary(events)
    bubble_frac = max((row['bubble_fraction'] for row in pipe),
                      default=0.0) if pipe else 0.0
    bubble_s = step_s * bubble_frac
    useful_s = step_s - bubble_s

    covered = list(step_u)

    def charge(intervals):
        exposed = subtract_intervals(intervals, covered)
        covered[:] = report_mod.merge_intervals(covered + exposed)
        return _total(exposed)

    coll_s = charge(union(
        lambda s: s.get('kind') in report_mod.COLLECTIVE_KINDS))
    ckpt_s = charge(union(
        lambda s: s.get('kind') == 'checkpoint'
        and not s.get('background')))
    input_s = charge(union(
        lambda s: s.get('name') in INPUT_SPAN_NAMES))
    down_iv, ledger_down_s = downtime_intervals(ledger,
                                                first_progress)
    down_s = charge(clip_intervals(down_iv, t_lo, t_hi))
    other_s = wall - (step_s + coll_s + ckpt_s + input_s + down_s)

    # async checkpointing's receipt: background-writer span time that
    # was NOT charged (reported for the story, not in the sum)
    hidden_ckpt = _total(union(
        lambda s: s.get('kind') == 'checkpoint'
        and s.get('background')))

    restarts = sum(1 for ev in ledger
                   if ev.get('event') == 'failure')
    shrinks = [ev for ev in ledger
               if ev.get('event') == 'decision'
               and ev.get('action') == 'shrink']
    mttr = None
    for ev in ledger:
        if ev.get('event') == 'complete' \
                and ev.get('mttr_s') is not None:
            mttr = ev['mttr_s']

    def r(x):
        return round(x, 6)

    buckets = {
        'useful_step': r(useful_s),
        'bubble': r(bubble_s),
        'exposed_collective': r(coll_s),
        'checkpoint': r(ckpt_s),
        'input_bound': r(input_s),
        'restart_downtime': r(down_s),
        'other': r(other_s),
    }
    return {
        'out': out,
        'wall_s': r(wall),
        'window': {'t0': t_lo, 't1': t_hi,
                   'terminal': terminal or 'capture'},
        'goodput_fraction': r(useful_s / wall),
        'buckets_s': buckets,
        'buckets_fraction': {k: r(v / wall)
                             for k, v in buckets.items()},
        'hidden_checkpoint_s': r(hidden_ckpt),
        'ledger': {
            'events': len(ledger),
            'failures': restarts,
            'shrinks': len(shrinks),
            'slice_shrinks': sum(
                1 for ev in shrinks
                if ev.get('granularity') == 'slice'),
            'restart_downtime_s': r(ledger_down_s),
            'mttr_s': mttr,
        } if ledger else None,
        'attempts': attempts,
        'n_steps': sum(1 for s in spans
                       if s.get('name') == 'jitted_step'),
    }


# ---------------------------------------------------------------------
# rendering + export + floor

def render_text(gp):
    if gp.get('wall_s') is None:
        return ('goodput: EMPTY capture under %s (no ledger window '
                'and no spans)' % gp['out'])
    lines = ['goodput: %s' % gp['out'],
             'wall clock %.3f s (%s), %d step spans over %d '
             'attempt(s)'
             % (gp['wall_s'], gp['window']['terminal'],
                gp['n_steps'], len(gp['attempts']))]
    for name in BUCKETS:
        lines.append('  %-20s %10.3f s  %6.2f%%'
                     % (name, gp['buckets_s'][name],
                        gp['buckets_fraction'][name] * 100.0))
    check = sum(gp['buckets_s'].values())
    lines.append('  %-20s %10.3f s  (decomposition check: '
                 'buckets sum to wall)' % ('sum', check))
    if gp.get('hidden_checkpoint_s'):
        lines.append(
            'async checkpointing hid %.3f s of checkpoint I/O '
            'behind the step (not charged)'
            % gp['hidden_checkpoint_s'])
    led = gp.get('ledger')
    if led:
        lines.append(
            'supervisor: %d failure(s), %d shrink(s) (%d by slice), '
            'ledger downtime %.3f s%s'
            % (led['failures'], led['shrinks'],
               led['slice_shrinks'], led['restart_downtime_s'],
               (', MTTR %.3f s' % led['mttr_s'])
               if led.get('mttr_s') is not None else ''))
    lines.append('GOODPUT FRACTION: %.4f'
                 % gp['goodput_fraction'])
    return '\n'.join(lines)


def export(out, gp=None):
    """Write ``goodput_report.json`` into the run directory."""
    gp = gp or build_goodput(out)
    with open(os.path.join(out, 'goodput_report.json'), 'w') as f:
        json.dump(gp, f, indent=1)
    return gp
