"""Cross-rank diagnosis (the doctor): collective skew attribution,
straggler detection, and the crash post-mortem from flight records.

Counterpart of ``chainermn_tpu/telemetry/diagnosis.py``; it reads the
recorder's per-rank JSONL and flight records, whose schema both packages
share, so either package's doctor reads either package's capture.  The
stack's collectives are synchronous: one chronically late rank stalls
the whole job, so the question is *which rank, which phase*.

- **Collective skew attribution** (:func:`collective_skew`).  Eager
  collective spans carry a per-stream ``seq``
  (``communicators/base.py``), so the same rendezvous pairs across ranks
  by ``(name, tag, seq)``.  A rendezvous exits on every rank at nearly
  the same instant, so each rank's clock offset is the median deviation
  of its exit times from the group mean
  (:func:`estimate_clock_offsets`); after that correction the spread of
  the arrivals (``t0``) is real waiting.  Each collective gets its skew
  and latest rank, each rank a chronic-lateness score, and the lagging
  phase is the span name whose median grew on the late rank
  (:func:`attribute_phase`).
- **Stragglers and anomalies** (:func:`find_stragglers`,
  :func:`step_anomalies`): median excess over the peers' median across
  ranks; MAD-based modified z-scores (:func:`robust_outliers`) over the
  per-step samples within a run.
- **Crash analysis** (:func:`crash_analysis`): the flight records
  (``flight-rank*.json``, written by chaos kill sites before
  ``os._exit``, by the typed-failure constructors and by the preemption
  handler's SIGTERM hook) merged with the heartbeat files
  (``heartbeat-*.json``) name the dead or stalled rank, its last
  completed collective, and the open span each survivor was blocked in.

:func:`diagnose` runs all three under one ``verdict``;
:func:`quick_verdict` is the supervisor's never-raising form.  The
protocol replay (:func:`protocol_divergence`) compares the ranks'
collective streams with ``analysis.commcheck.verify_streams``, the core
shardlint's SL013 runs too, imported when the replay runs (the doctor
loads no model).  ``python -m chainermn_tpu_torch.telemetry doctor
DIR`` runs :func:`diagnose` and writes ``doctor_report.json``.
"""

import glob
import json
import os

from chainermn_tpu_torch.telemetry.report import (
    SERVE_PHASES, STEP_PHASES, exposed_time, input_bound_stats,
    load_rank_logs, load_rank_metrics, aggregate_metrics,
    merge_intervals, request_summary, serve_summary, step_table,
    _percentile)

#: phases the within-run anomaly scan pools samples for: the training
#: step phases plus the serve-batch phases (``serve_execute`` spans
#: carry ``iteration`` = batch index, so a latency-cliff batch is
#: attributable exactly like a slow training step)
ANOMALY_PHASES = STEP_PHASES + SERVE_PHASES

#: eager collectives whose EXIT is a rendezvous (every rank leaves
#: when the last arrives) -- the clock-offset anchors.  The eager
#: ``broadcast_data`` span is a local replicate, not a rendezvous, so
#: it contributes to skew pairing only, never to offset estimation.
RENDEZVOUS_COLLECTIVES = ('barrier', 'allreduce_obj')

#: a rank is chronically late when it is the latest arrival in at
#: least this fraction of paired collectives ...
CHRONIC_LATE_FRACTION = 0.5
#: ... by at least this much on average (ms) -- below it, "latest" is
#: scheduler noise, not a straggler
MIN_LATE_MS = 2.0

#: cross-rank straggler flag: median step/phase time exceeding the
#: peer median by this fraction AND by MIN_EXCESS_MS
STRAGGLER_EXCESS_FRAC = 0.2
STRAGGLER_MIN_EXCESS_MS = 2.0

#: modified z-score cutoff for MAD-based within-run outliers (the
#: conventional 3.5 of Iglewicz & Hoaglin)
MAD_Z = 3.5


def _median(vals):
    s = sorted(vals)
    n = len(s)
    if not n:
        return None
    return (s[n // 2] if n % 2 else (s[n // 2 - 1] + s[n // 2]) / 2.0)


def mad(samples):
    """``(median, median-absolute-deviation)`` of a sample list."""
    med = _median(samples)
    if med is None:
        return None, None
    return med, _median([abs(v - med) for v in samples])


def effective_mad(samples):
    """``(median, effective deviation)``: the MAD, or the mean
    absolute deviation when the MAD collapses (over half the samples
    identical -- a lone spike in an otherwise flat series zeroes the
    MAD but cannot zero the mean absolute deviation).  ``(median,
    None)`` when no usable deviation exists (constant or empty data);
    every z-score computed against :func:`robust_outliers`' flags
    MUST use this deviation, not the raw MAD."""
    med, m = mad(samples)
    if med is None:
        return None, None
    if not m or m < 1e-9 * max(abs(med), 1.0):
        m = sum(abs(v - med) for v in samples) / len(samples)
        if not m or m < 1e-9 * max(abs(med), 1.0):
            return med, None
    return med, m


def robust_outliers(samples, z=MAD_Z, min_dev=0.0):
    """Indices of MAD-based outliers (modified z-score > ``z``,
    slow side only -- a suspiciously FAST step is not a straggler
    signal).  Degenerate inputs flag nothing (absence of evidence,
    not fabricated flags): < 4 samples, MAD 0 on constant data, or a
    MAD that is pure floating-point noise relative to the median (the
    classic near-constant-series pitfall where nanoscale jitter earns
    astronomical z-scores); near-constant-with-a-spike series fall
    back to the mean absolute deviation (:func:`effective_mad`).
    ``min_dev`` additionally requires the deviation itself to be
    material in the samples' own unit."""
    if len(samples) < 4:
        return []
    med, m = effective_mad(samples)
    if med is None or m is None:
        return []
    return [i for i, v in enumerate(samples)
            if 0.6745 * (v - med) / m > z and (v - med) > min_dev]


# ---------------------------------------------------------------------
# collective pairing + clock offsets + skew

def pair_collectives(spans):
    """Group ``kind='collective'`` spans carrying a ``seq`` by
    ``(name, tag, seq)`` into ``{key: {rank: span}}`` -- the same
    rendezvous seen from every rank.  Spans without a seq are
    unpairable and skipped."""
    groups = {}
    for s in spans:
        if s.get('kind') != 'collective' or 'seq' not in s:
            continue
        key = (s.get('name'), s.get('tag'), int(s['seq']))
        groups.setdefault(key, {})[int(s.get('rank', 0))] = s
    return groups


def protocol_divergence(spans, exclude_ranks=()):
    """Replay per-rank eager collective ``seq`` streams from a
    capture through ``analysis.commcheck.verify_streams``.

    Streams are each rank's ``kind='collective'`` spans carrying a
    ``seq``, in ``t0`` order.
    ``exclude_ranks`` removes ranks already explained by crash
    analysis: a dead rank's stream ends early by DEATH, which is the
    crash verdict's finding, not a protocol divergence.  Returns
    ``None`` when the surviving streams agree (or fewer than two
    ranks recorded collectives), else the checker's divergence dict
    (first divergent position, each rank's op and surrounding ops).
    """
    excl = {int(r) for r in exclude_ranks}
    by_rank = {}
    for s in spans:
        if s.get('kind') != 'collective' or 'seq' not in s:
            continue
        r = int(s.get('rank', 0))
        if r in excl:
            continue
        by_rank.setdefault(r, []).append(s)
    if len(by_rank) < 2:
        return None
    streams = {}
    for r, recs in by_rank.items():
        recs.sort(key=lambda s: float(s.get('t0', 0.0)))
        streams[r] = [{'op': s.get('name'), 'kind': 'collective',
                       'tag': s.get('tag'), 'seq': int(s['seq'])}
                      for s in recs]
    from chainermn_tpu_torch.analysis import commcheck
    return commcheck.verify_streams(streams)


def estimate_clock_offsets(groups, ranks=None):
    """Per-rank wall-clock offset (seconds; subtract from a rank's
    timestamps to land on the common clock), estimated from paired
    RENDEZVOUS exits: within one group every rank's ``t1`` is the
    same true instant, so a rank's deviation from the group mean is
    its offset plus noise; the median over groups is robust to the
    odd late release.  Ranks without paired exits get 0.0."""
    devs = {}
    for (name, _tag, _seq), by_rank in groups.items():
        if name not in RENDEZVOUS_COLLECTIVES or len(by_rank) < 2:
            continue
        t1s = {r: s['t1'] for r, s in by_rank.items()}
        center = sum(t1s.values()) / len(t1s)
        for r, t in t1s.items():
            devs.setdefault(r, []).append(t - center)
    offsets = {r: _median(ds) for r, ds in devs.items()}
    for r in (ranks or ()):
        offsets.setdefault(r, 0.0)
    return offsets


def collective_skew(spans, offsets=None, max_worst=8):
    """Arrival-skew attribution over paired collective spans.

    Returns ``None`` when no collective pairs exist (single-rank
    capture, or spans predating seq tagging); else a dict with

    - ``paired``: number of cross-rank-paired collectives,
    - ``clock_offsets_ms``: the per-rank offsets used,
    - ``skew_ms``: p50/p99/max of per-collective arrival spread
      (first arrival to last, offset-corrected),
    - ``worst``: the ``max_worst`` widest collectives
      (name/tag/seq/skew_ms/late_rank),
    - ``per_rank``: chronic-lateness score per rank --
      ``late_fraction`` (how often this rank arrived last, among
      collectives with real spread), ``mean_late_ms`` /
      ``p99_late_ms`` (its arrival lag behind the first rank),
      ``chronic`` (both thresholds crossed).
    """
    groups = pair_collectives(spans)
    ranks = sorted({r for g in groups.values() for r in g})
    if offsets is None:
        offsets = estimate_clock_offsets(groups, ranks)
    rows = []
    lateness = {r: [] for r in ranks}
    late_counts = {r: 0 for r in ranks}
    judged = 0
    for (name, tag, seq), by_rank in sorted(groups.items(),
                                            key=lambda kv: str(kv[0])):
        if len(by_rank) < 2:
            continue
        arrivals = {r: s['t0'] - (offsets.get(r) or 0.0)
                    for r, s in by_rank.items()}
        first = min(arrivals.values())
        late_rank = max(arrivals, key=lambda r: arrivals[r])
        skew_ms = (arrivals[late_rank] - first) * 1e3
        for r, a in arrivals.items():
            lateness[r].append((a - first) * 1e3)
        judged += 1
        if skew_ms > MIN_LATE_MS:
            late_counts[late_rank] += 1
        rows.append({'name': name, 'tag': tag, 'seq': seq,
                     'skew_ms': round(skew_ms, 3),
                     'late_rank': late_rank})
    if not judged:
        return None
    skews = sorted(r['skew_ms'] for r in rows)
    meaningful = sum(1 for r in rows if r['skew_ms'] > MIN_LATE_MS)
    per_rank = {}
    for r in ranks:
        lats = lateness[r]
        frac = (late_counts[r] / meaningful) if meaningful else 0.0
        mean_late = (sum(lats) / len(lats)) if lats else 0.0
        per_rank[r] = {
            'late_fraction': round(frac, 4),
            'mean_late_ms': round(mean_late, 3),
            'p99_late_ms': round(_percentile(sorted(lats), 0.99), 3)
            if lats else None,
            'chronic': (frac >= CHRONIC_LATE_FRACTION
                        and mean_late >= MIN_LATE_MS),
        }
    return {
        'paired': judged,
        'clock_offsets_ms': {r: round((offsets.get(r) or 0.0) * 1e3, 3)
                             for r in ranks},
        'skew_ms': {
            'p50': round(_percentile(skews, 0.50), 3),
            'p99': round(_percentile(skews, 0.99), 3),
            'max': round(skews[-1], 3),
        },
        'worst': sorted(rows, key=lambda r: -r['skew_ms'])[:max_worst],
        'per_rank': per_rank,
    }


# ---------------------------------------------------------------------
# phase attribution + stragglers

def _durations_by_name(spans, rank):
    out = {}
    for s in spans:
        if int(s.get('rank', 0)) != rank:
            continue
        out.setdefault(s.get('name'), []).append(
            (s['t1'] - s['t0']) * 1e3)
    return out


def attribute_phase(spans, rank):
    """``(phase, delta_ms)``: the span name whose median duration on
    ``rank`` most exceeds the median of its peers' medians -- the
    phase that GREW on the suspect rank.  A late rank's own
    collective spans SHRINK (it waits least), so they lose this argmax
    by construction; the winner is the causal phase (host_batch_prep,
    send_obj, ...).  ``(None, 0.0)`` when nothing grew."""
    ranks = sorted({int(s.get('rank', 0)) for s in spans})
    mine = _durations_by_name(spans, rank)
    others = {r: _durations_by_name(spans, r)
              for r in ranks if r != rank}
    best, best_delta = None, 0.0
    for name, durs in mine.items():
        peer_meds = [
            _median(o[name]) for o in others.values() if o.get(name)]
        if not peer_meds:
            continue
        delta = _median(durs) - _median(peer_meds)
        if delta > best_delta:
            best, best_delta = name, delta
    return best, round(best_delta, 3)


def exposed_by_rank(spans):
    """Per-rank exposed-collective time (ms): collective span time
    with no same-rank compute span running -- the straggler-visible
    half of the overlap accounting in ``report.overlap_stats``."""
    ranks = sorted({int(s.get('rank', 0)) for s in spans})
    out = {}
    for rank in ranks:
        comp = merge_intervals(
            [(s['t0'], s['t1']) for s in spans
             if int(s.get('rank', 0)) == rank
             and s.get('kind') == 'compute'])
        coll = [(s['t0'], s['t1']) for s in spans
                if int(s.get('rank', 0)) == rank
                and s.get('kind') == 'collective']
        out[rank] = round(sum(exposed_time(c, comp) for c in
                              merge_intervals(coll)) * 1e3, 3)
    return out


def _excess_vs_peers(per_rank_values):
    """``{rank: (excess_ms, excess_frac)}`` of each rank's value over
    the median of its peers' values (cross-rank comparison that stays
    meaningful at 2-3 ranks, where cross-rank MAD degenerates)."""
    out = {}
    for rank, v in per_rank_values.items():
        peers = [w for r, w in per_rank_values.items() if r != rank]
        base = _median(peers)
        if base is None or v is None:
            continue
        excess = v - base
        out[rank] = (excess, excess / base if base > 0 else float('inf')
                     if excess > 0 else 0.0)
    return out


def find_stragglers(spans, skew=None):
    """Straggler candidates, most damning evidence first.

    Evidence tiers, each consulted only when the stronger one is
    silent: (1) chronic lateness to paired collectives -- the direct
    synchronous-stall signal; when it names ranks, the weaker tiers
    are SKIPPED, because the victims of a chronic straggler show
    inflated collective waits that would read as false positives;
    (2) step-time median excess over peers; (3) exposed-collective
    DEFICIT -- in a synchronous pod everyone waits for the straggler,
    so the rank whose exposed-collective time is far BELOW its peers'
    (it arrives last and waits least) is the one stalling them.  Each
    candidate carries the attributed phase from
    :func:`attribute_phase`."""
    out = []
    if skew:
        for rank, st in sorted(skew['per_rank'].items()):
            if not st['chronic']:
                continue
            phase, delta = attribute_phase(spans, rank)
            out.append({
                'rank': rank, 'evidence': 'chronic_collective_lateness',
                'late_fraction': st['late_fraction'],
                'mean_late_ms': st['mean_late_ms'],
                'phase': phase, 'phase_delta_ms': delta,
            })
    if out:
        return out
    step_meds = {}
    for s in spans:
        if s.get('name') == 'jitted_step':
            step_meds.setdefault(int(s.get('rank', 0)), []).append(
                (s['t1'] - s['t0']) * 1e3)
    med_by_rank = {r: _median(v) for r, v in step_meds.items()
                   if len(v) >= 2}
    for rank, (excess, frac) in sorted(
            _excess_vs_peers(med_by_rank).items()):
        if (frac > STRAGGLER_EXCESS_FRAC
                and excess > STRAGGLER_MIN_EXCESS_MS):
            phase, delta = attribute_phase(spans, rank)
            out.append({
                'rank': rank, 'evidence': 'step_time_excess',
                'excess_ms': round(excess, 3),
                'excess_fraction': round(frac, 4),
                'phase': phase, 'phase_delta_ms': delta,
            })
    if out:
        return out
    for rank, (excess, frac) in sorted(
            _excess_vs_peers(exposed_by_rank(spans)).items()):
        deficit = -excess
        if (frac < -STRAGGLER_EXCESS_FRAC
                and deficit > STRAGGLER_MIN_EXCESS_MS):
            phase, delta = attribute_phase(spans, rank)
            out.append({
                'rank': rank, 'evidence': 'exposed_collective_deficit',
                'deficit_ms': round(deficit, 3),
                'deficit_fraction': round(-frac, 4),
                'phase': phase, 'phase_delta_ms': delta,
            })
    return out


def step_anomalies(spans, z=MAD_Z, max_rows=16):
    """Within-run MAD outliers over the raw per-step samples: for
    step time and each step phase, pool every (rank, iteration)
    duration, flag modified z-scores above ``z``, and attribute each
    flagged step to the phase that grew.  Sorted by severity.

    The FIRST step of each (phase, rank) series is excluded: it is
    warm-up (the first step builds caches and loads kernels), and
    flagging it in every capture would teach operators to ignore the
    column."""
    samples = {}  # phase -> [(value_ms, rank, iteration)]
    first_it = {}  # (phase, rank) -> smallest iteration seen
    for s in spans:
        name = s.get('name')
        if name not in ANOMALY_PHASES or 'iteration' not in s:
            continue
        rank, it = int(s.get('rank', 0)), int(s['iteration'])
        cur = first_it.get((name, rank))
        if cur is None or it < cur:
            first_it[(name, rank)] = it
        samples.setdefault(name, []).append(
            ((s['t1'] - s['t0']) * 1e3, rank, it))
    for name, vals in samples.items():
        samples[name] = [v for v in vals
                         if v[2] != first_it[(name, v[1])]]
    rows = []
    for phase, vals in samples.items():
        series = [v[0] for v in vals]
        # effective_mad, not mad: when the MAD collapses (flat series
        # with a lone spike) robust_outliers flags against the mean-
        # absolute-deviation fallback, and the z reported here must
        # use that same deviation or divide by zero
        med, m = effective_mad(series)
        # min_dev: an anomalous step must ALSO be materially slow
        # (>= MIN_LATE_MS) -- sub-millisecond jitter is scheduler
        # noise however many z-scores it spans
        for i in robust_outliers(series, z, min_dev=MIN_LATE_MS):
            v, rank, it = vals[i]
            rows.append({
                'phase': phase, 'rank': rank, 'iteration': it,
                'value_ms': round(v, 3), 'median_ms': round(med, 3),
                'z': round(0.6745 * (v - med) / m, 2),
            })
    rows.sort(key=lambda r: -r['z'])
    return rows[:max_rows]


# ---------------------------------------------------------------------
# flight records + heartbeats -> crash analysis

def load_flight_records(outdir):
    """``{rank: record}`` from every complete ``flight-rank*.json``
    under a session directory; torn or sentinel-less files are
    skipped (a crash mid-dump must not poison the post-mortem)."""
    out = {}
    for path in sorted(glob.glob(
            os.path.join(outdir, 'flight-rank*.json'))):
        try:
            with open(path) as f:
                rec = json.load(f)
        except (ValueError, OSError):
            continue
        if not rec.get('complete'):
            continue
        out[int(rec.get('rank', 0))] = rec
    return out


def load_heartbeats(dirs):
    """``{process_index: beat}`` from ``heartbeat-*.json`` files in
    each directory (newest wins on duplicates)."""
    out = {}
    for d in dirs:
        if not d:
            continue
        for path in sorted(glob.glob(
                os.path.join(d, 'heartbeat-*.json'))):
            try:
                with open(path) as f:
                    beat = json.load(f)
            except (ValueError, OSError):
                continue
            pi = beat.get('process_index')
            if pi is None:
                continue
            pi = int(pi)
            if (pi not in out
                    or beat.get('time', 0) > out[pi].get('time', 0)):
                out[pi] = dict(beat, path=path)
    return out


def _last_collective_from_events(spans, rank):
    best = None
    for s in spans:
        if (int(s.get('rank', 0)) == rank
                and s.get('kind') == 'collective'):
            if best is None or s['t1'] > best['t1']:
                best = s
    return best


def crash_analysis(outdir, metas, spans, events, flights,
                   liveness_dirs=(), stall_timeout=None):
    """Post-mortem death/blocked verdicts from flight records +
    heartbeats.

    A rank is DEAD when (a) its flight record's reason is a chaos
    kill site or a preemption signal, (b) a surviving rank's typed
    ``PeerDeadError`` flight record accuses it, or (c) its heartbeat
    froze ``stall_timeout`` earlier than the newest heartbeat in the
    directory (relative age: the doctor runs after everything exited,
    so absolute age means nothing).  Each dead rank is reported with
    its last completed collective (name + seq), preferring its own
    flight record (written BEFORE ``os._exit``) over its event log.
    Survivors' flight records contribute their open spans -- where
    each one was blocked when it detected the death."""
    dirs = list(liveness_dirs)
    timeout = stall_timeout
    for e in events:
        if e.get('name') == 'liveness_enabled':
            if e.get('dir'):
                dirs.append(e['dir'])
            if timeout is None and e.get('stall_timeout'):
                timeout = float(e['stall_timeout'])
    for rec in flights.values():
        if rec.get('liveness_dir'):
            dirs.append(rec['liveness_dir'])
    # liveness dirs are often given relative to the run's cwd; also
    # try them under the capture dir so the doctor works from anywhere
    cand = []
    for d in dict.fromkeys(dirs):
        cand.append(d)
        if not os.path.isabs(d):
            cand.append(os.path.join(outdir, d))
    cand.append(outdir)
    beats = load_heartbeats(dict.fromkeys(cand))
    timeout = 5.0 if timeout is None else timeout

    ranks = sorted({int(m.get('rank', 0)) for m in metas}
                   | set(flights) | set(beats))
    dead = {}  # rank -> [reasons]

    def accuse(rank, why):
        dead.setdefault(rank, []).append(why)

    preempted = set()
    for rank, rec in flights.items():
        reason = str(rec.get('reason') or '')
        if reason.startswith(('chaos:kill', 'chaos:ckpt_kill')):
            accuse(rank, 'flight record: %s' % reason)
        elif reason == 'sigterm':
            # a SIGTERM flight followed by a completed checkpoint
            # span is a CLEAN preemption-evacuation; only a SIGTERM
            # with no checkpoint after it reads as a death (the
            # scheduler's SIGKILL follow-up won)
            evacuated = any(
                s.get('name') == 'checkpoint_write'
                and int(s.get('rank', 0)) == rank
                and s['t1'] >= rec.get('t', 0)
                for s in spans)
            if evacuated:
                preempted.add(rank)
            else:
                accuse(rank, 'flight record: preemption signal with '
                       'no checkpoint after it')
        elif reason == 'PeerDeadError':
            attrs = rec.get('attrs') or {}
            peer = attrs.get('process_index')
            if peer is not None:
                accuse(int(peer),
                       'rank %d raised PeerDeadError naming it' % rank)
    if len(beats) >= 2:
        newest = max(b.get('time', 0) for b in beats.values())
        for rank, b in beats.items():
            if newest - b.get('time', 0) > timeout:
                accuse(rank, 'heartbeat froze %.1fs before the newest'
                       % (newest - b.get('time', 0)))

    # fired chaos injections per rank, from the event timeline: the
    # flight record keeps only the LAST dump's reason (a later typed
    # or sigterm dump overwrites a chaos one -- e.g. hang_step then
    # the escalation SIGTERM), so the injection history must come
    # from the events, which are append-only
    chaos_events = {}
    for e in events:
        name = str(e.get('name') or '')
        if e.get('kind') == 'chaos' or name.startswith('chaos:'):
            chaos_events.setdefault(
                int(e.get('rank', 0)), []).append(name)

    # an accused rank may have left no meta/flight/beat of its own
    # (killed before its first flush); it still belongs in the verdict
    ranks = sorted(set(ranks) | set(dead) | set(chaos_events))
    per_rank = {}
    for rank in ranks:
        rec = flights.get(rank)
        state = ('dead' if rank in dead
                 else 'preempted' if rank in preempted else 'alive')
        info = {'state': state, 'why': dead.get(rank, [])}
        if rank in chaos_events:
            info['chaos_events'] = chaos_events[rank]
        beat = beats.get(rank)
        if beat is not None:
            info['last_heartbeat_iteration'] = beat.get('iteration')
        if rec is not None:
            info['flight_reason'] = rec.get('reason')
            last = (rec.get('last_collective')
                    or _last_collective_from_events(spans, rank))
            if last is not None:
                info['last_collective'] = {
                    'name': last.get('name'), 'seq': last.get('seq'),
                    'tag': last.get('tag')}
            if rec.get('last_p2p'):
                lp = rec['last_p2p']
                info['last_p2p'] = {
                    'name': lp.get('name'), 'seq': lp.get('seq'),
                    'dest': lp.get('dest'), 'source': lp.get('source')}
            blocked = [s for s in (rec.get('open_spans') or [])
                       if s.get('kind') in ('collective', 'p2p')]
            if blocked:
                info['blocked_in'] = blocked
        elif rank in dead:
            last = _last_collective_from_events(spans, rank)
            if last is not None:
                info['last_collective'] = {
                    'name': last.get('name'), 'seq': last.get('seq'),
                    'tag': last.get('tag')}
        per_rank[rank] = info
    return {
        'dead_ranks': sorted(dead),
        'per_rank': per_rank,
        'heartbeat_dirs': [d for d in dict.fromkeys(cand)
                           if glob.glob(os.path.join(
                               d, 'heartbeat-*.json'))],
        'stall_timeout_s': timeout,
    }


# ---------------------------------------------------------------------
# the doctor

def diagnose(outdir, liveness_dirs=(), z=MAD_Z):
    """The full cross-rank diagnosis of one capture directory: skew
    attribution + straggler flags + step anomalies + crash analysis,
    under a single machine-readable ``verdict``."""
    metas, spans, events, bad = load_rank_logs(outdir)
    flights = load_flight_records(outdir)
    # serve recognition: a forward-only serving capture may hold ONLY
    # metrics (the bench's in-memory window exports histograms, no
    # event log) -- the serve summary is computed from the metrics
    # files so such a capture is diagnosable, not "empty"
    serve = serve_summary(aggregate_metrics(load_rank_metrics(outdir)))
    requests = request_summary(spans + events)
    skew = collective_skew(spans)
    stragglers = find_stragglers(spans, skew)
    anomalies = step_anomalies(spans, z=z)
    crash = crash_analysis(outdir, metas, spans, events, flights,
                           liveness_dirs=liveness_dirs)
    ranks = sorted({int(m.get('rank', 0)) for m in metas}
                   | {int(s.get('rank', 0)) for s in spans}
                   | set(flights))
    dead = crash['dead_ranks']
    straggler = stragglers[0] if stragglers else None
    # typed-failure black boxes (a timeout/corruption that did not
    # kill anyone still deserves the operator's eye)
    typed_flights = {
        r: rec.get('reason') for r, rec in sorted(flights.items())
        if rec.get('reason') in ('ChannelTimeout', 'PeerDeadError',
                                 'CheckpointCorruptError')}
    # protocol replay: did every (surviving) rank issue the same
    # collectives in the same order?  Dead ranks are excluded -- a
    # stream truncated by death is the crash verdict's finding.
    protocol = protocol_divergence(spans, exclude_ranks=dead)
    healthy = (not dead and not straggler and not anomalies
               and not typed_flights and protocol is None)
    summary = []
    for r in dead:
        info = crash['per_rank'][r]
        line = 'rank %d is DEAD (%s)' % (r, '; '.join(info['why']))
        last = info.get('last_collective')
        if last:
            line += ', last completed collective %s seq %s' % (
                last.get('name'), last.get('seq'))
        summary.append(line)
    for r, info in sorted(crash['per_rank'].items()):
        for b in info.get('blocked_in', []):
            summary.append(
                'rank %d was blocked in %s(%s)' % (
                    r, b.get('name'),
                    ', '.join('%s=%s' % (k, v)
                              for k, v in sorted(b.items())
                              if k not in ('name', 'kind', 't0'))))
    if straggler is not None:
        if straggler['evidence'] == 'chronic_collective_lateness':
            summary.append(
                'rank %d arrives %.1f ms late to %.0f%% of paired '
                'collectives (phase: %s)'
                % (straggler['rank'], straggler['mean_late_ms'],
                   straggler['late_fraction'] * 100,
                   straggler['phase'] or 'unattributed'))
        else:
            ms = straggler.get('excess_ms',
                               straggler.get('deficit_ms', 0.0))
            summary.append(
                'rank %d is a straggler: %s %.1f ms vs peers '
                '(phase: %s)'
                % (straggler['rank'], straggler['evidence'], ms,
                   straggler['phase'] or 'unattributed'))
    for r, reason in typed_flights.items():
        if r not in dead:
            summary.append('rank %d hit a typed failure: %s (see its '
                           'flight record)' % (r, reason))
    if protocol is not None:
        summary.append('protocol divergence at %s'
                       % protocol['summary'])
        for r, info in sorted(protocol['ranks'].items()):
            summary.append(
                'rank %s ops around position %d: %s'
                % (r, protocol['position'],
                   ' '.join(info['context']) or '(stream ended)'))
    if anomalies and not straggler:
        a = anomalies[0]
        summary.append(
            '%d anomalous step(s); worst: iteration %d rank %d '
            '%s %.1f ms (median %.1f ms, z=%.1f)'
            % (len(anomalies), a['iteration'], a['rank'], a['phase'],
               a['value_ms'], a['median_ms'], a['z']))
    if serve:
        lat = serve.get('latency_ms') or {}
        summary.append(
            'serving capture: %.0f requests / %.0f batches, %.0f shed'
            % (serve['requests'], serve['batches'], serve['shed'])
            + ('; latency p50 %.3f ms p99 %.3f ms'
               % (lat['p50'], lat['p99'])
               if lat.get('p50') is not None else ''))
        gen = serve.get('generate')
        if gen:
            ttft = gen.get('ttft_ms') or {}
            itl = gen.get('intertoken_ms') or {}
            line = ('decode capture: %.0f tokens over %.0f decode '
                    'steps' % (gen['tokens'], gen['decode_steps']))
            if gen.get('tokens_per_s'):
                line += ' (%.0f tok/s)' % gen['tokens_per_s']
            if ttft.get('p50') is not None:
                line += ('; TTFT p50 %.3f ms p99 %.3f ms'
                         % (ttft['p50'], ttft['p99']))
            if itl.get('p50') is not None:
                line += ('; inter-token p50 %.3f ms p99 %.3f ms'
                         % (itl['p50'], itl['p99']))
            summary.append(line)
        if serve.get('shed_reasons'):
            summary.append('shed reasons: ' + ', '.join(
                '%s=%.0f' % (k, v) for k, v
                in sorted(serve['shed_reasons'].items())))
    if requests and requests.get('worst'):
        worst = requests['worst']
        summary.append(
            'worst traced request %s: e2e %.3f ms (%s)'
            % (worst['request_id'], worst['e2e_ms'],
               ', '.join('%s %.3f' % (k, v) for k, v
                         in worst['stage_ms'].items())))
    input_bound = input_bound_stats(step_table(spans))
    if input_bound is not None and input_bound['input_bound']:
        # the input twin of the straggler-phase attribution: the
        # dominating phase is host-side batch prep, so the fix is
        # loader capacity (workers/prefetch), not the device
        summary.append(
            'input-bound: rank %d host_batch_prep p50 %.1f ms >= '
            'jitted_step p50 %.1f ms (%.0f%% of the step) -- scale '
            'the streaming loader (n_workers/prefetch), the device '
            'is idle waiting on data'
            % (input_bound['rank'],
               input_bound['host_batch_prep_p50_ms'],
               input_bound['jitted_step_p50_ms'],
               input_bound['input_fraction'] * 100))
    if healthy:
        summary.append('no cross-rank skew, stragglers, anomalies or '
                       'deaths detected')
    return {
        'outdir': outdir,
        'ranks': ranks,
        'n_spans': len(spans),
        'n_events': len(events),
        'n_flight_records': len(flights),
        'serve': serve,
        'requests': requests,
        'n_unparseable_lines': bad,
        'collective_skew': skew,
        'stragglers': stragglers,
        'step_anomalies': anomalies,
        'input_bound': input_bound,
        'crash': crash,
        'protocol_divergence': protocol,
        'verdict': {
            'healthy': healthy,
            'dead_ranks': dead,
            'protocol_divergence': protocol,
            'straggler_rank': (None if straggler is None
                               else straggler['rank']),
            'straggler_phase': (None if straggler is None
                                else straggler['phase']),
            'summary': summary,
        },
    }


def quick_verdict(outdir, liveness_dirs=()):
    """Library-callable doctor: the full :func:`diagnose` dict for a
    capture directory, or ``None`` when there is nothing to diagnose
    (missing directory, or a capture with no spans, events or flight
    records).  NEVER raises -- this is the supervisor's cross-check
    path, and a torn capture from a freshly killed pod must degrade
    to "no doctor opinion", not crash the component whose whole job
    is surviving that death."""
    try:
        if not os.path.isdir(outdir):
            return None
        diag = diagnose(outdir, liveness_dirs=liveness_dirs)
        if not (diag['n_spans'] or diag['n_events']
                or diag['n_flight_records'] or diag['serve']):
            return None
        return diag
    except Exception:
        return None


def skew_summary(spans):
    """The two bench-row fields (``collective_skew_p99_ms`` /
    ``straggler_rank``) from a span list -- honest Nones on
    single-rank or unpaired captures."""
    skew = collective_skew(spans)
    stragglers = find_stragglers(spans, skew)
    return {
        'collective_skew_p99_ms': (None if skew is None
                                   else skew['skew_ms']['p99']),
        'straggler_rank': (stragglers[0]['rank'] if stragglers
                           else None),
    }


def render_doctor_text(diag):
    lines = ['telemetry doctor: %s' % diag['outdir'],
             'ranks: %s   spans: %d   events: %d   flight records: %d'
             % (diag['ranks'], diag['n_spans'], diag['n_events'],
                diag['n_flight_records'])]
    skew = diag['collective_skew']
    if skew is None:
        lines.append('collective skew: no paired collective spans '
                     '(single rank, or capture predates seq tagging)')
    else:
        lines.append(
            'collective skew over %d paired collectives: p50 %.3f ms  '
            'p99 %.3f ms  max %.3f ms'
            % (skew['paired'], skew['skew_ms']['p50'],
               skew['skew_ms']['p99'], skew['skew_ms']['max']))
        for r, st in sorted(skew['per_rank'].items()):
            lines.append(
                '  rank %d: latest in %5.1f%% of collectives, mean '
                'lateness %8.3f ms%s'
                % (r, st['late_fraction'] * 100, st['mean_late_ms'],
                   '  [CHRONIC]' if st['chronic'] else ''))
        for row in skew['worst'][:4]:
            lines.append(
                '  widest: %s seq %s  skew %.3f ms  (rank %d last)'
                % (row['name'], row['seq'], row['skew_ms'],
                   row['late_rank']))
    serve = diag.get('serve')
    if serve:
        lat = serve.get('latency_ms') or {}
        lines.append(
            'serving: %.0f requests / %.0f batches, %.0f shed%s'
            % (serve['requests'], serve['batches'], serve['shed'],
               '  (latency p50 %.3f ms  p99 %.3f ms)'
               % (lat['p50'], lat['p99'])
               if lat.get('p50') is not None else ''))
    for s in diag['stragglers']:
        lines.append('straggler: rank %d (%s, phase: %s)'
                     % (s['rank'], s['evidence'],
                        s['phase'] or 'unattributed'))
    for a in diag['step_anomalies'][:6]:
        lines.append(
            'anomaly: iteration %d rank %d %s %.3f ms (median %.3f, '
            'z=%.1f)' % (a['iteration'], a['rank'], a['phase'],
                         a['value_ms'], a['median_ms'], a['z']))
    crash = diag['crash']
    for r in crash['dead_ranks']:
        info = crash['per_rank'][r]
        lines.append('dead: rank %d -- %s' % (r, '; '.join(info['why'])))
        if info.get('last_collective'):
            last = info['last_collective']
            lines.append('  last completed collective: %s seq %s'
                         % (last.get('name'), last.get('seq')))
    for r, info in sorted(crash['per_rank'].items()):
        for b in info.get('blocked_in', []):
            lines.append('blocked: rank %d in %s (%s)' % (
                r, b.get('name'),
                ', '.join('%s=%s' % (k, v) for k, v in sorted(b.items())
                          if k not in ('name', 'kind', 't0'))))
    protocol = diag.get('protocol_divergence')
    if protocol is not None:
        lines.append('protocol divergence: first divergent position '
                     '%d (%s)' % (protocol['position'],
                                  protocol['kind']))
        for r, info in sorted(protocol['ranks'].items()):
            lines.append('  rank %s: %s   around: %s'
                         % (r, info['op'] or '<stream ended>',
                            ' '.join(info['context'])
                            or '(stream ended)'))
    lines.append('verdict: %s' % ('HEALTHY' if diag['verdict']['healthy']
                                  else 'UNHEALTHY'))
    for s in diag['verdict']['summary']:
        lines.append('  - %s' % s)
    return '\n'.join(lines)


def export(outdir, diag=None, liveness_dirs=()):
    """Write ``doctor_report.json`` next to the per-rank logs and
    return the diagnosis."""
    diag = diag or diagnose(outdir, liveness_dirs=liveness_dirs)
    path = os.path.join(outdir, 'doctor_report.json')
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(diag, f, indent=1, default=repr)
    os.replace(tmp, path)
    return diag
