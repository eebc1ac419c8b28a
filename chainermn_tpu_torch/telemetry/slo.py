"""Live sliding-window SLO monitor with multi-window burn-rate verdicts
over the serving path's request traces.

Counterpart of ``chainermn_tpu/telemetry/slo.py``; the verdict dicts have
the JAX package's keys and layout, which the fleet's canary judge and the
``slo`` subcommand of ``python -m chainermn_tpu_torch.telemetry`` read.

- **Sliding windows as a ring of time-bucketed sub-histograms.**
  :class:`WindowedHistogram` keeps raw samples in fixed-width time
  buckets (default 1 s) keyed by absolute index (``floor(t /
  bucket_s)``) and answers a windowed percentile by merging the buckets
  inside the window: exact over the window, never an average of
  per-bucket percentiles; two ranks' windows merge bucket-wise.
- **Multi-window burn rates.**  An :class:`SLO` carries a target, an
  objective (the good-event fraction) and a FAST and a SLOW window.  The
  burn rate is the bad-event fraction over the error budget (``1 -
  objective``); the verdict is ``breach`` only when both windows burn
  above ``page_burn``, ``warn`` when both exceed ``warn_burn``, else
  ``ok``.

Five series come from the per-request trace records the serving engines
emit (``kind='request'`` stages and events, the ``serve_decode`` /
``serve_verify`` spans and the ``serve_spec`` event): time to first
token, inter-token gap, tokens/s, shed fraction and slot occupancy (and
the batch path's end-to-end latency).

Two modes share :meth:`SLOMonitor.ingest`: live
(``monitor.attach(recorder)`` registers a streaming listener on the
recorder; :meth:`SLOMonitor.evaluate` answers at any instant and an
``outdir`` gets a periodic ``slo_snapshot.json``, paced by RECORD time),
and offline (:func:`evaluate_capture` replays a capture's records in
time order and gives the verdict as of its last instant, what the live
monitor would have said then).  The verdict dict mirrors the doctor's
shape (``healthy`` and ``summary`` lines under ``verdict``).
"""

import collections
import json
import os

from chainermn_tpu_torch.telemetry.recorder import _percentile

#: sub-histogram bucket width (seconds): the time resolution of the
#: sliding window -- windows round outward to whole buckets
DEFAULT_BUCKET_SECONDS = 1.0
#: ring retention: buckets older than this many behind the newest are
#: evicted (bounds memory for an engine left serving for days)
DEFAULT_MAX_BUCKETS = 600
DEFAULT_FAST_WINDOW_S = 30.0
DEFAULT_SLOW_WINDOW_S = 150.0

#: verdict tiers, mildest first (index = severity)
VERDICT_TIERS = ('ok', 'warn', 'breach')


class WindowedHistogram:
    """Raw-sample distribution over a sliding time window.

    Samples land in fixed-width time buckets keyed by ABSOLUTE bucket
    index, kept in a bounded ring (insertion-ordered dict; the oldest
    bucket is evicted when the ring outgrows ``max_buckets``).  Any
    windowed summary merges the raw samples of the buckets that
    intersect ``[now - window_s, now]`` -- exact percentiles over the
    window, the same no-averaged-percentiles contract as the registry
    histograms.  Bucket keys are absolute, so two ranks' histograms
    over the same wall clock merge bucket-wise."""

    def __init__(self, bucket_s=DEFAULT_BUCKET_SECONDS,
                 max_buckets=DEFAULT_MAX_BUCKETS):
        if bucket_s <= 0:
            raise ValueError('bucket_s must be > 0, got %r' % bucket_s)
        self.bucket_s = float(bucket_s)
        self.max_buckets = int(max_buckets)
        self._buckets = collections.OrderedDict()  # index -> [samples]

    def _index(self, t):
        return int(t // self.bucket_s)

    def observe(self, value, t):
        idx = self._index(t)
        bucket = self._buckets.get(idx)
        if bucket is None:
            bucket = self._buckets[idx] = []
            self._evict()
        bucket.append(float(value))

    def _evict(self):
        if not self._buckets:
            return
        newest = max(self._buckets)
        floor = newest - self.max_buckets + 1
        for idx in [i for i in self._buckets if i < floor]:
            del self._buckets[idx]

    def window_samples(self, window_s, now):
        """Ascending raw samples from the buckets intersecting
        ``[now - window_s, now]`` (window rounded outward to whole
        buckets; an empty window returns ``[]``)."""
        lo = self._index(now - window_s)
        hi = self._index(now)
        out = []
        for idx, samples in self._buckets.items():
            if lo <= idx <= hi:
                out.extend(samples)
        out.sort()
        return out

    def summary(self, window_s, now):
        """Exact windowed summary: ``{'count': 0}`` when the window
        holds nothing (absence reported as absence, never fabricated
        zeros)."""
        s = self.window_samples(window_s, now)
        if not s:
            return {'count': 0}
        return {
            'count': len(s),
            'mean': sum(s) / len(s),
            'min': s[0],
            'max': s[-1],
            'p50': _percentile(s, 0.50),
            'p99': _percentile(s, 0.99),
        }

    def merge(self, other):
        """Fold ``other``'s time buckets into this histogram (the
        cross-rank merge: bucket indices are absolute, so the same
        wall-clock second lands in the same bucket on every rank).
        Bucket widths must match -- merging mismatched resolutions
        would silently mis-bucket."""
        if abs(other.bucket_s - self.bucket_s) > 1e-12:
            raise ValueError(
                'cannot merge windowed histograms with bucket_s %r '
                'and %r' % (self.bucket_s, other.bucket_s))
        for idx, samples in other._buckets.items():
            self._buckets.setdefault(idx, []).extend(samples)
        self._evict()
        return self

    def total_count(self):
        return sum(len(b) for b in self._buckets.values())


class WindowedCounter:
    """Time-bucketed event counts (the windowed twin of the registry
    ``Counter``): windowed totals back the rate and fraction SLOs."""

    def __init__(self, bucket_s=DEFAULT_BUCKET_SECONDS,
                 max_buckets=DEFAULT_MAX_BUCKETS):
        self._hist = WindowedHistogram(bucket_s, max_buckets)

    def inc(self, t, n=1.0):
        self._hist.observe(n, t)

    def total(self, window_s, now):
        return sum(self._hist.window_samples(window_s, now))

    def merge(self, other):
        self._hist.merge(other._hist)
        return self


class SLO:
    """One declarative service-level objective.

    Args:
      name: verdict key (``ttft_p99``, ``shed_fraction``, ...).
      metric: the monitored series -- one of ``ttft_seconds``,
        ``intertoken_seconds``, ``latency_seconds`` (the batch
        path's submit-to-result e2e), ``tokens_per_s``,
        ``shed_fraction``, ``slot_occupancy``.
      kind: how the series is judged:

        - ``'latency'``: good event = sample <= ``target`` seconds;
          error budget = ``1 - objective``; burn rate = bad fraction
          over budget, judged multi-window.
        - ``'fraction'``: the bad fraction is tracked directly (shed
          requests over outcomes) and ``target`` IS the budget.
        - ``'rate_min'``: the windowed rate must stay >= ``target``;
          ``warn`` when below in both windows, ``breach`` when below
          ``breach_ratio * target`` in both.
        - ``'level_max'``: the windowed mean must stay < ``target``;
          ``warn`` when at/above in both windows, ``breach`` when
          ``breach_level`` is set and reached in both (the default
          occupancy SLO leaves it None: saturation is a capacity
          heads-up, not an outage).

      target: the objective's threshold, in the metric's own unit.
      objective: good-event fraction for ``'latency'`` (default 0.99).
      fast_window_s / slow_window_s: the multi-window pair.
      page_burn / warn_burn: burn-rate thresholds (both windows must
        exceed them).
      min_events: below this many slow-window events the verdict is
        ``ok`` with ``data=False`` -- a cold window must not page.
      breach_ratio / breach_level: the ``rate_min`` / ``level_max``
        escalation knobs.
    """

    def __init__(self, name, metric, kind, target, objective=0.99,
                 fast_window_s=DEFAULT_FAST_WINDOW_S,
                 slow_window_s=DEFAULT_SLOW_WINDOW_S,
                 page_burn=8.0, warn_burn=2.0, min_events=4,
                 breach_ratio=0.5, breach_level=None):
        if kind not in ('latency', 'fraction', 'rate_min',
                        'level_max'):
            raise ValueError('unknown SLO kind %r' % kind)
        if fast_window_s > slow_window_s:
            raise ValueError(
                'fast window %.1fs exceeds slow window %.1fs'
                % (fast_window_s, slow_window_s))
        self.name = name
        self.metric = metric
        self.kind = kind
        self.target = float(target)
        self.objective = float(objective)
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self.page_burn = float(page_burn)
        self.warn_burn = float(warn_burn)
        self.min_events = int(min_events)
        self.breach_ratio = float(breach_ratio)
        self.breach_level = breach_level

    def budget(self):
        """The error budget the burn rate is measured against."""
        if self.kind == 'fraction':
            return max(self.target, 1e-9)
        return max(1.0 - self.objective, 1e-9)

    def judge_burn(self, bad_frac_fast, bad_frac_slow, n_slow):
        """Multi-window burn-rate verdict for the event kinds
        (``latency`` / ``fraction``)."""
        if n_slow < self.min_events:
            return {'verdict': 'ok', 'data': False,
                    'detail': 'insufficient data (%d events in the '
                              'slow window, need %d)'
                              % (n_slow, self.min_events)}
        budget = self.budget()
        burn_fast = bad_frac_fast / budget
        burn_slow = bad_frac_slow / budget
        if burn_fast >= self.page_burn and burn_slow >= self.page_burn:
            verdict = 'breach'
        elif (burn_fast >= self.warn_burn
              and burn_slow >= self.warn_burn):
            verdict = 'warn'
        else:
            verdict = 'ok'
        return {'verdict': verdict, 'data': True,
                'burn_fast': round(burn_fast, 3),
                'burn_slow': round(burn_slow, 3)}

    def judge_level(self, value_fast, value_slow):
        """Threshold verdict for the level kinds (``rate_min`` /
        ``level_max``); ``None`` values mean no data."""
        if value_fast is None or value_slow is None:
            return {'verdict': 'ok', 'data': False,
                    'detail': 'insufficient data (empty window)'}
        if self.kind == 'rate_min':
            floor = self.target * self.breach_ratio
            if value_fast < floor and value_slow < floor:
                verdict = 'breach'
            elif value_fast < self.target and value_slow < self.target:
                verdict = 'warn'
            else:
                verdict = 'ok'
        else:  # level_max
            if (self.breach_level is not None
                    and value_fast >= self.breach_level
                    and value_slow >= self.breach_level):
                verdict = 'breach'
            elif (value_fast >= self.target
                  and value_slow >= self.target):
                verdict = 'warn'
            else:
                verdict = 'ok'
        return {'verdict': verdict, 'data': True}


def default_slos(ttft_s=1.0, intertoken_s=0.25, objective=0.99,
                 max_shed_fraction=0.05, max_occupancy=0.98,
                 min_tokens_per_s=None, latency_s=None,
                 fast_window_s=DEFAULT_FAST_WINDOW_S,
                 slow_window_s=DEFAULT_SLOW_WINDOW_S):
    """The serving SLO set the bench and the CLI start from;
    every threshold is a keyword so a deployment (or a test pinning
    determinism) declares its own numbers.  ``latency_s`` adds the
    batch path's end-to-end request-latency objective (fed from
    ``execute`` stage spans) -- the generation metrics stay silent on
    a batch fleet, so this is what its canary gate judges."""
    slos = [
        SLO('ttft_p99', 'ttft_seconds', 'latency', ttft_s,
            objective=objective, fast_window_s=fast_window_s,
            slow_window_s=slow_window_s),
        SLO('intertoken_p99', 'intertoken_seconds', 'latency',
            intertoken_s, objective=objective,
            fast_window_s=fast_window_s, slow_window_s=slow_window_s),
        SLO('shed_fraction', 'shed_fraction', 'fraction',
            max_shed_fraction, fast_window_s=fast_window_s,
            slow_window_s=slow_window_s),
        SLO('slot_occupancy', 'slot_occupancy', 'level_max',
            max_occupancy, fast_window_s=fast_window_s,
            slow_window_s=slow_window_s),
    ]
    if min_tokens_per_s is not None:
        slos.append(SLO('tokens_per_s', 'tokens_per_s', 'rate_min',
                        min_tokens_per_s,
                        fast_window_s=fast_window_s,
                        slow_window_s=slow_window_s))
    if latency_s is not None:
        slos.append(SLO('latency_p99', 'latency_seconds', 'latency',
                        latency_s, objective=objective,
                        fast_window_s=fast_window_s,
                        slow_window_s=slow_window_s))
    return slos


class SLOMonitor:
    """In-process sliding-window aggregator + verdict engine.

    Feed it records through :meth:`ingest` -- either live, by
    :meth:`attach`-ing it to the active recorder as a streaming
    listener, or offline, by replaying a capture
    (:func:`evaluate_capture`).  Time comes exclusively from the
    RECORDS (never the wall clock), so a replay reproduces the live
    verdicts exactly.

    Args:
      slos: :class:`SLO` list (default :func:`default_slos`).
      bucket_s: sub-histogram bucket width.
      n_slots: occupancy denominator fallback when the
        ``serve_decode`` span carries no ``n_slots`` attribute.
      outdir / snapshot_every_s: when ``outdir`` is set, a
        ``slo_snapshot.json`` verdict is (re)written there every
        ``snapshot_every_s`` seconds of RECORD time.
      record_filter: optional predicate over raw records, applied
        BEFORE the serving-vocabulary dispatch.  The fleet's canary
        gate runs one monitor per (replica, parameter version) over a
        SHARED recorder stream by filtering on the ``replica`` /
        ``version`` attrs the engines stamp -- two monitors with
        disjoint filters see disjoint traffic and judge independently.
    """

    def __init__(self, slos=None, bucket_s=DEFAULT_BUCKET_SECONDS,
                 max_buckets=DEFAULT_MAX_BUCKETS, n_slots=None,
                 outdir=None, snapshot_every_s=5.0,
                 record_filter=None):
        self.record_filter = record_filter
        self.slos = list(slos) if slos is not None else default_slos()
        self.n_slots = n_slots
        self.outdir = outdir
        self.snapshot_every_s = float(snapshot_every_s)
        mk_h = lambda: WindowedHistogram(bucket_s, max_buckets)  # noqa: E731
        mk_c = lambda: WindowedCounter(bucket_s, max_buckets)    # noqa: E731
        self.ttft = mk_h()
        self.intertoken = mk_h()
        self.latency = mk_h()   # batch path: submit-to-result e2e
        self.occupancy = mk_h()
        self.tokens = mk_c()
        self.completed = mk_c()
        self.shed = mk_c()
        # speculative decoding (serving/generate.py spec mode): the
        # per-tick ``serve_spec`` event feeds windowed proposed /
        # accepted totals; evaluate() surfaces their ratio
        self.draft_proposed = mk_c()
        self.draft_accepted = mk_c()
        self._t_first = None
        self._t_last = None
        self._last_snapshot_t = None
        self._t0_by_request = collections.OrderedDict()
        self.n_ingested = 0
        self._attached = None

    # -- the one ingestion path (live listener AND offline replay) ----
    def ingest(self, rec):
        """Consume one recorder record (span or event dict); records
        that are not part of the serving vocabulary -- or that the
        ``record_filter`` rejects -- are ignored."""
        if self.record_filter is not None \
                and not self.record_filter(rec):
            return
        kind = rec.get('kind')
        if kind == 'request':
            self._ingest_request(rec)
        elif kind == 'serve' and rec.get('name') in ('serve_decode',
                                                     'serve_verify'):
            # the speculative engine's verify span IS its decode tick
            # (same active_slots/n_slots attrs), so occupancy keeps
            # flowing in spec mode
            self._ingest_decode_tick(rec)
        elif kind == 'serve' and rec.get('name') == 'serve_spec':
            self._ingest_spec_tick(rec)
        else:
            return
        if (self.outdir is not None and self._t_last is not None
                and (self._last_snapshot_t is None
                     or self._t_last - self._last_snapshot_t
                     >= self.snapshot_every_s)):
            self._last_snapshot_t = self._t_last
            self.write_snapshot()

    def _seen(self, t):
        self.n_ingested += 1
        if self._t_first is None or t < self._t_first:
            self._t_first = t
        if self._t_last is None or t > self._t_last:
            self._t_last = t

    def _ingest_request(self, rec):
        name = rec.get('name')
        rid = rec.get('request_id')
        if 't0' in rec and 't1' in rec:           # stage span
            t0, t1 = rec['t0'], rec['t1']
            self._seen(t1)
            if name == 'queue_wait':
                self._t0_by_request[rid] = t0
                # bound the in-flight map: a shed/complete that never
                # arrives (torn capture) must not grow it forever
                while len(self._t0_by_request) > 4096:
                    self._t0_by_request.popitem(last=False)
            elif name == 'prefill':
                start = self._t0_by_request.get(rid, t0)
                self.ttft.observe(t1 - start, t1)
                self.tokens.inc(t1, 1.0)          # the first token
            elif name == 'decode':
                self.intertoken.observe(t1 - t0, t1)
                self.tokens.inc(t1, 1.0)
            elif name == 'execute':
                # the batch path's terminal stage: the request's
                # end-to-end latency (admission stamp -> execute end)
                # feeds the latency series the batch-fleet canary
                # gate judges; a served request is an outcome even
                # though it generates no tokens
                start = self._t0_by_request.get(rid, t0)
                self.latency.observe(t1 - start, t1)
        elif 't' in rec:                          # terminal event
            t = rec['t']
            self._seen(t)
            if name == 'complete':
                self.completed.inc(t, 1.0)
            elif name == 'shed':
                self.shed.inc(t, 1.0)
            self._t0_by_request.pop(rid, None)

    def _ingest_decode_tick(self, rec):
        if 't1' not in rec:
            return
        self._seen(rec['t1'])
        n_slots = rec.get('n_slots') or self.n_slots
        active = rec.get('active_slots')
        if n_slots and active is not None:
            self.occupancy.observe(active / float(n_slots), rec['t1'])

    def _ingest_spec_tick(self, rec):
        """Per-tick speculative accounting (the ``serve_spec`` event):
        draft tokens submitted to the target verify vs accepted."""
        if 't' not in rec:
            return
        t = rec['t']
        self._seen(t)
        self.draft_proposed.inc(t, float(rec.get('proposed') or 0))
        self.draft_accepted.inc(t, float(rec.get('accepted') or 0))

    # -- live attachment ----------------------------------------------
    def attach(self, recorder):
        """Register as a streaming listener on ``recorder``."""
        recorder.add_listener(self.ingest)
        self._attached = recorder
        return self

    def detach(self):
        if self._attached is not None:
            self._attached.remove_listener(self.ingest)
            self._attached = None

    # -- evaluation ----------------------------------------------------
    def _effective_window(self, window_s, now):
        """Rate denominators clamp to the observed span: a 10-second
        capture judged over a 150-second window must not report a
        15x-diluted tokens/s."""
        if self._t_first is None:
            return window_s
        seen = max(now - self._t_first, 0.0)
        return max(min(window_s, seen),
                   min(window_s, DEFAULT_BUCKET_SECONDS))

    def _hist_for(self, metric):
        return {'ttft_seconds': self.ttft,
                'intertoken_seconds': self.intertoken,
                'latency_seconds': self.latency}[metric]

    def _window_view(self, metric, window_s, now):
        """``(bad_fraction_or_None, value, n_events, stats)`` for one
        metric over one window."""
        if metric in ('ttft_seconds', 'intertoken_seconds',
                      'latency_seconds'):
            hist = self._hist_for(metric)
            samples = hist.window_samples(window_s, now)
            stats = hist.summary(window_s, now)
            return None, stats.get('p99'), len(samples), stats
        if metric == 'shed_fraction':
            shed = self.shed.total(window_s, now)
            done = self.completed.total(window_s, now)
            n = shed + done
            frac = (shed / n) if n else 0.0
            return frac, frac, int(n), {'shed': shed,
                                        'completed': done,
                                        'count': int(n)}
        if metric == 'tokens_per_s':
            eff = self._effective_window(window_s, now)
            total = self.tokens.total(window_s, now)
            rate = total / eff if eff > 0 else None
            return None, rate, int(total), {'tokens': total,
                                            'window_s': eff}
        if metric == 'slot_occupancy':
            stats = self.occupancy.summary(window_s, now)
            return None, stats.get('mean'), stats.get('count', 0), stats
        raise ValueError('unknown SLO metric %r' % metric)

    def _evaluate_one(self, slo, now):
        bf_f, value_f, n_f, stats_f = self._window_view(
            slo.metric, slo.fast_window_s, now)
        bf_s, value_s, n_s, stats_s = self._window_view(
            slo.metric, slo.slow_window_s, now)
        if slo.kind == 'latency':
            samples_f = self._hist_for(slo.metric).window_samples(
                slo.fast_window_s, now)
            samples_s = self._hist_for(slo.metric).window_samples(
                slo.slow_window_s, now)
            bf_f = (sum(1 for v in samples_f if v > slo.target)
                    / len(samples_f)) if samples_f else 0.0
            bf_s = (sum(1 for v in samples_s if v > slo.target)
                    / len(samples_s)) if samples_s else 0.0
            judged = slo.judge_burn(bf_f, bf_s, len(samples_s))
        elif slo.kind == 'fraction':
            judged = slo.judge_burn(bf_f or 0.0, bf_s or 0.0, n_s)
        else:
            judged = slo.judge_level(value_f, value_s)
        row = {
            'metric': slo.metric,
            'kind': slo.kind,
            'target': slo.target,
            'fast_window_s': slo.fast_window_s,
            'slow_window_s': slo.slow_window_s,
            'fast': dict(stats_f, value=value_f),
            'slow': dict(stats_s, value=value_s),
        }
        if slo.kind == 'latency':
            row['objective'] = slo.objective
            row['bad_fraction_fast'] = round(bf_f, 4)
            row['bad_fraction_slow'] = round(bf_s, 4)
        row.update(judged)
        return row

    def evaluate(self, now=None):
        """The full verdict dict as of ``now`` (default: the newest
        ingested record's time).  Shape mirrors the doctor's --
        ``verdict.healthy`` + ``verdict.summary`` lines -- so the
        canary gate reads both through one path."""
        now = self._t_last if now is None else now
        rows = {}
        if now is not None:
            for slo in self.slos:
                rows[slo.name] = self._evaluate_one(slo, now)
        worst = 'ok'
        breaches, warnings = [], []
        for name, row in sorted(rows.items()):
            v = row['verdict']
            if VERDICT_TIERS.index(v) > VERDICT_TIERS.index(worst):
                worst = v
            if v == 'breach':
                breaches.append(name)
            elif v == 'warn':
                warnings.append(name)
        summary = []
        for name in breaches + warnings:
            row = rows[name]
            line = '%s %s: %s' % (name, row['verdict'].upper(),
                                  _describe_row(row))
            summary.append(line)
        if not summary:
            summary.append(
                'all %d SLOs ok over the fast/slow windows'
                % len(rows) if rows else 'no serving records ingested')
        speculative = None
        if now is not None:
            proposed = self.draft_proposed.total(
                DEFAULT_SLOW_WINDOW_S, now)
            accepted = self.draft_accepted.total(
                DEFAULT_SLOW_WINDOW_S, now)
            if proposed:
                # informational, not an SLO verdict: the windowed
                # accepted-draft-rate a canary dashboard reads next
                # to the latency verdicts
                speculative = {
                    'window_s': DEFAULT_SLOW_WINDOW_S,
                    'draft_proposed': proposed,
                    'draft_accepted': accepted,
                    'accepted_draft_rate': accepted / proposed,
                }
        return {
            'now': now,
            'n_ingested': self.n_ingested,
            'window_first_t': self._t_first,
            'window_last_t': self._t_last,
            'speculative': speculative,
            'slos': rows,
            'verdict': {
                'overall': worst,
                'healthy': worst == 'ok',
                'breaches': breaches,
                'warnings': warnings,
                'summary': summary,
            },
        }

    # -- snapshots -----------------------------------------------------
    def write_snapshot(self, path=None, now=None):
        """Atomically (tmp + rename) write the current verdict as
        ``slo_snapshot.json`` -- the file a canary gate polls while
        the engine serves.  Best-effort: returns the path or None."""
        path = path or (os.path.join(self.outdir, 'slo_snapshot.json')
                        if self.outdir else None)
        if path is None:
            return None
        try:
            os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
            tmp = path + '.tmp.%d' % os.getpid()
            with open(tmp, 'w') as f:
                json.dump(self.evaluate(now=now), f, indent=1,
                          default=repr)
            os.replace(tmp, path)
            return path
        except Exception:
            return None


def _describe_row(row):
    if row['kind'] == 'latency':
        return ('%.1f%% of events over %.0f ms in the fast window '
                '(burn %.1fx budget fast / %.1fx slow)'
                % (100 * row.get('bad_fraction_fast', 0.0),
                   row['target'] * 1e3, row.get('burn_fast', 0.0),
                   row.get('burn_slow', 0.0)))
    if row['kind'] == 'fraction':
        return ('%.1f%% shed vs %.1f%% budget (burn %.1fx fast / '
                '%.1fx slow)'
                % (100 * (row['fast'].get('value') or 0.0),
                   100 * row['target'], row.get('burn_fast', 0.0),
                   row.get('burn_slow', 0.0)))
    if row['kind'] == 'rate_min':
        return ('%.1f/s vs a %.1f/s floor'
                % (row['fast'].get('value') or 0.0, row['target']))
    return ('level %.3f vs a %.3f ceiling'
            % (row['fast'].get('value') or 0.0, row['target']))


# ---------------------------------------------------------------------
# offline: replay a capture directory

def evaluate_capture(outdir, slos=None,
                     bucket_s=DEFAULT_BUCKET_SECONDS, now=None):
    """Replay a capture directory's records in time order through an
    :class:`SLOMonitor` and return its verdict as of the capture's
    last instant (or ``now``).  Deterministic: the same capture always
    yields the same verdict.  The result additionally carries
    ``outdir`` and ``n_request_records`` (0 means the capture holds
    no serving trace at all -- the CLI exits 2 on it)."""
    from chainermn_tpu_torch.telemetry.report import load_rank_logs
    _metas, spans, events, bad = load_rank_logs(outdir)
    records = sorted(
        spans + events,
        key=lambda r: r.get('t1', r.get('t', r.get('t0', 0.0))))
    mon = SLOMonitor(slos=slos, bucket_s=bucket_s)
    for rec in records:
        mon.ingest(rec)
    result = mon.evaluate(now=now)
    result['outdir'] = outdir
    result['n_request_records'] = mon.n_ingested
    result['n_unparseable_lines'] = bad
    return result


def render_slo_text(result):
    lines = ['telemetry slo: %s' % result.get('outdir', '<live>'),
             'records ingested: %d' % result.get('n_ingested', 0)]
    for name, row in sorted((result.get('slos') or {}).items()):
        fast, slow = row['fast'], row['slow']
        detail = ''
        if row['kind'] == 'latency':
            detail = ('  p99 fast %s ms / slow %s ms'
                      % (_ms(fast.get('p99')), _ms(slow.get('p99'))))
        elif row['kind'] == 'fraction':
            detail = ('  shed fast %.1f%% / slow %.1f%%'
                      % (100 * (fast.get('value') or 0.0),
                         100 * (slow.get('value') or 0.0)))
        elif fast.get('value') is not None:
            detail = ('  value fast %.3f / slow %.3f'
                      % (fast.get('value') or 0.0,
                         slow.get('value') or 0.0))
        burn = ''
        if row.get('burn_fast') is not None:
            burn = ('  burn %.1fx/%.1fx'
                    % (row['burn_fast'], row['burn_slow']))
        lines.append('  %-16s %-6s%s%s%s'
                     % (name, row['verdict'].upper(), detail, burn,
                        '' if row.get('data', True)
                        else '  [no data: %s]' % row.get('detail')))
    spec = result.get('speculative')
    if spec:
        lines.append(
            '  speculative: accepted_draft_rate %.3f (%d/%d drafts '
            'over %.0fs)' % (spec['accepted_draft_rate'],
                             spec['draft_accepted'],
                             spec['draft_proposed'],
                             spec['window_s']))
    v = result['verdict']
    lines.append('verdict: %s' % v['overall'].upper())
    for s in v['summary']:
        lines.append('  - %s' % s)
    return '\n'.join(lines)


def _ms(v):
    return '-' if v is None else '%.3f' % (v * 1e3)


def export(outdir, result=None, slos=None):
    """Write ``slo_report.json`` next to the per-rank logs and return
    the result (the offline twin of the live ``slo_snapshot.json``)."""
    result = result or evaluate_capture(outdir, slos=slos)
    path = os.path.join(outdir, 'slo_report.json')
    tmp = path + '.tmp'
    with open(tmp, 'w') as f:
        json.dump(result, f, indent=1, default=repr)
    os.replace(tmp, path)
    return result
