"""The port's live SLO monitor against the JAX package.

``WindowedHistogram`` / ``WindowedCounter``, the ``SLO`` burn and level
judgements, ``SLOMonitor`` (request stages, decode and speculative ticks,
record filters, periodic snapshots, the recorder listeners it attaches
through) and ``evaluate_capture``: the same record streams, made from a
seed with numpy, go through both packages and the verdict dicts must be
equal (verdicts, reasons, percentiles, burn rates); a capture written by
either package's recorder is read by both.  The edge cases of the JAX
package's own SLO tests run on the port, and ``open_loop_generate``
reports a live monitor's verdict.
"""

import json
import os

import numpy as np
import pytest
import torch

from chainermn_tpu import telemetry as jtelemetry
from chainermn_tpu.telemetry import slo as jslo
from chainermn_tpu_torch import serving, telemetry
from chainermn_tpu_torch.telemetry import slo
from chainermn_tpu_torch.telemetry.slo import (SLO, SLOMonitor,
                                               WindowedCounter,
                                               WindowedHistogram,
                                               default_slos,
                                               evaluate_capture)

torch.set_num_threads(2)

_TEST_SLOS = dict(ttft_s=0.1, intertoken_s=0.05, fast_window_s=10.0,
                  slow_window_s=30.0)


def _slos(pkg, name):
    """Named SLO sets, built by either package's ``default_slos``."""
    return {
        'default': lambda: pkg.default_slos(),
        'test': lambda: pkg.default_slos(**_TEST_SLOS),
        'rate': lambda: pkg.default_slos(min_tokens_per_s=50.0,
                                         **_TEST_SLOS),
        'latency': lambda: pkg.default_slos(latency_s=0.05, objective=0.9,
                                            max_shed_fraction=0.2,
                                            **_TEST_SLOS),
    }[name]()


def _random_stream(seed, n_requests=60, replicas=('a', 'b'),
                   versions=(2, 4)):
    """A serving record stream from a seeded numpy generator: request
    stages tiled as the engines record them (some slow, some shed, some
    on the batch path), decode and verify ticks, speculative events, each
    stamped with a replica and a version."""
    rng = np.random.RandomState(seed)
    recs = []
    t = 1000.0
    for i in range(n_requests):
        t += float(rng.exponential(0.4))
        rid = 'r%d' % (i + 1)
        ident = {'replica': replicas[rng.randint(len(replicas))],
                 'version': int(versions[rng.randint(len(versions))])}
        if rng.rand() < 0.1:
            recs.append(dict({'type': 'event', 'kind': 'request',
                              'name': 'shed', 'request_id': rid, 't': t,
                              'reason': 'queue_full'}, **ident))
            continue
        t1 = t + float(rng.uniform(0.0005, 0.003))
        recs.append(dict({'type': 'span', 'kind': 'request',
                          'name': 'queue_wait', 'request_id': rid,
                          't0': t, 't1': t1}, **ident))
        if rng.rand() < 0.2:
            t2 = t1 + float(rng.uniform(0.005, 0.2))
            recs.append(dict({'type': 'span', 'kind': 'request',
                              'name': 'execute', 'request_id': rid,
                              't0': t1, 't1': t2}, **ident))
            recs.append(dict({'type': 'event', 'kind': 'request',
                              'name': 'complete', 'request_id': rid,
                              't': t2}, **ident))
            continue
        t2 = t1 + float(rng.uniform(0.002, 0.3))
        recs.append(dict({'type': 'span', 'kind': 'request',
                          'name': 'prefill', 'request_id': rid,
                          't0': t1, 't1': t2}, **ident))
        cur = t2
        slow = rng.rand() < 0.25
        for j in range(rng.randint(1, 9)):
            gap = float(rng.uniform(0.1, 0.3) if slow
                        else rng.uniform(0.002, 0.02))
            recs.append(dict({'type': 'span', 'kind': 'request',
                              'name': 'decode', 'request_id': rid,
                              't0': cur, 't1': cur + gap, 'step': j},
                             **ident))
            cur += gap
        recs.append(dict({'type': 'event', 'kind': 'request',
                          'name': 'complete', 'request_id': rid,
                          't': cur}, **ident))
        tick = {'type': 'span', 'kind': 'serve',
                'name': ('serve_verify' if rng.rand() < 0.3
                         else 'serve_decode'),
                't0': t, 't1': t + 0.01, 'iteration': i,
                'active_slots': int(rng.randint(0, 9)), 'n_slots': 8}
        recs.append(dict(tick, **ident))
        if rng.rand() < 0.3:
            recs.append(dict({'type': 'event', 'kind': 'serve',
                              'name': 'serve_spec', 't': t + 0.01,
                              'proposed': 3,
                              'accepted': int(rng.randint(0, 4))},
                             **ident))
        # an unrelated record both must ignore
        recs.append({'type': 'span', 'kind': 'compute',
                     'name': 'jitted_step', 't0': t, 't1': t + 0.001})
    recs.sort(key=lambda r: r.get('t1', r.get('t', r.get('t0'))))
    return recs


def _both(stream, slos_name, record_filter=None, now=None, **kw):
    mj = jslo.SLOMonitor(slos=_slos(jslo, slos_name),
                         record_filter=record_filter, **kw)
    mp = SLOMonitor(slos=_slos(slo, slos_name), record_filter=record_filter,
                    **kw)
    for rec in stream:
        mj.ingest(dict(rec))
        mp.ingest(dict(rec))
    return mj.evaluate(now), mp.evaluate(now)


# ---------------------------------------------------------------------
# the verdicts against the JAX monitor

@pytest.mark.parametrize('seed', [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize('slos_name', ['default', 'test', 'rate',
                                       'latency'])
def test_evaluate_equals_jax(seed, slos_name):
    want, got = _both(_random_stream(seed), slos_name)
    assert got == want
    assert got['slos'] and got['n_ingested'] > 0


@pytest.mark.parametrize('seed', [6, 7, 8])
def test_evaluate_at_later_instants_equals_jax(seed):
    stream = _random_stream(seed)
    t_last = stream[-1].get('t1', stream[-1].get('t'))
    for now in (t_last, t_last + 5.0, t_last + 20.0, t_last + 200.0):
        want, got = _both(stream, 'test', now=now)
        assert got == want


@pytest.mark.parametrize('replica,version', [('a', 2), ('a', 4),
                                             ('b', 4)])
def test_filtered_monitors_equal_jax(replica, version):
    """The canary's per-(replica, version) monitors over one shared
    stream: each filtered verdict equals the JAX one."""
    def keep(r):
        return r.get('replica') == replica and r.get('version') == version
    want, got = _both(_random_stream(11), 'test', record_filter=keep)
    assert got == want
    assert 0 < got['n_ingested'] < len(_random_stream(11))


def test_breach_reasons_and_burns_equal_jax():
    """A stream whose last seconds decode 40x slower breaches the
    inter-token SLO in both packages, with the same summary lines."""
    rng = np.random.RandomState(3)
    stream = []
    for i in range(40):
        t = 1000.0 + 0.5 * i
        gap = 0.2 if i >= 30 else float(rng.uniform(0.003, 0.006))
        stream.append({'type': 'span', 'kind': 'request', 'name': 'prefill',
                       'request_id': 'r%d' % i, 't0': t, 't1': t + 0.01})
        for j in range(6):
            t0 = t + 0.01 + j * gap
            stream.append({'type': 'span', 'kind': 'request',
                           'name': 'decode', 'request_id': 'r%d' % i,
                           't0': t0, 't1': t0 + gap})
    stream.sort(key=lambda r: r['t1'])
    want, got = _both(stream, 'test')
    assert got == want
    assert got['verdict']['overall'] == 'breach'
    assert 'intertoken_p99' in got['verdict']['breaches']
    assert got['verdict']['summary'][0].startswith('intertoken_p99 BREACH')


# ---------------------------------------------------------------------
# captures written by either package's recorder

def _record_session(pkg, outdir, seed):
    """Record a seeded stream through ``pkg``'s recorder API (request
    stages and events, serve spans) and flush it to ``outdir``."""
    pkg.disable()
    rec = pkg.enable(outdir)
    try:
        rng = np.random.RandomState(seed)
        t = rec.now()
        for i in range(24):
            rid = 'q%d' % i
            t1 = t + 0.001
            pkg.request_stage(rid, 'queue_wait', t, t1, replica='a',
                              version=3)
            t2 = t1 + float(rng.uniform(0.01, 0.2))
            pkg.request_stage(rid, 'prefill', t1, t2, replica='a',
                              version=3)
            cur = t2
            for _ in range(4):
                gap = float(rng.uniform(0.005, 0.1))
                pkg.request_stage(rid, 'decode', cur, cur + gap,
                                  replica='a', version=3)
                cur += gap
            if i % 7 == 3:
                pkg.request_event(rid, 'shed', reason='deadline')
            else:
                pkg.request_event(rid, 'complete', tokens=5)
            rec._append({'type': 'span', 'kind': 'serve',
                         'name': 'serve_decode', 't0': t, 't1': t + 0.01,
                         'active_slots': i % 5, 'n_slots': 4})
            t = cur
        rec.flush()
    finally:
        pkg.disable()
    return outdir


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_evaluate_capture_reads_either_recorder(tmp_path, writer):
    pkg = jtelemetry if writer == 'jax' else telemetry
    d = _record_session(pkg, str(tmp_path / writer), seed=5)
    got = evaluate_capture(d, slos=default_slos(**_TEST_SLOS))
    want = jslo.evaluate_capture(d, slos=jslo.default_slos(**_TEST_SLOS))
    assert got == want
    assert got['n_request_records'] > 0
    assert got['slos']['slot_occupancy']['slow']['count'] == 24


def test_evaluate_capture_deterministic(tmp_path):
    d = _record_session(telemetry, str(tmp_path / 'p'), seed=9)
    a = evaluate_capture(d, slos=default_slos(**_TEST_SLOS))
    b = evaluate_capture(d, slos=default_slos(**_TEST_SLOS))
    assert a == b


def test_render_and_export_equal_jax(tmp_path):
    d = _record_session(telemetry, str(tmp_path / 'r'), seed=2)
    got = evaluate_capture(d, slos=default_slos(**_TEST_SLOS))
    want = jslo.evaluate_capture(d, slos=jslo.default_slos(**_TEST_SLOS))
    assert slo.render_slo_text(got) == jslo.render_slo_text(want)
    slo.export(d, got)
    with open(os.path.join(d, 'slo_report.json')) as f:
        assert json.load(f)['verdict'] == want['verdict']


# ---------------------------------------------------------------------
# windowed histograms and counters

class TestWindowedHistogram:
    def test_empty_window(self):
        h = WindowedHistogram(bucket_s=1.0)
        assert h.window_samples(10.0, 100.0) == []
        assert h.summary(10.0, 100.0) == {'count': 0}

    def test_single_sample_p50_equals_p99(self):
        h = WindowedHistogram(bucket_s=1.0)
        h.observe(0.042, 100.0)
        s = h.summary(10.0, 100.5)
        assert s['count'] == 1 and s['p50'] == s['p99'] == 0.042

    def test_window_excludes_older_samples(self):
        h = WindowedHistogram(bucket_s=1.0)
        h.observe(1.0, 100.0)
        h.observe(2.0, 150.0)
        assert h.window_samples(10.0, 155.0) == [2.0]
        assert h.window_samples(100.0, 155.0) == [1.0, 2.0]

    def test_rollover_drops_oldest_bucket(self):
        h = WindowedHistogram(bucket_s=1.0, max_buckets=4)
        for i in range(8):
            h.observe(float(i), 100.0 + i)
        assert len(h._buckets) == 4
        assert h.window_samples(1e9, 107.5) == [4.0, 5.0, 6.0, 7.0]

    def test_merge_across_ranks_bucketwise(self):
        a, b = WindowedHistogram(1.0), WindowedHistogram(1.0)
        a.observe(1.0, 100.2)
        a.observe(3.0, 101.2)
        b.observe(2.0, 100.7)
        b.observe(9.0, 50.0)
        a.merge(b)
        assert a.window_samples(5.0, 102.0) == [1.0, 2.0, 3.0]
        assert a.summary(5.0, 102.0)['p50'] == 2.0
        assert a.total_count() == 4

    def test_merge_mismatched_resolution_refused(self):
        with pytest.raises(ValueError, match='bucket_s'):
            WindowedHistogram(1.0).merge(WindowedHistogram(0.5))

    def test_bad_bucket_refused(self):
        with pytest.raises(ValueError, match='bucket_s'):
            WindowedHistogram(0.0)

    @pytest.mark.parametrize('seed', [0, 1, 2])
    def test_summaries_equal_jax(self, seed):
        rng = np.random.RandomState(seed)
        hp = WindowedHistogram(0.5, max_buckets=50)
        hj = jslo.WindowedHistogram(0.5, max_buckets=50)
        for v, t in zip(rng.exponential(0.05, 300),
                        np.sort(rng.uniform(0, 40, 300))):
            hp.observe(float(v), float(t))
            hj.observe(float(v), float(t))
        for window, now in ((1.0, 40.0), (10.0, 35.0), (100.0, 41.0)):
            assert hp.summary(window, now) == hj.summary(window, now)

    def test_counter_windowed_totals_and_merge(self):
        c = WindowedCounter(bucket_s=1.0)
        c.inc(100.0, 2.0)
        c.inc(101.0)
        c.inc(200.0, 5.0)
        assert c.total(10.0, 101.5) == 3.0
        assert c.total(1e9, 201.0) == 8.0
        d = WindowedCounter(bucket_s=1.0)
        d.inc(100.5, 4.0)
        c.merge(d)
        assert c.total(10.0, 101.5) == 7.0


# ---------------------------------------------------------------------
# SLO judging

class TestSLOJudging:
    def test_latency_burn_tiers(self):
        s = SLO('ttft', 'ttft_seconds', 'latency', 0.1, min_events=4)
        assert s.judge_burn(0.0, 0.0, 100)['verdict'] == 'ok'
        assert s.judge_burn(0.05, 0.05, 100)['verdict'] == 'warn'
        assert s.judge_burn(0.5, 0.25, 100)['verdict'] == 'breach'

    def test_breach_requires_both_windows(self):
        s = SLO('x', 'ttft_seconds', 'latency', 0.1, min_events=4)
        assert s.judge_burn(0.0, 0.5, 100)['verdict'] == 'ok'
        assert s.judge_burn(0.5, 0.001, 100)['verdict'] == 'ok'

    def test_insufficient_data_is_ok_not_fabricated(self):
        out = SLO('x', 'ttft_seconds', 'latency', 0.1,
                  min_events=10).judge_burn(1.0, 1.0, 3)
        assert out['verdict'] == 'ok' and out['data'] is False

    def test_rate_min_and_level_max(self):
        r = SLO('toks', 'tokens_per_s', 'rate_min', 100.0)
        assert r.judge_level(150.0, 120.0)['verdict'] == 'ok'
        assert r.judge_level(80.0, 90.0)['verdict'] == 'warn'
        assert r.judge_level(40.0, 30.0)['verdict'] == 'breach'
        m = SLO('occ', 'slot_occupancy', 'level_max', 0.9)
        assert m.judge_level(1.0, 1.0)['verdict'] == 'warn'
        mb = SLO('occ', 'slot_occupancy', 'level_max', 0.9,
                 breach_level=0.99)
        assert mb.judge_level(1.0, 1.0)['verdict'] == 'breach'

    @pytest.mark.parametrize('kind', ['latency', 'fraction'])
    def test_burn_judgements_equal_jax(self, kind):
        rng = np.random.RandomState(4)
        sp = SLO('x', 'm', kind, 0.05, min_events=5)
        sj = jslo.SLO('x', 'm', kind, 0.05, min_events=5)
        for f, s, n in zip(rng.uniform(0, 1, 50) ** 3,
                           rng.uniform(0, 1, 50) ** 3,
                           rng.randint(0, 20, 50)):
            assert sp.judge_burn(f, s, n) == sj.judge_burn(f, s, n)

    def test_bad_window_config_refused(self):
        with pytest.raises(ValueError, match='fast window'):
            SLO('x', 'ttft_seconds', 'latency', 0.1, fast_window_s=100.0,
                slow_window_s=10.0)
        with pytest.raises(ValueError, match='kind'):
            SLO('x', 'ttft_seconds', 'nope', 0.1)


# ---------------------------------------------------------------------
# the live monitor

class TestSLOMonitorLive:
    def test_listener_attach_sees_request_stages(self):
        rec = telemetry.enable()
        try:
            mon = SLOMonitor(slos=default_slos(**_TEST_SLOS)).attach(rec)
            t = rec.now()
            telemetry.request_stage('rX', 'queue_wait', t, t + 0.001)
            telemetry.request_stage('rX', 'prefill', t + 0.001, t + 0.01)
            telemetry.request_stage('rX', 'decode', t + 0.01, t + 0.02)
            telemetry.request_event('rX', 'complete', tokens=2)
            mon.detach()
            telemetry.request_stage('rY', 'decode', t, t + 1.0)
            assert mon.n_ingested == 4
            assert mon.evaluate()['slos']['ttft_p99']['slow']['count'] == 1
        finally:
            telemetry.disable()

    def test_broken_listener_never_breaks_recording(self):
        rec = telemetry.enable()
        try:
            calls = []

            def bad(record):
                calls.append(record)
                raise RuntimeError('boom')

            rec.add_listener(bad)
            rec.add_listener(bad)          # registered once
            telemetry.event('fine', kind='event')
            assert len(calls) == 1 and rec.events[-1]['name'] == 'fine'
            rec.remove_listener(bad)
            rec.remove_listener(bad)       # idempotent
            telemetry.event('after', kind='event')
            assert len(calls) == 1
        finally:
            telemetry.disable()

    def test_listener_may_record(self):
        """Listeners run outside the recorder's lock: one that records
        (and so re-enters the recorder) does not deadlock."""
        rec = telemetry.enable()
        try:
            seen = []

            def echo(record):
                seen.append(record['name'])
                if record['name'] == 'ping':
                    telemetry.event('pong', kind='event')

            rec.add_listener(echo)
            telemetry.event('ping', kind='event')
            assert seen == ['ping', 'pong']
            assert [r['name'] for r in rec.events[-2:]] == ['ping', 'pong']
        finally:
            telemetry.disable()

    def test_periodic_snapshot_by_record_time(self, tmp_path):
        mon = SLOMonitor(slos=default_slos(**_TEST_SLOS),
                         outdir=str(tmp_path), snapshot_every_s=5.0)
        stream = _random_stream(1, n_requests=20)
        mon.ingest(stream[0])
        path = tmp_path / 'slo_snapshot.json'
        assert path.exists()
        first = json.load(open(path))
        for rec in stream[1:]:
            mon.ingest(rec)
        second = json.load(open(path))
        assert second['n_ingested'] > first['n_ingested']

    def test_rate_denominator_clamps_to_observed_span(self):
        mon = SLOMonitor(slos=[SLO('toks', 'tokens_per_s', 'rate_min', 3.0,
                                   fast_window_s=10.0,
                                   slow_window_s=30.0)])
        t = 1000.0
        mon.ingest({'kind': 'request', 'name': 'prefill',
                    'request_id': 'r1', 't0': t, 't1': t + 0.01})
        for i in range(7):
            mon.ingest({'kind': 'request', 'name': 'decode',
                        'request_id': 'r1', 't0': t + 0.01 + 0.25 * i,
                        't1': t + 0.26 + 0.25 * i})
        value = mon.evaluate()['slos']['toks']['fast']['value']
        assert value == pytest.approx(8 / 1.76, rel=0.3)

    def test_version_filter_isolates_post_swap_window(self):
        mon = SLOMonitor(record_filter=lambda r: r.get('version') == 5)
        for t, v in ((1.0, 4), (2.0, 5), (3.0, 5)):
            mon.ingest({'type': 'span', 'kind': 'request', 'name': 'decode',
                        'request_id': 'r1', 't0': t - 0.01, 't1': t,
                        'version': v})
        assert mon.n_ingested == 2
        assert mon.intertoken.total_count() == 2

    def test_batch_execute_feeds_latency_slo(self):
        mon = SLOMonitor(slos=default_slos(latency_s=0.05))
        for i in range(12):
            t = 10.0 + i
            mon.ingest({'kind': 'request', 'name': 'queue_wait',
                        'request_id': 'r%d' % i, 't0': t, 't1': t + 0.001})
            mon.ingest({'kind': 'request', 'name': 'execute',
                        'request_id': 'r%d' % i, 't0': t + 0.001,
                        't1': t + 0.2})
            mon.ingest({'kind': 'request', 'name': 'complete',
                        'request_id': 'r%d' % i, 't': t + 0.2})
        res = mon.evaluate()
        assert res['slos']['latency_p99']['verdict'] == 'breach'
        assert res['slos']['latency_p99']['fast']['count'] == 12


def test_engine_records_feed_filtered_monitors():
    """A labelled generation engine's own records (request stages and
    ``serve_decode`` ticks stamped with replica and version) feed a
    monitor filtered on that identity; another label sees nothing."""
    from chainermn_tpu_torch.models import TransformerLM
    model = TransformerLM(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                          d_ff=32, max_len=32, dtype=torch.float32,
                          device='cpu')
    eng = serving.GenerationEngine(model, n_slots=2, max_prompt_len=8,
                                   device='cpu', label='rep-1', version=7)
    rec = telemetry.enable()
    try:
        mine = SLOMonitor(record_filter=lambda r: (
            r.get('replica') == 'rep-1' and r.get('version') == 7))
        other = SLOMonitor(record_filter=lambda r: (
            r.get('replica') == 'rep-2'))
        mine.attach(rec)
        other.attach(rec)
        q = serving.GenerationQueue(8, label='rep-1')
        reqs = [q.submit([1, 2, 3], 4), q.submit([4], 3)]
        for _ in range(20):
            if all(r.done() for r in reqs):
                break
            eng.step(q)
        mine.detach()
        other.detach()
        res = mine.evaluate()
        assert res['slos']['ttft_p99']['slow']['count'] == 2
        assert res['slos']['intertoken_p99']['slow']['count'] == 5
        assert res['slos']['slot_occupancy']['slow']['count'] > 0
        assert other.n_ingested == 0
    finally:
        telemetry.disable()


def test_open_loop_generate_reports_live_verdict(tmp_path):
    from chainermn_tpu_torch.models import TransformerLM
    model = TransformerLM(vocab_size=32, d_model=16, n_heads=2, n_layers=1,
                          d_ff=32, max_len=32, dtype=torch.float32,
                          device='cpu')
    eng = serving.GenerationEngine(model, n_slots=2, max_prompt_len=8,
                                   device='cpu')
    q = serving.GenerationQueue(8)
    mon = SLOMonitor(slos=default_slos(ttft_s=5.0, intertoken_s=5.0),
                     outdir=str(tmp_path))
    rep = serving.open_loop_generate(eng, q, rate=200.0, n_requests=6,
                                     max_new_tokens=3, slo_monitor=mon,
                                     result_timeout=30.0)
    assert rep['served'] == 6
    assert rep['slo']['verdict']['overall'] == 'ok'
    assert rep['slo']['slos']['ttft_p99']['slow']['count'] == 6
    assert mon._attached is None            # detached after the window
    assert (tmp_path / 'slo_snapshot.json').exists()
