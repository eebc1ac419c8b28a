"""The port's merged telemetry report, its command line and the profiling
helpers.

``build_report`` / ``render_text`` / ``overlap_stats`` /
``render_request_text`` / ``validate_prometheus`` / ``export`` against
the JAX package's on the same capture directories (made from a seed with
numpy), then ``python -m chainermn_tpu_torch.telemetry`` (``report``,
``doctor``, ``goodput``, ``slo``) with the JAX package's exit codes, and
``utils.profiling`` (the step timer, the op benchmark, traces and memory
statistics on the CPU).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from chainermn_tpu.telemetry import report as jreport
from chainermn_tpu_torch import telemetry
from chainermn_tpu_torch.telemetry import recorder, report
from chainermn_tpu_torch.telemetry.__main__ import main as telemetry_main
from chainermn_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _capture(outdir, seed, ranks=2, steps=6, requests=8, serve=True):
    """A multi-rank session written by the port's recorder: step phases,
    compute and collective spans (tagged by mesh axis), chaos and
    pipeline events, request traces and serving metrics."""
    rng = np.random.RandomState(seed)
    for rank in range(ranks):
        rec = recorder.Recorder(outdir=outdir)
        rec._rank = lambda r=rank: r
        t = 1000.0 + 0.01 * rank
        for it in range(steps):
            for name in report.STEP_PHASES:
                dt = float(rng.uniform(0.001, 0.02))
                kind = 'compute' if name == 'jitted_step' else 'host'
                rec._append({'type': 'span', 'name': name, 'kind': kind,
                             't0': t, 't1': t + dt, 'iteration': it})
                if name == 'jitted_step':
                    for axes in (['data'], ['model'], None):
                        c0 = t + float(rng.uniform(-0.005, dt))
                        span = {'type': 'span', 'name': 'allreduce',
                                'kind': 'collective', 't0': c0,
                                't1': c0 + float(rng.uniform(0.001,
                                                             0.01))}
                        if axes:
                            span['axes'] = axes
                        rec._append(span)
                t += dt
            rec.registry.histogram('step_time_seconds').observe(
                float(rng.uniform(0.01, 0.05)))
        rec._append({'type': 'event', 'name': 'chaos:drop_send',
                     'kind': 'chaos', 't': t})
        rec._append({'type': 'event', 'name': 'pipeline:schedule',
                     'kind': 'pipeline', 't': t, 'schedule': '1f1b',
                     'n_micro': 4, 'n_stages': 2, 'total_ticks': 10,
                     'axes': ['pipe']})
        if serve and rank == 0:
            reg = rec.registry
            for i in range(requests):
                rid = 'r%d' % (i + 1)
                t1 = t + 0.001
                rec.child_span(rid, 'queue_wait', t, t1, seq=i)
                t2 = t1 + float(rng.uniform(0.005, 0.05))
                rec.child_span(rid, 'prefill', t1, t2, slot=i % 2)
                cur = t2
                for j in range(3):
                    gap = float(rng.uniform(0.002, 0.02))
                    rec.child_span(rid, 'decode', cur, cur + gap, step=j)
                    reg.histogram('serve_intertoken_seconds').observe(gap)
                    cur += gap
                reg.histogram('serve_ttft_seconds').observe(t2 - t)
                if i == 5:
                    rec.event('shed', kind='request', request_id=rid,
                              reason='deadline')
                else:
                    rec.event('complete', kind='request', request_id=rid,
                              tokens=4)
                reg.counter('serve_tokens_total').inc(4)
                t = cur
            reg.counter('serve_requests_total').inc(requests)
            reg.counter('serve_batches_total').inc(requests)
            reg.histogram('serve_latency_seconds').observe(0.02)
            reg.histogram('serve_decode_seconds').observe(0.005)
            reg.gauge('serve_queue_depth', help='depth "now"\\').set(3)
        rec.flush()
    return outdir


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_build_report_equals_jax(tmp_path, seed):
    d = _capture(str(tmp_path / 'cap'), seed)
    got = report.build_report(d)
    want = jreport.build_report(d)
    assert got == want
    assert got['overlap']['per_axis'].keys() == {'data', 'model',
                                                 'untagged'}
    assert got['requests']['count'] == 8
    assert got['pipeline'][0]['n_stages'] == 2


@pytest.mark.parametrize('seed', [0, 3])
def test_render_text_equals_jax(tmp_path, seed):
    d = _capture(str(tmp_path / 'cap'), seed)
    got = report.render_text(report.build_report(d), max_steps=5)
    want = jreport.render_text(jreport.build_report(d), max_steps=5)
    assert got == want
    assert 'overlap fraction' in got and 'request traces: 8' in got


def test_render_text_without_collectives_equals_jax(tmp_path):
    d = str(tmp_path / 'empty')
    os.makedirs(d)
    assert report.render_text(report.build_report(d)) \
        == jreport.render_text(jreport.build_report(d))


@pytest.mark.parametrize('seed', [4, 5, 6, 7])
def test_overlap_stats_equal_jax(seed):
    rng = np.random.RandomState(seed)
    spans = []
    for _ in range(60):
        t0 = float(rng.uniform(0, 10))
        kind = ['compute', 'collective', 'host'][rng.randint(3)]
        s = {'kind': kind, 't0': t0, 't1': t0 + float(rng.exponential(0.3)),
             'rank': int(rng.randint(3))}
        if kind == 'collective' and rng.rand() < 0.7:
            s['axes'] = [['data'], ['model'], ['inter', 'intra']][
                rng.randint(3)]
        spans.append(s)
    assert report.overlap_stats(spans) == jreport.overlap_stats(spans)
    assert report.span_axes_key({'axes': ['inter', 'intra']}) \
        == 'inter,intra'
    assert report.span_axes_key({}) == 'untagged'


def test_render_request_text_equals_jax(tmp_path):
    d = _capture(str(tmp_path / 'cap'), 8)
    _m, spans, events, _b = report.load_rank_logs(d)
    traces = report.request_traces(spans + events)
    jtraces = jreport.request_traces(spans + events)
    for rid in ('r1', 'r6'):
        assert report.render_request_text(traces[rid]) \
            == jreport.render_request_text(jtraces[rid])


_PROM_LINES = [
    'a_b 1', 'a_b{x="1"} 2.5', 'a{x="q\\"uote"} 1', 'a{x="bad"quote"} 1',
    'a{x="back\\\\slash"} NaN', 'a{x="raw\\slash"} 1', 'bad name 1',
    '# HELP a some help', '# TYPE a counter', '# TYPE 9bad counter',
    'a 1e-3', 'a +Inf', 'a{x="1",} 3', 'a{x="1",y="2"} -4',
]


@pytest.mark.parametrize('line', _PROM_LINES)
def test_validate_prometheus_equals_jax(line):
    assert report.validate_prometheus(line) \
        == jreport.validate_prometheus(line)


def test_export_writes_the_merged_artifacts(tmp_path):
    d = _capture(str(tmp_path / 'cap'), 9)
    rep = report.export(d)
    with open(os.path.join(d, 'merged_report.json')) as f:
        assert json.load(f)['n_spans'] == rep['n_spans']
    with open(os.path.join(d, 'metrics.prom')) as f:
        prom = f.read()
    assert report.validate_prometheus(prom) == []
    assert prom == recorder.snapshot_to_prometheus(rep['metrics'])


# ---------------------------------------------------------------------
# the command line

class TestReportCLI:
    def test_report_exit_0_and_export(self, tmp_path, capsys):
        d = _capture(str(tmp_path / 'cap'), 1)
        assert telemetry_main(['report', d]) == 0
        out = capsys.readouterr().out
        assert out.startswith('telemetry session: %s' % d)
        for name in ('merged_report.json', 'metrics.json', 'metrics.prom'):
            assert os.path.exists(os.path.join(d, name))

    def test_report_json_and_no_export(self, tmp_path, capsys):
        d = _capture(str(tmp_path / 'cap'), 2)
        assert telemetry_main(['report', d, '--json', '--no-export']) == 0
        parsed = json.loads(capsys.readouterr().out)
        assert parsed == json.loads(json.dumps(jreport.build_report(d)))
        assert not os.path.exists(os.path.join(d, 'merged_report.json'))

    def test_report_request(self, tmp_path, capsys):
        d = _capture(str(tmp_path / 'cap'), 3)
        assert telemetry_main(['report', d, '--request', 'r2']) == 0
        assert capsys.readouterr().out.startswith('request r2: e2e')
        assert telemetry_main(['report', d, '--request', 'r999']) == 1

    def test_empty_and_missing_capture_exit_2(self, tmp_path):
        empty = tmp_path / 'empty'
        empty.mkdir()
        assert telemetry_main(['report', str(empty)]) == 2
        missing = str(tmp_path / 'nope')
        for cmd in ('report', 'doctor', 'slo', 'goodput'):
            assert telemetry_main([cmd, missing]) == 2

    def test_no_subcommand_exit_2(self, capsys):
        assert telemetry_main([]) == 2
        assert 'a subcommand is required' in capsys.readouterr().err
        assert telemetry_main(['bogus']) == 2

    def test_doctor_exit_codes(self, tmp_path, capsys):
        d = _capture(str(tmp_path / 'cap'), 4)
        assert telemetry_main(['doctor', d]) == 0
        assert os.path.exists(os.path.join(d, 'doctor_report.json'))
        empty = tmp_path / 'empty'
        empty.mkdir()
        assert telemetry_main(['doctor', str(empty)]) == 2

    def test_goodput_exit_codes(self, tmp_path):
        d = _capture(str(tmp_path / 'cap'), 5, serve=False)
        assert telemetry_main(['goodput', d, '--no-export']) == 0
        assert telemetry_main(['goodput', d, '--floor', '1.01']) == 1
        empty = tmp_path / 'empty'
        empty.mkdir()
        assert telemetry_main(['goodput', str(empty)]) == 2


def _slo_capture(outdir, slow_tail=False):
    """The JAX SLO tests' synthetic capture: 40 requests over 20 s, 8
    decode ticks each; ``slow_tail`` makes the last 5 s decode 40x
    slower."""
    os.makedirs(outdir, exist_ok=True)
    lines = [{'type': 'meta', 'rank': 0, 'pid': 1, 'wall0': 0.0}]
    for i in range(40):
        t = 1000.0 + 0.5 * i
        gap = 0.2 if (slow_tail and t >= 1015.0) else 0.005
        rid = 'r%d' % (i + 1)
        lines.append({'type': 'span', 'kind': 'request',
                      'name': 'queue_wait', 'request_id': rid, 't0': t,
                      't1': t + 0.001})
        lines.append({'type': 'span', 'kind': 'request', 'name': 'prefill',
                      'request_id': rid, 't0': t + 0.001, 't1': t + 0.006})
        cur = t + 0.006
        for j in range(8):
            lines.append({'type': 'span', 'kind': 'request',
                          'name': 'decode', 'request_id': rid, 't0': cur,
                          't1': cur + gap, 'step': j})
            cur += gap
        lines.append({'type': 'event', 'kind': 'request',
                      'name': 'complete', 'request_id': rid, 't': cur})
        lines.append({'type': 'span', 'kind': 'serve',
                      'name': 'serve_decode', 't0': t, 't1': t + 0.01,
                      'active_slots': 4, 'n_slots': 8})
    with open(os.path.join(outdir, 'events-rank0.jsonl'), 'w') as f:
        for rec in lines:
            f.write(json.dumps(dict(rec, rank=0)) + '\n')
    return outdir


class TestSLOCLI:
    def test_exit_0_text_and_export(self, tmp_path, capsys):
        d = _slo_capture(str(tmp_path / 'ok'))
        assert telemetry_main(['slo', d, '--ttft-ms', '100',
                               '--intertoken-ms', '50', '--fast-window',
                               '10', '--slow-window', '30']) == 0
        assert 'verdict: OK' in capsys.readouterr().out
        with open(os.path.join(d, 'slo_report.json')) as f:
            assert json.load(f)['verdict']['overall'] == 'ok'
        assert telemetry_main(['slo', d, '--json']) == 0
        parsed = json.loads(capsys.readouterr().out)
        assert parsed['verdict']['overall'] in ('ok', 'warn', 'breach')

    def test_slow_tail_breaches(self, tmp_path, capsys):
        d = _slo_capture(str(tmp_path / 'bad'), slow_tail=True)
        assert telemetry_main(['slo', d, '--intertoken-ms', '50',
                               '--fast-window', '10',
                               '--slow-window', '30', '--json']) == 0
        res = json.loads(capsys.readouterr().out)
        assert res['verdict']['overall'] == 'breach'
        assert 'intertoken_p99' in res['verdict']['breaches']

    def test_empty_and_training_only_capture_exit_2(self, tmp_path):
        empty = tmp_path / 'empty'
        empty.mkdir()
        assert telemetry_main(['slo', str(empty)]) == 2
        d = _capture(str(tmp_path / 'train'), 0, ranks=1, serve=False)
        assert telemetry_main(['slo', d]) == 2

    def test_tokens_per_s_floor(self, tmp_path):
        d = _slo_capture(str(tmp_path / 'rate'))
        assert telemetry_main(['slo', d, '--tokens-per-s', '1000000',
                               '--fast-window', '10',
                               '--slow-window', '30']) == 0
        with open(os.path.join(d, 'slo_report.json')) as f:
            rep = json.load(f)
        assert rep['slos']['tokens_per_s']['verdict'] == 'breach'

    def test_python_dash_m(self, tmp_path):
        """The module runs as ``python -m chainermn_tpu_torch.telemetry``
        and imports no JAX."""
        d = _slo_capture(str(tmp_path / 'm'))
        env = dict(os.environ, PYTHONPATH=ROOT)
        code = ('import sys, runpy; sys.argv = ["x", "slo", %r]; '
                'rc = 0\n'
                'try:\n'
                '    runpy.run_module("chainermn_tpu_torch.telemetry", '
                'run_name="__main__")\n'
                'except SystemExit as e:\n'
                '    rc = e.code\n'
                'assert "jax" not in sys.modules\n'
                'sys.exit(rc)' % d)
        proc = subprocess.run([sys.executable, '-c', code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert 'verdict:' in proc.stdout


# ---------------------------------------------------------------------
# profiling

class TestProfiling:
    def test_step_timer_summary_and_span(self):
        rec = telemetry.enable()
        try:
            timer = profiling.StepTimer(items_per_step=8, warmup=1)
            for _ in range(5):
                timer.tick()
            s = timer.summary()
            assert s['steps'] == 3
            assert s['items_per_sec'] == pytest.approx(
                8 / s['mean_step_s'])
            steps = [r for r in rec.events if r.get('name') == 'step']
            assert len(steps) == 4
            assert rec.registry.snapshot()['step_time_seconds'][
                'summary']['count'] == 4
        finally:
            telemetry.disable()

    def test_step_timer_standalone_dump(self, tmp_path):
        timer = profiling.StepTimer(warmup=0)
        assert timer.summary() == {}
        timer.tick()
        timer.tick()
        path = str(tmp_path / 't.json')
        timer.dump(path)
        with open(path) as f:
            assert json.load(f)['steps'] == 1

    def test_step_timer_as_extension(self):
        class _T:
            observation = {}
        timer, trainer = profiling.StepTimer(), _T()
        timer(trainer)
        timer(trainer)
        assert trainer.observation['steps_per_sec'] > 0

    def test_benchmark_op_records_mean(self):
        rec = telemetry.enable()
        try:
            x = torch.ones(16)
            mean = profiling.benchmark_op(lambda a: a * 2, x, n_steps=4,
                                          warmup=1)
            assert mean > 0
            snap = rec.registry.snapshot()['benchmark_op_seconds']
            assert snap['summary']['count'] == 1
        finally:
            telemetry.disable()

    def test_trace_annotate_and_save(self, tmp_path):
        with profiling.trace(str(tmp_path / 'a')):
            with profiling.annotate('region'):
                torch.ones(8).sum()
        with open(tmp_path / 'a' / 'trace.json') as f:
            assert 'region' in f.read()
        out = profiling.save_device_profile(str(tmp_path / 'b'),
                                            lambda: torch.ones(3) * 2)
        assert out.tolist() == [2.0, 2.0, 2.0]
        assert (tmp_path / 'b' / 'trace.json').exists()

    def test_memory_stats_cpu_is_empty(self):
        assert profiling.memory_stats('cpu') == {}
