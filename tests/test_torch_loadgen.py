"""The port's open-loop load generators against the JAX package's.

``open_loop`` with a seed offers the same size mix as the JAX one; under
overload the shed errors are the typed ``OverloadError`` and every
request is served or shed; the report's percentiles come from the
telemetry histograms.  ``open_loop_generate`` drives
``GenerationEngine.run`` on its thread: the same prompts as the JAX
generator, and in f32 the same greedy streams as the JAX engine, in slot
and paged mode; the generation telemetry (TTFT, inter-token, decode-step
histograms, request stages tiling the end-to-end latency, queue gauges,
mid-generation shed records).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import models as jmodels
from chainermn_tpu import serving as jserving
from chainermn_tpu_torch import models, serving, telemetry
from chainermn_tpu_torch.serving import InferenceEngine, OverloadError
from chainermn_tpu_torch.telemetry.report import request_traces

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=1, d_ff=64,
           max_len=64)


@functools.lru_cache(maxsize=None)
def _lm():
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    tm = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    models.load_flax_variables(tm, {'params': params})
    return jm, params, tm


def _mlp_engine(max_batch=16, n_units=16):
    tm = models.MLP(n_units=n_units, n_in=48, device='cpu')
    eng = InferenceEngine.for_model(tm, None, np.zeros((48,), np.float32),
                                    max_batch=max_batch, device='cpu')
    eng.warmup()
    return eng


class _Recording:
    """A queue wrapper that records what the generator submitted."""

    def __init__(self, queue):
        self.queue = queue
        self.submitted = []
        self.handles = []

    def submit(self, x, *args, **kw):
        self.submitted.append(np.array(x))
        req = self.queue.submit(x, *args, **kw)
        self.handles.append(req)
        return req

    def __getattr__(self, name):
        return getattr(self.queue, name)


class TestOpenLoop:
    def test_overload_sheds_typed_and_serves_the_rest(self):
        eng = _mlp_engine()
        q = _Recording(serving.RequestQueue(max_batch=16, max_wait=0.005,
                                            max_queue=16))
        rep = serving.open_loop(eng, q, rate=50000.0, n_requests=300,
                                seed=7)
        assert rep['served'] > 0 and rep['shed_submit'] > 0
        assert rep['shed_fraction'] > 0
        assert rep['served'] + rep['shed_submit'] + rep['shed_deadline'] \
            + rep['errored'] == 300 == rep['offered']
        assert rep['admitted'] == rep['served'] + rep['shed_deadline']
        assert rep['latency_p50_ms'] is not None
        assert rep['latency_p99_ms'] >= rep['latency_p50_ms']
        assert rep['queue_wait_p99_ms'] >= rep['queue_wait_p50_ms']
        assert 0.0 <= rep['pad_waste_fraction'] < 1.0
        assert rep['bucket_hit_rate'] == 1.0
        assert rep['compile_count'] == 0 and not any(rep['aot'].values())
        worst = rep['worst_request']
        assert worst['completed'] == rep['served']
        assert worst['shed'] == rep['shed_submit']
        assert abs(worst['worst']['stage_sum_ms']
                   - worst['worst']['e2e_ms']) <= 1.0
        # every shed of the window is the typed error
        assert all(h.done() for h in q.handles)
        assert telemetry.active() is None   # the window's own session

    def test_shed_errors_are_typed_overload_errors(self):
        eng = _mlp_engine(max_batch=4)
        clock = [0.0]
        q = serving.RequestQueue(max_batch=4, max_wait=0.0, max_queue=4,
                                 clock=lambda: clock[0])
        reqs = [q.submit(np.zeros((1, 48), np.float32), deadline=0.5)
                for _ in range(4)]
        with pytest.raises(OverloadError) as ei:
            q.submit(np.zeros((1, 48), np.float32))
        assert ei.value.reason == 'queue_full'
        clock[0] = 1.0
        assert q.take(timeout=0.01) == []
        for r in reqs:
            with pytest.raises(OverloadError, match='deadline'):
                r.result(timeout=0)
        del eng

    @pytest.mark.parametrize('seed', [0, 11])
    def test_the_size_mix_equals_the_jax_generators(self, seed):
        """The same seed offers the same request sizes and payloads from
        both generators (run below capacity: nothing sheds)."""
        eng = _mlp_engine(max_batch=8)
        jm = jmodels.MLP(n_units=16, n_out=10)
        params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                        jnp.zeros((1, 48)))['params'])
        jeng = jserving.InferenceEngine(
            lambda p, x: jm.apply({'params': p}, x), params,
            np.zeros((48,), np.float32), max_batch=8, aot=False)
        jeng.warmup()
        reports, offered = [], []
        for e, qcls in ((eng, serving.RequestQueue),
                        (jeng, jserving.RequestQueue)):
            q = _Recording(qcls(max_batch=8, max_wait=0.001, max_queue=64))
            reports.append((serving if e is eng else jserving).open_loop(
                e, q, rate=400.0, n_requests=30, seed=seed))
            offered.append(q.submitted)
        assert [x.shape for x in offered[0]] == [x.shape
                                                 for x in offered[1]]
        for a, b in zip(*offered):
            np.testing.assert_array_equal(a, b)
        assert reports[0]['served'] == reports[1]['served'] == 30
        assert reports[0]['offered'] == reports[1]['offered']
        assert reports[0]['executions'] > 0


def _run_generate(front, eng, qcls, **kw):
    q = _Recording(qcls(max_prompt_len=8, max_queue=64,
                        **({'page_size': eng.page_size}
                           if getattr(eng, 'paged', False) else {})))
    rep = front.open_loop_generate(eng, q, **kw)
    return rep, q


class TestOpenLoopGenerate:
    def test_report_fields_and_accounting(self):
        _, _, tm = _lm()
        eng = serving.GenerationEngine(tm, n_slots=2, max_prompt_len=4,
                                       device='cpu')
        eng.warmup()
        q = serving.GenerationQueue(max_prompt_len=4, max_queue=8)
        rep = serving.open_loop_generate(
            eng, q, rate=300.0, n_requests=10, seed=3,
            prompt_len_range=(1, 4), max_new_tokens=4)
        assert rep['served'] + rep['shed_submit'] + rep['shed_deadline'] \
            + rep['errored'] == 10
        assert rep['served'] > 0
        assert rep['tokens_served'] == 4 * rep['served']
        assert rep['tokens_generated'] == rep['tokens_served']
        assert rep['tokens_per_s'] > 0
        assert rep['ttft_p99_ms'] >= rep['ttft_p50_ms'] > 0
        assert rep['intertoken_p99_ms'] >= rep['intertoken_p50_ms'] > 0
        assert rep['decode_step_p99_ms'] >= rep['decode_step_p50_ms'] > 0
        assert rep['decode_trace_count'] == 0 and rep['n_slots'] == 2
        assert rep['prefills'] == rep['served']
        assert rep['speculative'] is None and rep['paged'] is None
        worst = rep['worst_request']['worst']
        assert {'queue_wait', 'bucket_pack', 'prefill',
                'decode'} <= set(worst['stage_ms'])
        assert abs(worst['stage_sum_ms'] - worst['e2e_ms']) <= 1.0
        assert rep['slo'] is None
        # a live SLO monitor listens to the window and its verdict is the
        # report's; a monitor that cannot attach leaves no session behind
        from chainermn_tpu_torch.telemetry.slo import SLOMonitor
        mon = SLOMonitor()
        rep = serving.open_loop_generate(
            eng, serving.GenerationQueue(max_prompt_len=4, max_queue=8),
            rate=300.0, n_requests=4, seed=4, prompt_len_range=(1, 4),
            max_new_tokens=2, slo_monitor=mon)
        assert rep['slo']['verdict']['overall'] == 'ok'
        assert rep['slo']['slos']['ttft_p99']['slow']['count'] \
            == rep['served'] == 4
        with pytest.raises(AttributeError):
            serving.open_loop_generate(eng, q, 1.0, 1, slo_monitor=object())
        assert telemetry.active() is None

    @pytest.mark.parametrize('paged', [False, True])
    def test_greedy_streams_equal_the_jax_engine(self, paged):
        """The same seeded prompts through both generators, every request
        served, and the same greedy tokens request by request."""
        jm, params, tm = _lm()
        kw = dict(n_slots=4, max_prompt_len=8, paged=paged)
        jeng = jserving.GenerationEngine(jm, params, **kw)
        eng = serving.GenerationEngine(tm, device='cpu', **kw)
        jeng.warmup()
        eng.warmup()
        load = dict(rate=200.0, n_requests=12, seed=5,
                    prompt_len_range=(1, 8), max_new_tokens=5)
        rep, q = _run_generate(serving, eng, serving.GenerationQueue,
                               **load)
        jrep, jq = _run_generate(jserving, jeng, jserving.GenerationQueue,
                                 **load)
        for a, b in zip(q.submitted, jq.submitted):
            np.testing.assert_array_equal(a, b)
        assert rep['served'] == jrep['served'] == 12
        assert [h.result(timeout=0).tolist() for h in q.handles] \
            == [h.result(timeout=0).tolist() for h in jq.handles]
        assert (rep['paged'] is None) == (not paged)
        if paged:
            assert rep['paged']['pages_in_use'] >= 0

    def test_int8_kv_arm_serves(self):
        _, _, tm = _lm()
        eng = serving.GenerationEngine(tm, n_slots=2, max_prompt_len=4,
                                       int8_kv=True, device='cpu')
        eng.warmup()
        rep = serving.open_loop_generate(
            eng, serving.GenerationQueue(max_prompt_len=4), rate=300.0,
            n_requests=6, seed=4, prompt_len_range=(1, 4), max_new_tokens=3)
        assert rep['served'] == 6 and rep['int8_kv'] is True


class TestGenerateTelemetry:
    def test_generate_stage_budgets_sum_to_e2e(self):
        _, _, tm = _lm()
        rec = telemetry.enable()
        try:
            eng = serving.GenerationEngine(tm, n_slots=2, max_prompt_len=4,
                                           device='cpu')
            eng.warmup()
            q = serving.GenerationQueue(max_prompt_len=4)
            a = q.submit([1, 2], 6)
            b = q.submit([3], 3)
            c = q.submit([4], 1)
            for _ in range(24):
                if a.done() and b.done() and c.done():
                    break
                eng.step(q)
            snap = rec.registry.snapshot()
        finally:
            telemetry.disable()
        traces = request_traces(list(rec.events))
        assert len(traces) == 3
        for tr in traces.values():
            assert tr['outcome'] == 'complete'
            assert {'queue_wait', 'bucket_pack',
                    'prefill'} <= set(tr['stage_ms'])
            assert abs(sum(tr['stage_ms'].values()) - tr['e2e_ms']) <= 1.0
        assert traces[a.request_id]['n_decode'] == 5
        assert traces[c.request_id]['n_decode'] == 0
        assert snap['serve_ttft_seconds']['count'] == 3
        # a decodes 5 tokens, b 2: 7 gaps
        assert snap['serve_intertoken_seconds']['count'] == 7
        assert snap['serve_tokens_total']['value'] == 10.0
        assert snap['serve_decode_seconds']['count'] == eng.decode_steps

    def test_queue_depth_sampled_each_tick(self):
        _, _, tm = _lm()
        rec = telemetry.enable()
        try:
            eng = serving.GenerationEngine(tm, n_slots=1, max_prompt_len=4,
                                           device='cpu')
            q = serving.GenerationQueue(max_prompt_len=4)
            q.submit([1], 3)
            q.submit([2], 3)
            eng.step(q)
            assert rec.registry.snapshot()['serve_queue_depth']['value'] \
                == 2.0
            eng.step(q)
            snap = rec.registry.snapshot()
        finally:
            telemetry.disable()
        assert snap['serve_queue_depth']['value'] == 1.0
        assert snap['serve_prefill_backlog']['value'] == 1.0
        assert snap['serve_decode_backlog']['value'] == 1.0
        assert snap['active_slots']['value'] == 1.0

    def test_mid_generation_shed_names_request(self):
        _, _, tm = _lm()
        rec = telemetry.enable()
        try:
            eng = serving.GenerationEngine(tm, n_slots=1, max_prompt_len=4,
                                           device='cpu')
            clock = [0.0]
            q = serving.GenerationQueue(max_prompt_len=4,
                                        clock=lambda: clock[0])
            doomed = q.submit([1], 100, deadline=5.0)
            eng.step(q, clock=lambda: clock[0])
            clock[0] = 10.0
            eng.step(q, clock=lambda: clock[0])
        finally:
            telemetry.disable()
        assert doomed.done()
        sheds = [e for e in rec.events
                 if e.get('kind') == 'request' and e.get('name') == 'shed']
        assert sheds[-1]['request_id'] == doomed.request_id
        assert sheds[-1]['reason'] == 'deadline'
        assert sheds[-1]['tokens'] >= 1
        assert any(e['name'] == 'serve_cancel' for e in rec.events)

    def test_admit_cap_limits_admissions_per_tick(self):
        _, _, tm = _lm()
        eng = serving.GenerationEngine(tm, n_slots=4, max_prompt_len=4,
                                       device='cpu')
        eng.admit_cap = 1
        q = serving.GenerationQueue(max_prompt_len=4)
        reqs = [q.submit([i + 1], 8) for i in range(3)]
        eng.step(q)
        assert len(eng._slots) == 1 and q.depth() == 2
        eng.admit_cap = None
        eng.step(q)
        assert len(eng._slots) == 3
        while not all(r.done() for r in reqs):
            eng.step(q)


class TestGenerationSwap:
    def test_swap_refused_while_slots_live_then_flat(self):
        from chainermn_tpu_torch.utils.failure import WeightSwapError
        _, params, tm = _lm()
        eng = serving.GenerationEngine(tm, n_slots=2, max_prompt_len=4,
                                       device='cpu')
        eng.warmup()
        q = serving.GenerationQueue(4)
        q.submit([1, 2], 8)
        eng.step(q)
        with pytest.raises(WeightSwapError):
            eng.swap_params(params, version=5)
        assert eng.param_version == 0
        while eng._slots:
            eng.step(q)
        nan = {k: v for k, v in params.items()}
        nan['lnf_scale'] = np.full_like(params['lnf_scale'], np.nan)
        with pytest.raises(WeightSwapError, match='non-finite'):
            eng.swap_params(nan, version=6)
        scaled = jax.tree_util.tree_map(lambda a: a * 1.01, params)
        assert eng.swap_params(scaled, version=5) == 5
        req = q.submit([3, 1], 4)
        while not req.done():
            eng.step(q)
        assert len(req.result(timeout=5)) == 4
        assert eng.stats()['param_version'] == 5

    def test_from_and_swap_from_checkpoint(self, tmp_path):
        from chainermn_tpu_torch import serializers
        _, params, tm = _lm()
        path = serializers.save_npz(str(tmp_path / 'snap'),
                                    {'params': params})
        eng = serving.GenerationEngine.from_checkpoint(
            path, tm, None, n_slots=2, max_prompt_len=4, device='cpu')
        ref = serving.GenerationEngine(tm, n_slots=2, max_prompt_len=4,
                                       device='cpu')
        outs = []
        for e in (eng, ref):
            q = serving.GenerationQueue(4)
            r = q.submit([5, 6], 4)
            while not r.done():
                e.step(q)
            outs.append(r.result().tolist())
        assert outs[0] == outs[1]
        assert eng.swap_from_checkpoint(path, version=2) == 2
