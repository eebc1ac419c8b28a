"""The port's ``InferenceEngine`` against the JAX package's.

Eager on the CPU (every bucket's ``aot`` False, as the JAX engine reports
on a runtime without AOT): the logits of a generic ``apply_fn`` over an
MLP and of ``for_model`` over the MLP and a small ResNet with the fused
norm match the JAX engine at rtol 1e-5 in f32; the bucket geometry, the
no-recompile guard, the bf16 policy, checkpoint loading, the hot swap
(validated, in place, no new capture) and the per-request trace stages.
The graphs themselves are held on the card by
``tests/test_torch_serving_graphs.py``.
"""

import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_parity
from chainermn_tpu import models as jmodels
from chainermn_tpu import serializers as jserializers
from chainermn_tpu import serving as jserving
from chainermn_tpu_torch import models, precision, serializers, serving
from chainermn_tpu_torch import telemetry
from chainermn_tpu_torch.serving import InferenceEngine, RequestQueue
from chainermn_tpu_torch.serving.engine import module_state
from chainermn_tpu_torch.telemetry.report import request_traces
from chainermn_tpu_torch.utils.failure import (CheckpointCorruptError,
                                               WeightSwapError)

torch.set_num_threads(2)

EXAMPLE = np.zeros((48,), np.float32)


@functools.lru_cache(maxsize=None)
def _mlp():
    jm = jmodels.MLP(n_units=16, n_out=10)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 48)))['params'])
    return jm, params


def _port_mlp():
    tm = models.MLP(n_units=16, n_in=48, device='cpu')
    models.load_flax_variables(tm, {'params': _mlp()[1]})
    return tm


def _apply(p, x):
    """The MLP's forward over the flax-layout tree, in PyTorch."""
    for i in range(3):
        d = p['Dense_%d' % i]
        x = x @ torch.as_tensor(d['kernel']) + torch.as_tensor(d['bias'])
        x = torch.relu(x) if i < 2 else x
    return x


def _engine(max_batch=8, **kw):
    return InferenceEngine.for_model(_port_mlp(), None, EXAMPLE,
                                     max_batch=max_batch, device='cpu', **kw)


def _x(n, shape=(48,), seed=0):
    return np.random.RandomState(seed).rand(n, *shape).astype(np.float32)


def _tol(want, rtol=1e-5):
    return dict(rtol=rtol, atol=rtol * float(np.abs(want).max()))


class TestInferenceEngine:
    @pytest.mark.parametrize('front', ['generic', 'for_model'])
    def test_logits_match_the_jax_engine_in_f32(self, front):
        jm, params = _mlp()
        jeng = jserving.InferenceEngine(
            lambda p, x: jm.apply({'params': p}, x), params, EXAMPLE,
            max_batch=8)
        eng = (InferenceEngine(_apply, params, EXAMPLE, max_batch=8,
                               device='cpu') if front == 'generic'
               else _engine())
        eng.warmup()
        for bucket in eng.edges:
            x = _x(bucket, seed=bucket)
            want = np.asarray(jeng.infer(x))
            np.testing.assert_allclose(eng.infer(x).numpy(), want,
                                       **_tol(want))

    def test_resnet_for_model_matches_the_jax_engine_in_f32(self):
        jm = jmodels.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                            dtype=jnp.float32, fused_norm=True)
        v = jax.device_get(jax.jit(lambda: jm.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
            train=False))())
        v = zoo_parity._perturb(v, np.random.RandomState(1))
        tm = models.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                           dtype=torch.float32, fused_norm=True,
                           device='cpu')
        models.load_flax_variables(tm, v)
        example = np.zeros((32, 32, 3), np.float32)
        jeng = jserving.InferenceEngine.for_model(
            jm, v, example, apply_kwargs={'train': False}, max_batch=2)
        eng = InferenceEngine.for_model(tm, None, example, max_batch=2,
                                        device='cpu')
        assert eng.warmup() == {2: False, 1: False}
        x = _x(2, (32, 32, 3), seed=5)
        want = np.asarray(jeng.infer(x))
        np.testing.assert_allclose(eng.infer(x).numpy(), want,
                                   **_tol(want))
        # the module itself is untouched: still in train mode
        assert tm.training and tm.conv_init.weight.device.type == 'cpu'

    def test_warmup_prepares_every_bucket_eagerly_on_the_cpu(self):
        eng = _engine()
        aot = eng.warmup()
        assert sorted(aot) == [1, 2, 4, 8] and not any(aot.values())
        st = eng.stats()
        assert st['compile_count'] == 0 and st['trace_count'] == 0
        assert st['buckets'] == [1, 2, 4, 8] and st['aot_requested']
        for bucket in eng.edges:
            for _ in range(3):
                assert eng.infer(np.ones((bucket, 48), np.float32)).shape \
                    == (bucket, 10)
        assert eng.executions == 3 * len(eng.edges)
        assert eng.stats()['replays'] == dict.fromkeys(eng.edges, 3)
        assert eng.stats()['compile_count'] == 0

    def test_a_bucket_is_prepared_on_first_use_without_warmup(self):
        eng = _engine(max_batch=4)
        eng.infer(np.ones((2, 48), np.float32))
        assert eng.stats()['buckets'] == [2]

    def test_signature_guard_refuses_off_bucket_shape(self):
        eng = _engine()
        eng.warmup()
        with pytest.raises(RuntimeError, match='not a bucket edge'):
            eng.infer(np.ones((3, 48), np.float32))
        with pytest.raises(RuntimeError, match='no-recompile guard'):
            eng.guard_signature(torch.ones((3, 48)))
        with pytest.raises(RuntimeError, match='no-recompile guard'):
            eng.guard_signature(torch.ones((4, 48), dtype=torch.float64))
        assert eng.allowed_signatures() == {((b, 48), 'float32')
                                            for b in (1, 2, 4, 8)}

    def test_policy_bf16_casts_params_and_outputs_f32(self):
        eng = _engine(max_batch=4, policy=precision.Policy.bf16())
        eng.warmup()
        assert eng.params['Dense_0']['weight'].dtype == torch.bfloat16
        assert eng._in_dtype == torch.bfloat16
        y = eng.infer(np.ones((4, 48), np.float32))
        assert y.dtype == torch.float32
        want = _engine(max_batch=4).infer(np.ones((4, 48), np.float32))
        np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=5e-2,
                                   atol=5e-2)

    def test_unported_and_accepted_arguments(self, tmp_path):
        """Sharded serving, which raised before it was ported, now serves
        (``test_torch_tp_serving.py`` holds it to the plain engine):
        specs without a plan are a ``ValueError`` and a plan of one
        process keeps every bucket; ``cache_dir`` is accepted and
        persists nothing."""
        from chainermn_tpu_torch.parallel import MeshPlan
        with pytest.raises(ValueError, match='requires a plan'):
            InferenceEngine(_apply, _mlp()[1], EXAMPLE, param_specs={},
                            device='cpu')
        plan = MeshPlan.create(tp=1, size=1)
        assert InferenceEngine(_apply, _mlp()[1], EXAMPLE, plan=plan,
                               max_batch=4, device='cpu').edges == (1, 2, 4)
        eng = _engine(cache_dir=str(tmp_path / 'cc'), aot=False)
        st = eng.stats()
        assert st['cache_dir'] == str(tmp_path / 'cc')
        assert not st['cache_persistent'] and not st['aot_requested']

    def test_the_engine_never_aliases_the_callers_storage(self):
        tm = _port_mlp()
        eng = InferenceEngine.for_model(tm, None, EXAMPLE, max_batch=2,
                                        device='cpu')
        before = tm.Dense_0.weight.detach().clone()
        eng.swap_params(module_state(_port_mlp()), version=1)
        eng.params['Dense_0']['weight'].zero_()
        assert torch.equal(tm.Dense_0.weight.detach(), before)

    def test_serve_packed_splits_rows_back_to_requests(self):
        eng = _engine(max_batch=8)
        eng.warmup()
        q = RequestQueue(max_batch=8, max_wait=0.0)
        xs = [_x(n, seed=n) for n in (3, 1, 2)]
        reqs = [q.submit(x) for x in xs]
        for pb in q.take(timeout=1.0):
            eng.serve_packed(pb)
        ref = _engine(max_batch=8)
        for req, x in zip(reqs, xs):
            got = req.result(timeout=1)
            assert got.shape == (len(x), 10)
            pad = np.zeros((8, 48), np.float32)
            pad[:len(x)] = x
            np.testing.assert_allclose(got, ref.infer(pad).numpy()[:len(x)],
                                       rtol=1e-6, atol=1e-6)

    def test_batch_path_stages_tile_e2e(self):
        rec = telemetry.enable()
        try:
            eng = _engine(max_batch=4, label='rep-7', version=4)
            eng.warmup()
            q = RequestQueue(max_batch=4, max_wait=0.001, label='rep-7')
            r1 = q.submit(np.zeros((2, 48), np.float32))
            r2 = q.submit(np.zeros((1, 48), np.float32))
            for pb in q.take(timeout=1.0):
                eng.serve_packed(pb)
            assert r1.done() and r2.done()
            traces = request_traces(list(rec.events))
            snap = rec.registry.snapshot()
        finally:
            telemetry.disable()
        assert len(traces) == 2
        for tr in traces.values():
            assert {'queue_wait', 'bucket_pack',
                    'execute'} <= set(tr['stage_ms'])
            assert tr['outcome'] == 'complete'
            assert abs(sum(tr['stage_ms'].values()) - tr['e2e_ms']) <= 1.0
        recs = [r for r in rec.events if r.get('replica') == 'rep-7']
        assert recs and {r.get('version') for r in recs} == {4}
        assert snap['serve_latency_seconds']['count'] == 2
        assert snap['serve_pad_waste']['samples'] == [0.25]
        spans = [r['name'] for r in rec.events if r['type'] == 'span'
                 and r['kind'] != 'request']
        assert spans[-2:] == ['serve_h2d', 'serve_execute']


class TestCheckpoints:
    def test_from_checkpoint(self, tmp_path):
        tm = _port_mlp()
        state = module_state(tm)
        path = serializers.save_npz(str(tmp_path / 'snap'),
                                    {'params': state, 'iteration': 7})
        eng = InferenceEngine.from_checkpoint(path, models.MLP(
            n_units=16, n_in=48, device='cpu'), None, EXAMPLE, max_batch=4,
            device='cpu')
        x = _x(4, seed=5)
        with torch.no_grad():
            want = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(eng.infer(x).numpy(), want, rtol=1e-6,
                                   atol=1e-6)

    def test_load_params_reads_a_jax_snapshot(self, tmp_path):
        """The container is shared: a JAX package snapshot's flax-layout
        params load into the port's generic engine."""
        _jm, params = _mlp()
        path = jserializers.save_npz(str(tmp_path / 'snap'),
                                     {'params': params})
        loaded = serving.load_params(path, params)
        eng = InferenceEngine(_apply, loaded, EXAMPLE, max_batch=2,
                              device='cpu')
        x = _x(2, seed=6)
        np.testing.assert_allclose(
            eng.infer(x).numpy(),
            InferenceEngine(_apply, params, EXAMPLE, max_batch=2,
                            device='cpu').infer(x).numpy(), rtol=0, atol=0)

    def test_corrupt_checkpoint_typed(self, tmp_path):
        state = module_state(_port_mlp())
        path = serializers.save_npz(str(tmp_path / 'snap'),
                                    {'params': state})
        with open(path, 'r+b') as f:
            f.truncate(len(open(path, 'rb').read()) // 2)
        with pytest.raises(CheckpointCorruptError):
            serving.load_params(path, state)


class TestWeightSwap:
    def test_swap_no_recapture_and_output_changes(self):
        eng = _engine(max_batch=4, label='rep-0', version=3)
        eng.warmup()
        x = _x(4)
        y1 = eng.infer(x).numpy()
        compiles, traces = eng.compile_count, eng.trace_count
        scaled = {k: {kk: vv * 1.5 for kk, vv in d.items()}
                  for k, d in module_state(_port_mlp()).items()}
        storage = eng.params['Dense_0']['weight'].data_ptr()
        assert eng.swap_params(scaled, version=7) == 7
        y2 = eng.infer(x).numpy()
        assert eng.compile_count == compiles and eng.trace_count == traces
        assert eng.param_version == 7
        assert eng.params['Dense_0']['weight'].data_ptr() == storage
        assert not np.allclose(y1, y2)
        assert eng.swap_params(module_state(_port_mlp())) == 8
        np.testing.assert_array_equal(eng.infer(x).numpy(), y1)

    def test_swap_nonfinite_refused_typed_incumbent_serves(self):
        eng = _engine(max_batch=2)
        eng.warmup()
        x = _x(2)
        y1 = eng.infer(x).numpy()
        poisoned = {k: {kk: torch.full_like(vv, float('nan'))
                        for kk, vv in d.items()}
                    for k, d in module_state(_port_mlp()).items()}
        with pytest.raises(WeightSwapError) as ei:
            eng.swap_params(poisoned, version=9)
        assert ei.value.version == 9
        assert eng.param_version == 0
        np.testing.assert_array_equal(eng.infer(x).numpy(), y1)
        wrong = module_state(models.MLP(n_units=8, n_in=48, device='cpu'))
        with pytest.raises(WeightSwapError):
            eng.swap_params(wrong, version=10)
        with pytest.raises(WeightSwapError, match='refused'):
            eng.swap_params(wrong, validate=False)
        np.testing.assert_array_equal(eng.infer(x).numpy(), y1)

    def test_swap_validation_waits_for_the_engine_lock(self):
        """The validation forward runs the shared module, so it waits
        while the serving thread holds the engine's lock."""
        eng = _engine(max_batch=2)
        eng.warmup()
        calls = []
        apply_fn = eng.apply_fn
        eng.apply_fn = lambda p, x: calls.append(x.shape) or apply_fn(p, x)
        scaled = {k: {kk: vv * 1.5 for kk, vv in d.items()}
                  for k, d in module_state(_port_mlp()).items()}
        done = []
        with eng._lock:
            t = threading.Thread(
                target=lambda: done.append(eng.swap_params(scaled)))
            t.start()
            t.join(0.3)
            assert t.is_alive() and calls == [] and eng.param_version == 0
        t.join(30)
        assert done == [1] and calls == [(2, 48)]

    def test_int8_swap_copies_q_and_scale_in_place(self):
        eng = _engine(max_batch=2, policy=precision.Int8Policy(min_elems=0))
        eng.warmup()
        x = _x(2)
        y1 = eng.infer(x).numpy()
        leaf = eng.params['Dense_1']['weight']
        scaled = {k: {kk: vv * 2.0 for kk, vv in d.items()}
                  for k, d in module_state(_port_mlp()).items()}
        eng.swap_params(scaled)
        assert eng.params['Dense_1']['weight'].q is leaf.q
        assert not np.allclose(eng.infer(x).numpy(), y1)

    def test_swap_from_checkpoint_roundtrip(self, tmp_path):
        eng = _engine(max_batch=2)
        eng.warmup()
        tm = _port_mlp()
        with torch.no_grad():
            for p in tm.parameters():
                p.mul_(2.0)
        path = serializers.save_npz(str(tmp_path / 'snapshot_iter_8'),
                                    {'params': module_state(tm)})
        assert eng.swap_from_checkpoint(path, version=8) == 8
        x = _x(2, seed=1)
        with torch.no_grad():
            want = tm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(eng.infer(x).numpy(), want, rtol=1e-5)
