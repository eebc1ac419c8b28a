"""The port's int8 weight policy against the JAX package.

``quantize_int8`` (``q`` bit-equal, ``scale`` within 1e-7 relative, on
flax-layout trees and, transposed, on the port's own layouts),
``dequantize_int8``, ``dequant_matmul`` and its oracle, ``Int8Policy``,
the dequantize-on-read view, and the int8 engines: the
``InferenceEngine`` (a generic ``apply_fn`` over an MLP and
``for_model`` over a small ResNet with the fused norm) within 1e-5 of
the JAX int8 engine in f32 and within 5e-2 of the f32 oracle, and the
int8 ``GenerationEngine``'s greedy streams equal to the JAX one's.
Inference BatchNorm's plain version is checked bit-equal to
``_apply_ref``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoo_parity
from chainermn_tpu import models as jmodels
from chainermn_tpu import ops as jops
from chainermn_tpu import precision as jprecision
from chainermn_tpu import serving as jserving
from chainermn_tpu_torch import models, ops, precision, serving
from chainermn_tpu_torch.ops import int8_matmul
from chainermn_tpu_torch.precision import Int8Policy

torch.set_num_threads(2)


def _tree(seed):
    """A flax-layout weight tree: a Dense kernel, an HWIO conv kernel
    with an all-zero output channel, a 4-D transformer ``qkv`` kernel, a
    small kernel under the size floor, a bias and an integer leaf."""
    rng = np.random.RandomState(seed)
    conv = rng.randn(3, 3, 16, 8).astype(np.float32)
    conv[..., 5] = 0.0
    return {'Dense_0': {'kernel': rng.randn(64, 32).astype(np.float32),
                        'bias': rng.randn(32).astype(np.float32)},
            'Conv_0': {'kernel': conv},
            'qkv': {'kernel': rng.randn(32, 3, 4, 8).astype(np.float32)},
            'small': {'kernel': rng.randn(8, 8).astype(np.float32)},
            'step': np.arange(4, dtype=np.int32)}


def _close_scale(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-7,
                               atol=0)


@pytest.mark.parametrize('seed', range(3))
@pytest.mark.parametrize('min_elems', [0, precision.QUANT_MIN_ELEMS])
def test_quantize_int8_bit_equal_to_jax(seed, min_elems):
    tree = _tree(seed)
    got = precision.quantize_int8(tree, min_elems=min_elems)
    want = jprecision.quantize_int8(tree, min_elems=min_elems)
    for path in (('Dense_0', 'kernel'), ('Conv_0', 'kernel'),
                 ('qkv', 'kernel'), ('small', 'kernel'),
                 ('Dense_0', 'bias'), ('step',)):
        g, w = got, want
        for k in path:
            g, w = g[k], w[k]
        assert precision.is_quantized(g) == jprecision.is_quantized(w)
        if jprecision.is_quantized(w):
            assert g.q.dtype == torch.int8 and g.axis == -1
            np.testing.assert_array_equal(g.q.numpy(), np.asarray(w.q))
            _close_scale(g.scale, w.scale)
        else:
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    # the zero channel: scale 1, q 0
    assert float(got['Conv_0']['kernel'].scale[5]) == 1.0
    deq = precision.dequantize_int8(got)
    jdeq = jprecision.dequantize_int8(want)
    for k in ('Dense_0', 'Conv_0', 'qkv'):
        np.testing.assert_array_equal(deq[k]['kernel'].numpy(),
                                      np.asarray(jdeq[k]['kernel']))


def test_torch_layout_weights_scale_per_output_channel_on_axis_0():
    """A PyTorch ``weight`` (OIHW, ``(out, in)``) quantizes per output
    channel on axis 0: the transpose of the flax kernel's ``q`` and the
    same scales, so the two packages dequantize to the same values."""
    tree = _tree(4)
    flax_q = jprecision.quantize_int8(tree, min_elems=0)
    torch_tree = {
        'fc': {'weight': torch.from_numpy(tree['Dense_0']['kernel'].T)},
        'conv': {'weight': torch.from_numpy(
            tree['Conv_0']['kernel'].transpose(3, 2, 0, 1).copy())}}
    got = precision.quantize_int8(torch_tree, min_elems=0)
    fc, conv = got['fc']['weight'], got['conv']['weight']
    assert fc.axis == 0 and conv.axis == 0
    np.testing.assert_array_equal(
        fc.q.numpy().T, np.asarray(flax_q['Dense_0']['kernel'].q))
    np.testing.assert_array_equal(
        conv.q.numpy().transpose(2, 3, 1, 0),
        np.asarray(flax_q['Conv_0']['kernel'].q))
    _close_scale(fc.scale, flax_q['Dense_0']['kernel'].scale)
    deq = precision.dequantize_int8(got)
    np.testing.assert_array_equal(
        deq['conv']['weight'].numpy().transpose(2, 3, 1, 0),
        np.asarray(jprecision.dequantize_int8(flax_q)['Conv_0']['kernel']))


def test_quantize_eligibility_and_roundtrip():
    tree = {'w': np.random.RandomState(0).randn(64, 32).astype(np.float32),
            'b': np.zeros((32,), np.float32),
            'n': np.arange(4, dtype=np.int32)}
    qt = precision.quantize_int8(tree)
    assert precision.is_quantized(qt['w'])
    assert qt['w'].q.dtype == torch.int8 and qt['w'].scale.shape == (32,)
    assert not precision.is_quantized(qt['b'])
    assert not precision.is_quantized(qt['n'])
    w = np.random.RandomState(1).randn(128, 64).astype(np.float32)
    deq = precision.dequantize_int8(precision.quantize_int8({'w': w}))
    err = np.linalg.norm(deq['w'].numpy() - w) / np.linalg.norm(w)
    assert 0 < err < 0.02
    assert err == pytest.approx(jprecision.quantization_error(
        {'w': w}, jprecision.quantize_int8({'w': w})), rel=1e-5)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_dequantize_int8_equals_jax(dtype):
    tree = _tree(5)
    got = precision.dequantize_int8(precision.quantize_int8(tree),
                                    getattr(torch, dtype))
    want = jprecision.dequantize_int8(jprecision.quantize_int8(tree),
                                      getattr(jnp, dtype))
    for k in ('Dense_0', 'Conv_0', 'qkv', 'small'):
        np.testing.assert_array_equal(
            got[k]['kernel'].float().numpy(),
            np.asarray(want[k]['kernel'], np.float32))
    np.testing.assert_array_equal(np.asarray(got['step']), want['step'])


@pytest.mark.parametrize('seed', range(3))
def test_dequant_matmul_matches_reference_and_jax(seed):
    rng = np.random.RandomState(2 + seed)
    w = rng.randn(48, 16).astype(np.float32)
    x = rng.randn(8, 48).astype(np.float32)
    qt = precision.quantize_int8({'w': w}, min_elems=0)['w']
    got = ops.dequant_matmul(torch.from_numpy(x), qt.q, qt.scale)
    want = ops.dequant_matmul_reference(torch.from_numpy(x), qt.q, qt.scale)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    jqt = jprecision.quantize_int8({'w': w}, min_elems=0)['w']
    jgot = jops.dequant_matmul(jnp.asarray(x), jqt.q, jqt.scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x @ w, rtol=0.2, atol=0.1)
    bf = ops.dequant_matmul(torch.from_numpy(x), qt.q, qt.scale,
                            dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16


def test_int8_policy_registry():
    p = Int8Policy.bf16()
    assert p.compute_dtype == torch.bfloat16
    assert p.output_dtype == torch.float32 and p.param_dtype == torch.int8
    assert p.is_inference_only
    assert Int8Policy.from_string('int8').compute_dtype == torch.float32
    assert Int8Policy.from_string('INT8_BF16') == Int8Policy.bf16()
    with pytest.raises(ValueError, match='unknown int8 policy'):
        Int8Policy.from_string('int4')
    tree = _tree(0)
    q = p.quantize(tree)
    assert precision.is_quantized(q['Dense_0']['kernel'])
    assert p.dequantize(q)['Dense_0']['kernel'].dtype == torch.bfloat16


def test_dequantized_view_dequantizes_when_read(monkeypatch):
    calls = []
    real = int8_matmul.dequant

    def counting(*args, **kw):
        calls.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(int8_matmul, 'dequant', counting)
    q = precision.quantize_int8(_tree(1), min_elems=0)
    view = precision.dequantized_view(q, torch.float32)
    assert calls == [] and sorted(view) == sorted(q) and len(view) == 5
    block = view['Dense_0']
    assert calls == []
    kernel = block['kernel']
    assert calls == [(64, 32)] and kernel.dtype == torch.float32
    assert block['bias'] is q['Dense_0']['bias']   # not quantized
    np.testing.assert_array_equal(
        kernel.numpy(),
        precision.dequantize_int8(q)['Dense_0']['kernel'].numpy())


# ---------------------------------------------------------------------
# the int8 engines


@functools.lru_cache(maxsize=None)
def _mlp():
    jm = jmodels.MLP(n_units=64, n_out=10)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 48)))['params'])
    tm = models.MLP(n_units=64, n_in=48, device='cpu')
    models.load_flax_variables(tm, {'params': params})
    return jm, params, tm


def _batch(n, shape, seed=3):
    return np.random.RandomState(seed).rand(n, *shape).astype(np.float32)


def _tol(want, rtol):
    return dict(rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize('min_elems', [0, precision.QUANT_MIN_ELEMS])
def test_int8_mlp_engine_matches_jax_and_the_f32_oracle(min_elems):
    """A generic ``apply_fn`` over the flax-layout tree (the view hands
    it dequantized kernels) and ``for_model`` over the port's module:
    both within 1e-5 of the JAX int8 engine, within 5e-2 of f32."""
    jm, params, tm = _mlp()
    example = np.zeros((48,), np.float32)
    policy = dict(min_elems=min_elems)
    jeng = jserving.InferenceEngine(
        lambda p, x: jm.apply({'params': p}, x), params, example,
        max_batch=8, policy=jprecision.Int8Policy(**policy))
    oracle = jserving.InferenceEngine(
        lambda p, x: jm.apply({'params': p}, x), params, example,
        max_batch=8)

    def apply_fn(p, x):
        for i in range(3):
            d = p['Dense_%d' % i]
            x = x @ d['kernel'] + d['bias']
            x = torch.relu(x) if i < 2 else x
        return x

    generic = serving.InferenceEngine(apply_fn, params, example, max_batch=8,
                                      policy=Int8Policy(**policy),
                                      device='cpu')
    module = serving.InferenceEngine.for_model(
        tm, None, example, max_batch=8, policy=Int8Policy(**policy),
        device='cpu')
    x = _batch(8, (48,))
    want = np.asarray(jeng.infer(x))
    f32 = np.asarray(oracle.infer(x))
    for eng in (generic, module):
        eng.warmup()
        assert eng.quantized and eng.stats()['quantized']
        got = eng.infer(x).numpy()
        np.testing.assert_allclose(got, want, **_tol(want, 1e-5))
        np.testing.assert_allclose(got, f32, rtol=5e-2, atol=5e-2)
    q = module.params['Dense_0']['weight']
    assert precision.is_quantized(q) and q.axis == 0
    np.testing.assert_array_equal(
        q.q.numpy().T, np.asarray(jeng.params['Dense_0']['kernel'].q))


@functools.lru_cache(maxsize=None)
def _resnet():
    jm = jmodels.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                        dtype=jnp.float32, fused_norm=True)
    v = jax.device_get(jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
        train=False))())
    v = zoo_parity._perturb(v, np.random.RandomState(1))
    tm = models.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                       dtype=torch.float32, fused_norm=True, device='cpu')
    models.load_flax_variables(tm, v)
    return jm, v, tm


@pytest.mark.parametrize('min_elems', [0, precision.QUANT_MIN_ELEMS])
def test_int8_resnet_engine_matches_jax_and_the_f32_oracle(min_elems):
    """``for_model`` over a small ResNet with the fused norm: each
    quantized conv weight becomes a parametrization of its module in the
    engine's copy (dequantized when the conv reads it); the logits within
    1e-5 of the JAX int8 engine and within 5e-2 of the f32 model."""
    from torch.nn.utils import parametrize
    jm, v, tm = _resnet()
    example = np.zeros((32, 32, 3), np.float32)
    jeng = jserving.InferenceEngine.for_model(
        jm, v, example, apply_kwargs={'train': False}, max_batch=2,
        policy=jprecision.Int8Policy(min_elems=min_elems))
    eng = serving.InferenceEngine.for_model(
        tm, None, example, max_batch=2,
        policy=Int8Policy(min_elems=min_elems), device='cpu')
    eng.warmup()
    x = _batch(2, (32, 32, 3), seed=4)
    want = np.asarray(jeng.infer(x))
    got = eng.infer(x).numpy()
    np.testing.assert_allclose(got, want, **_tol(want, 1e-5))
    with torch.no_grad():
        f32 = tm.eval()(torch.from_numpy(x)).numpy()
    tm.train()
    np.testing.assert_allclose(got, f32, rtol=5e-2, atol=5e-2)
    copy = eng.apply_fn.module
    assert parametrize.is_parametrized(copy.conv_init, 'weight')
    assert not parametrize.is_parametrized(tm.conv_init, 'weight')
    assert tm.conv_init.weight.device.type == 'cpu'


@functools.lru_cache(maxsize=None)
def _lm():
    cfg = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
               max_len=64)
    jm = jmodels.TransformerLM(dtype=jnp.float32, **cfg)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    tm = models.TransformerLM(dtype=torch.float32, device='cpu', **cfg)
    models.load_flax_variables(tm, {'params': params})
    return jm, params, tm


@pytest.mark.parametrize('paged', [False, True])
def test_int8_generation_engine_streams_equal_jax(paged):
    """``GenerationEngine(policy=Int8Policy(min_elems=0))``: every
    kernel, the embeddings and the head quantized; the greedy streams of
    the same prompts equal the JAX int8 engine's in f32."""
    jm, params, tm = _lm()
    kw = dict(n_slots=4, max_prompt_len=8, paged=paged)
    jeng = jserving.GenerationEngine(
        jm, params, policy=jprecision.Int8Policy(min_elems=0), **kw)
    eng = serving.GenerationEngine(tm, policy=Int8Policy(min_elems=0),
                                   device='cpu', **kw)
    assert eng.quantized and eng.stats()['quantized']
    assert precision.is_quantized(eng.params['embed']['embedding'])
    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, 48, n) for n in (1, 3, 8, 5, 2, 7)]
    outs = []
    for e, qcls in ((jeng, jserving.GenerationQueue),
                    (eng, serving.GenerationQueue)):
        q = qcls(max_prompt_len=8)
        reqs = [q.submit(p, 6) for p in prompts]
        for _ in range(200):
            if all(r.done() for r in reqs):
                break
            e.step(q)
        outs.append([[int(t) for t in r.result(timeout=0)] for r in reqs])
    assert outs[0] == outs[1]


@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('relu', [False, True])
def test_inference_batch_norm_plain_version(residual, relu):
    """On CPU tensors the inference op is its plain version: bit-equal to
    ``_apply_ref`` with ``rstd = rsqrt(var + eps)``."""
    bn = __import__('chainermn_tpu_torch.ops.batch_norm_act',
                    fromlist=['_apply_ref'])
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((6, 5, 16), generator=gen).to(torch.bfloat16)
    res = (torch.randn((6, 5, 16), generator=gen).to(torch.bfloat16)
           if residual else None)
    scale, bias, mean = (torch.randn(16, generator=gen) for _ in range(3))
    var = torch.rand(16, generator=gen) + 0.5
    got = ops.batch_norm_act_inference(x, scale, bias, mean, var, eps=1e-5,
                                       residual=res, relu=relu)
    want = bn._apply_ref(x, mean, torch.rsqrt(var + 1e-5), scale, bias,
                         res, relu)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)
