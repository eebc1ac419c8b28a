"""The port's ``TransformerLM``, its ``lm_loss`` with every leaf's
gradient, and its slot-KV-cache serving functions (plain versions on the
CPU) against the JAX package's flax model, ``jax.value_and_grad`` of its
``lm_loss`` and its ``init_kv_cache`` / ``prefill`` / ``decode_step``,
from the same flax weights carried across by ``load_flax_variables``.

Tolerances are those of ``tests/test_transformer.py``: f32 rtol/atol
1e-5 (the same arithmetic, matmuls summed in another order), bf16 and
int8-KV 5e-2.  A gradient leaf is held as a whole, against its largest
entry: 1e-4 of it in f32, 5e-2 in bf16 (entries that cancel to ~0, like
the key bias's, have no meaningful relative error of their own).
"""

import copy
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import models as jmodels
from chainermn_tpu.models import resnet50 as jresnet
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import models

# the module (the package re-exports functions of the same names)
tfm = importlib.import_module('chainermn_tpu_torch.models.transformer')

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
JDT = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}
TDT = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
TOL = {'float32': dict(rtol=1e-5, atol=1e-5),
       'bfloat16': dict(rtol=5e-2, atol=5e-2)}


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


@functools.lru_cache(maxsize=None)
def _pair(dtype='float32'):
    """The flax model with its params, and the port's model carrying
    the same weights (made once per dtype: the tests never change
    them)."""
    jm = jmodels.TransformerLM(dtype=JDT[dtype], **CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    tm = models.TransformerLM(dtype=TDT[dtype], device='cpu', **CFG)
    models.load_flax_variables(tm, {'params': params})
    return jm, params, tm


# the JAX serving functions, compiled once per shape
_jprefill = jax.jit(jmodels.prefill, static_argnums=(0,))
_jdecode = jax.jit(jmodels.decode_step, static_argnums=(0,))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + '/')
        else:
            yield prefix + k, v


def _tokens(shape, seed):
    return np.random.RandomState(seed).randint(
        0, CFG['vocab_size'], shape).astype(np.int32)


def test_forward_matches_flax_f32(mode):
    jm, params, tm = _pair('float32')
    toks = _tokens((2, 11), 1)
    want = jm.apply({'params': params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
    assert got.dtype == torch.float32 and got.shape == (2, 11, 48)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_forward_matches_flax_bf16():
    jm, params, tm = _pair('bfloat16')
    toks = _tokens((2, 11), 2)
    want = jm.apply({'params': params}, jnp.asarray(toks))
    with torch.no_grad():
        got = tm(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), _f32(want), **TOL['bfloat16'])


# ---------------------------------------------------------------------
# the training loss and its gradients

GRAD_TOL = {'float32': 1e-4, 'bfloat16': 5e-2}


@pytest.mark.parametrize('pad_id', [-1, 0])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_lm_loss_and_gradients_match_jax(mode, dtype, pad_id):
    jm, params, tm = _pair(dtype)
    toks = _tokens((2, 11), 3)
    tgts = _tokens((2, 11), 4)
    tgts[0, :3] = pad_id            # -1: outside the vocabulary; 0: inside
    jloss = jmodels.lm_loss(lambda p, t: jm.apply({'params': p}, t),
                            pad_id=pad_id)
    (want, waux), wgrads = jax.value_and_grad(jloss, has_aux=True)(
        params, jnp.asarray(toks), jnp.asarray(tgts))
    tm.zero_grad(set_to_none=True)
    loss, aux = models.lm_loss(tm, pad_id=pad_id)(torch.from_numpy(toks),
                                                  torch.from_numpy(tgts))
    loss.backward()
    assert loss.dtype == torch.float32 and sorted(aux) == ['perp']
    tol = TOL[dtype]
    np.testing.assert_allclose(loss.item(), float(want), **tol)
    np.testing.assert_allclose(aux['perp'].item(), float(waux['perp']),
                               rtol=10 * tol['rtol'])
    wflat = dict(_flat(jax.device_get(wgrads)))
    got = {name.replace('.', '/'): p.grad
           for name, p in tm.named_parameters()}
    assert sorted(got) == sorted(wflat)
    for name, grad in got.items():
        w = np.asarray(wflat[name], np.float32)
        assert grad.dtype == torch.float32 and grad.shape == w.shape, name
        err = np.abs(grad.numpy() - w).max() / np.abs(w).max()
        assert err <= GRAD_TOL[dtype], (name, err)
    tm.zero_grad(set_to_none=True)


def test_lm_loss_sum_counts_unmasked_tokens():
    _, _, tm = _pair()
    toks = torch.from_numpy(_tokens((2, 7), 5))
    tgts = torch.from_numpy(_tokens((2, 7), 6))
    tgts[1, 2:] = -1
    with torch.no_grad():
        (total, n), aux = models.lm_loss_sum(tm)(toks, tgts)
        loss, metrics = models.lm_loss(tm)(toks, tgts)
        # any callable from tokens to logits will do for apply_fn
        again, _ = models.lm_loss(lambda t: tm(t))(toks, tgts)
    assert float(n) == 9.0 and aux == {}
    np.testing.assert_allclose(float(total) / 9.0, float(loss), rtol=1e-6)
    assert float(again) == float(loss)
    np.testing.assert_allclose(float(metrics['perp']),
                               np.exp(min(float(loss), 20.0)), rtol=1e-6)
    # every target masked: the loss is 0 / max(0, 1), not NaN
    with torch.no_grad():
        empty, _ = models.lm_loss(tm)(toks, torch.full_like(tgts, -1))
    assert float(empty) == 0.0


def test_masked_targets_get_no_gradient():
    _, _, tm = _pair()
    toks = torch.from_numpy(_tokens((1, 6), 7))
    tgts = torch.from_numpy(_tokens((1, 6), 8))
    tgts[0, 4:] = -1
    logits = tm(toks).detach().requires_grad_()
    loss, _ = models.lm_loss(lambda t: logits)(toks, tgts)
    loss.backward()
    assert float(logits.grad[0, 4:].abs().max()) == 0.0
    assert float(logits.grad[0, :4].abs().min()) > 0.0
    tm.zero_grad(set_to_none=True)


# ---------------------------------------------------------------------
# carrying weights across

def test_weight_round_trip_keeps_the_4d_qkv_kernel_as_is():
    jm, params, tm = _pair()
    # the DenseGeneral kernel is 4-D (d, 3, H, d_head): NOT a conv weight
    assert tm.block_0.qkv.kernel.shape == (32, 3, 4, 8)
    np.testing.assert_array_equal(tm.block_0.qkv.kernel.detach().numpy(),
                                  params['block_0']['qkv']['kernel'])
    back = dict(_flat(models.to_flax_variables(tm)['params']))
    want = dict(_flat(params))
    assert sorted(back) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)
    # the other tree names: embed/embedding, pos_embed, lnf_*, lm_head,
    # ln{1,2}_{scale,bias}
    for key in ('embed/embedding', 'pos_embed', 'lnf_scale', 'lnf_bias',
                'lm_head/kernel', 'lm_head/bias', 'block_1/ln2_scale',
                'block_1/ln1_bias'):
        assert key in back


def test_weight_round_trip_of_resnet_unchanged_beside_the_transformer():
    kw = dict(stage_sizes=[1], width=8, num_classes=10)
    jmodel = jresnet.ResNet(dtype=jnp.float32, **kw)
    variables = jax.device_get(jax.jit(
        lambda key: jmodel.init({'params': key}, jnp.zeros((1, 16, 16, 3)),
                                train=False))(jax.random.PRNGKey(1)))
    model = models.ResNet(dtype=torch.float32, device='cpu', **kw)
    models.load_flax_variables(model, variables)
    conv = model.Bottleneck_0.Conv_1.weight
    np.testing.assert_array_equal(
        conv.detach().numpy(),
        variables['params']['Bottleneck_0']['Conv_1']['kernel']
        .transpose(3, 2, 0, 1))
    got = models.to_flax_variables(model)
    for coll in ('params', 'batch_stats'):
        g, w = dict(_flat(got[coll])), dict(_flat(variables[coll]))
        assert sorted(g) == sorted(w)
        for key in w:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def test_load_demands_full_coverage():
    _, params, tm = _pair()
    bad = copy.deepcopy(params)
    del bad['lnf_bias']
    with pytest.raises(KeyError, match='lnf_bias'):
        models.load_flax_variables(tm, {'params': bad})
    extra = copy.deepcopy(params)
    extra['block_0']['qkv']['weight'] = extra['block_0']['qkv']['kernel']
    with pytest.raises(KeyError, match='qkv'):
        models.load_flax_variables(tm, {'params': extra})


def test_port_init_has_the_flax_tree_layout():
    _, params, _ = _pair()
    tm = models.TransformerLM(dtype=torch.float32, device='cpu',
                              generator=torch.Generator().manual_seed(3),
                              **CFG)
    got = dict(_flat(models.to_flax_variables(tm)['params']))
    want = dict(_flat(params))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape, key


# ---------------------------------------------------------------------
# the serving functions

def _jcache(jm, n_slots, s, int8):
    return jmodels.init_kv_cache(jm, n_slots, s, int8_kv=int8)


def _assert_cache(cache, jcache, dtype, int8):
    for name in sorted(jcache):
        got = cache[name]
        want = np.asarray(jnp.asarray(jcache[name]).astype(
            jnp.float32 if name.endswith('scale') or not int8
            else jnp.int8))
        if int8 and name in ('k', 'v'):
            # the same f32 values up to summation order: a value on a
            # rounding boundary may land one step away
            diff = np.abs(got.numpy().astype(np.int32)
                          - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name
            continue
        np.testing.assert_allclose(got.float().numpy(), want,
                                   err_msg=name, **TOL[dtype])


@pytest.mark.parametrize('dtype,int8', [('float32', False),
                                        ('bfloat16', False),
                                        ('float32', True)])
def test_prefill_and_decode_match_jax(dtype, int8):
    jm, params, tm = _pair(dtype)
    tparams = models.param_tree(tm)
    n_slots, s = 3, 16
    jcache = _jcache(jm, n_slots, s, int8)
    cache = models.init_kv_cache(tm, n_slots, s, int8_kv=int8, device='cpu')
    assert set(cache) == set(jcache)
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape
    tol = TOL['bfloat16' if int8 else dtype]
    # two prompts padded to their buckets, in slots 1 and 0
    for slot, length, bucket, seed in ((1, 5, 8, 5), (0, 3, 4, 6)):
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :length] = _tokens((length,), seed)
        jlogits, jcache = _jprefill(jm, params, jcache,
                                     jnp.asarray(toks), length, slot)
        with torch.no_grad():
            logits, cache = models.prefill(tm, tparams, cache,
                                           torch.from_numpy(toks), length,
                                           slot)
        assert logits.shape == (48,) and logits.dtype == torch.float32
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **tol)
    _assert_cache(cache, jcache, dtype, int8)
    # the full bucket: row i IS slot i; slot 2 is free (position 0)
    toks = np.asarray([7, 11, 0], np.int32)
    pos = np.asarray([3, 5, 0], np.int32)
    jlogits, jcache = _jdecode(jm, params, jcache, jnp.asarray(toks),
                               jnp.asarray(pos))
    with torch.no_grad():
        logits, cache = models.decode_step(tm, tparams, cache,
                                           torch.from_numpy(toks),
                                           torch.from_numpy(pos))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    _assert_cache(cache, jcache, dtype, int8)
    # a compacted bucket of two rows through the row -> slot map
    toks = np.asarray([3, 9], np.int32)
    slots = np.asarray([1, 0], np.int32)
    pos = np.asarray([6, 4], np.int32)
    jlogits, jcache = _jdecode(
        jm, params, jcache, jnp.asarray(toks), jnp.asarray(pos),
        slots=jnp.asarray(slots))
    with torch.no_grad():
        logits, cache = models.decode_step(
            tm, tparams, cache, torch.from_numpy(toks),
            torch.from_numpy(pos), slots=torch.from_numpy(slots))
    assert logits.shape == (2, 48)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    _assert_cache(cache, jcache, dtype, int8)


def test_decode_matches_the_full_forward():
    """prefill + decode steps equal the causal forward over the grown
    sequence (the JAX package's own parity pin, on the port alone)."""
    _, _, tm = _pair('float32')
    tparams = models.param_tree(tm)
    cache = models.init_kv_cache(tm, 2, 32, device='cpu')
    seq = list(_tokens((6,), 8))
    toks = np.zeros((1, 8), np.int32)
    toks[0, :6] = seq
    with torch.no_grad():
        logits, cache = models.prefill(tm, tparams, cache,
                                       torch.from_numpy(toks), 6, 1)
        for _ in range(4):
            full = tm(torch.tensor([seq]))[0, -1]
            torch.testing.assert_close(logits, full, rtol=1e-5, atol=1e-5)
            nxt = int(torch.argmax(logits))
            step, cache = models.decode_step(
                tm, tparams, cache, torch.tensor([nxt]),
                torch.tensor([len(seq)]), slots=torch.tensor([1]))
            logits = step[0]
            seq.append(nxt)


def test_full_bucket_decode_needs_one_row_per_slot():
    _, _, tm = _pair()
    cache = models.init_kv_cache(tm, 3, 8, device='cpu')
    with pytest.raises(ValueError, match='one row per cache slot'):
        with torch.no_grad():
            models.decode_step(tm, models.param_tree(tm), cache,
                               torch.zeros(2, dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32))


def test_unported_options_raise():
    """``tp_axis`` and ``sequence_axis`` are ported (held to the JAX
    package in ``test_torch_lm_parallel.py``); what the JAX model refuses
    is refused with its message, and a ``tp_axis`` needs a bound mesh.
    Dropout and the tensor-parallel cache, which raised before they were
    ported, now build: the rate is kept, and a cache holds ``n_heads /
    tp`` heads (``test_torch_lm_dropout.py``, ``test_torch_tp_serving.py``
    hold them to the JAX package)."""
    from chainermn_tpu_torch.parallel import MeshPlan
    with pytest.raises(ValueError, match='cannot both be set'):
        models.TransformerLM(tp_axis='model', sequence_axis='seq',
                             device='cpu', **CFG)
    with pytest.raises(ValueError, match='without dropout'):
        models.TransformerLM(tp_axis='model', dropout=0.1, device='cpu',
                             **CFG)
    with pytest.raises(ValueError, match='bound by no mesh'):
        models.TransformerLM(tp_axis='model', device='cpu', **CFG)
    with pytest.raises(ValueError, match="sp_scheme must be 'ring'"):
        models.TransformerLM(sequence_axis='seq', sp_scheme='tree',
                             device='cpu', **CFG)
    assert models.TransformerLM(dropout=0.1, device='cpu',
                                **CFG).block_0.drop.rate == 0.1
    _, _, tm = _pair()
    heads = CFG['n_heads']
    assert models.init_kv_cache(tm, 2, tp=2, device='cpu')['k'].shape[3] \
        == heads // 2
    with pytest.raises(ValueError, match='must divide'):
        models.init_kv_cache(tm, 2, tp=heads + 1, device='cpu')
    with MeshPlan.create(tp=1, size=1).bind():
        tpm = models.TransformerLM(tp_axis='model', device='cpu', **CFG)
    assert models.init_kv_cache(tpm, 2, device='cpu')['k'].shape[3] == heads


def test_entry_points_without_a_device_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        models.TransformerLM(**CFG)
    _, _, tm = _pair()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        models.init_kv_cache(tm, 2)


def test_gelu_is_the_tanh_approximation():
    x = torch.linspace(-4, 4, 101)
    want = jax.nn.gelu(jnp.asarray(x.numpy()))      # approximate=True
    np.testing.assert_allclose(tfm._gelu(x).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(x)
    assert not np.allclose(exact.numpy(), np.asarray(want), atol=1e-5)
