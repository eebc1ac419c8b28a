"""The port's paged decode, chunk attention, paged and speculative model
functions and page accounting (plain versions on the CPU) against the JAX
package's ``ops.flash_attention_decode_paged`` /
``ops.flash_attention_chunk`` (run as its own tests run them: the
``fallback`` and ``interpret`` modes), ``models.prefill_paged`` /
``decode_step_paged`` / ``spec_verify`` / ``spec_verify_paged``, and
``serving.paged``, from the same inputs and weights.

Tolerances: ops f32 rtol/atol 1e-5 (the same recurrence, sums in another
order), bf16 5e-2 (one bf16 rounding of the output may land on either
side); model logits f32 1e-5, int8-KV 5e-2 (the tolerances of
``tests/test_transformer.py``); the int8 caches of the two packages are
compared bit for bit; page accounting exactly.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import models as jmodels
from chainermn_tpu import ops as jops
from chainermn_tpu import precision as jprecision
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu.serving import paged as jpaged
from chainermn_tpu_torch import models, ops, precision, serving

fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')

torch.set_num_threads(2)

TOL = {'float32': dict(rtol=1e-5, atol=1e-5),
       'bfloat16': dict(rtol=5e-2, atol=5e-2)}
TDTYPE = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


def _rounded(a, dtype):
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(TDTYPE[dtype])


# ---------------------------------------------------------------------
# paged decode

def _pool(rows, n_pages, ps, h, d, lengths, dtype, seed):
    """q, a pool, and tables whose live pages are a shuffled draw and
    whose dead entries point at pages full of large garbage."""
    rng = np.random.RandomState(seed)
    q = _rounded(rng.randn(rows, h, d).astype(np.float32), dtype)
    k = _rounded(rng.randn(n_pages, ps, h, d).astype(np.float32), dtype)
    v = _rounded(rng.randn(n_pages, ps, h, d).astype(np.float32), dtype)
    n_max = max(-(-n // ps) for n in lengths) + 1
    pages = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((rows, n_max), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        live = -(-n // ps)
        tables[i, :live] = pages[used:used + live]
        used += live
    garbage = pages[used:]
    k[garbage] = 1e4
    v[garbage] = -1e4
    for i, n in enumerate(lengths):
        live = -(-n // ps)
        tables[i, live:] = rng.choice(garbage, n_max - live)
    return q, k, v, tables, np.asarray(lengths, np.int32)


# lengths include 1 (a decode bucket's pad row) and whole pages
PAGED_CASES = [(3, 8, 2, 32, [1, 30, 16]), (4, 5, 2, 64, [13, 1, 40, 7])]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('rows,ps,h,d,lengths', PAGED_CASES)
def test_paged_decode_matches_jax(mode, rows, ps, h, d, lengths, dtype):
    q, k, v, tables, lens = _pool(rows, 40, ps, h, d, lengths, dtype, 0)
    jdt = jnp.dtype(dtype)
    want = jops.flash_attention_decode_paged(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(tables), jnp.asarray(lens))
    got = ops.flash_attention_decode_paged(
        _t(q, dtype), _t(k, dtype), _t(v, dtype), _t(tables), _t(lens))
    assert got.dtype == TDTYPE[dtype] and got.shape == (rows, h, d)
    assert np.isfinite(got.float().numpy()).all()
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL[dtype])


@pytest.mark.parametrize('rows,ps,h,d,lengths', PAGED_CASES)
def test_int8_paged_decode_matches_jax_with_bit_equal_caches(mode, rows, ps,
                                                             h, d, lengths):
    q, k, v, tables, lens = _pool(rows, 40, ps, h, d, lengths, 'float32', 1)
    jkq, jks = jprecision.quantize_kv(jnp.asarray(k))
    jvq, jvs = jprecision.quantize_kv(jnp.asarray(v))
    kq, ks = precision.quantize_kv(_t(k))
    vq, vs = precision.quantize_kv(_t(v))
    for a, ja in ((kq, jkq), (ks, jks), (vq, jvq), (vs, jvs)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    want = jops.flash_attention_decode_paged(
        jnp.asarray(q), jkq, jvq, jnp.asarray(tables), jnp.asarray(lens),
        k_scale=jks, v_scale=jvs)
    got = ops.flash_attention_decode_paged(_t(q), kq, vq, _t(tables),
                                           _t(lens), k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])


def test_paged_reference_matches_jax_reference():
    q, k, v, tables, lens = _pool(3, 20, 8, 2, 32, [9, 1, 24], 'float32', 2)
    tables[tables >= 20] = 0
    want = jops.decode_attention_paged_reference(
        *(jnp.asarray(a) for a in (q, k, v, tables, lens)))
    got = ops.decode_attention_paged_reference(
        *(_t(a) for a in (q, k, v, tables, lens)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])


@pytest.mark.parametrize('int8', [False, True])
def test_paged_decode_equals_slot_decode_over_the_gathered_cache(int8):
    """Paging is a storage indirection: the slot decode of each row's
    pages gathered into a contiguous cache gives the same result."""
    q, k, v, tables, lens = _pool(4, 40, 8, 2, 32, [1, 17, 32, 9],
                                  'float32', 3)
    kt, vt = _t(k), _t(v)
    scales = {}
    if int8:
        kt, ks = precision.quantize_kv(kt)
        vt, vs = precision.quantize_kv(vt)
        scales = dict(k_scale=ks, v_scale=vs)
    got = ops.flash_attention_decode_paged(_t(q), kt, vt, _t(tables),
                                           _t(lens), **scales)
    live = torch.where(torch.arange(tables.shape[1])[None, :] * 8
                       < _t(lens)[:, None], _t(tables), 0)
    want = ops.flash_attention_decode(
        _t(q), fa._gather_pages(kt, live), fa._gather_pages(vt, live),
        _t(lens), **{key: fa._gather_pages(val, live)
                     for key, val in scales.items()})
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL['float32'])


def test_paged_decode_checks_like_jax():
    q, k, v, tables, lens = (_t(a) for a in _pool(1, 4, 8, 1, 32, [3],
                                                  'float32', 4))
    with pytest.raises(ValueError, match='BOTH'):
        ops.flash_attention_decode_paged(q, k, v, tables, lens,
                                         k_scale=torch.ones(4, 8, 1))
    with pytest.raises(ValueError, match='page_size'):
        ops.flash_attention_decode_paged(q, k[0], v[0], tables, lens)
    with pytest.raises(NotImplementedError, match='forward-only'):
        ops.flash_attention_decode_paged(q.requires_grad_(), k, v, tables,
                                         lens)


def test_paged_kernel_wrapper_takes_cuda_tensors_only():
    q, k, v, tables, lens = (_t(a) for a in _pool(1, 4, 8, 1, 32, [3],
                                                  'float32', 5))
    with pytest.raises(ValueError, match='CUDA'):
        ops.flash_decode_paged(q, k, v, tables, lens, 0.1)
    before = ops.launch_counts()
    ops.flash_attention_decode_paged(q, k, v, tables, lens)
    assert ops.launch_counts() == before     # CPU: the plain version
    assert 'flash_decode_paged' in before
    assert ops.KERNELS['flash_decode_paged'] is ops.flash_decode_paged


# ---------------------------------------------------------------------
# chunk attention

def _chunk_inputs(b, c, s, h, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in [(b, c, h, d)] * 3 + [(b, s, h, d)] * 2]


@pytest.mark.parametrize('c,s,ctx', [(5, 24, [0, 17]), (9, 150, [150, 3]),
                                     (130, 16, [16, 0])])
def test_chunk_matches_jax(mode, c, s, ctx):
    arrays = _chunk_inputs(2, c, s, 2, 32, 6)
    cl = np.asarray(ctx, np.int32)
    want = jops.flash_attention_chunk(*(jnp.asarray(a) for a in arrays),
                                      jnp.asarray(cl))
    got = ops.flash_attention_chunk(*(_t(a) for a in arrays), _t(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])
    ref = ops.chunk_attention_reference(*(_t(a) for a in arrays), _t(cl))
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **TOL['float32'])


def test_chunk_reference_matches_jax_reference():
    arrays = _chunk_inputs(2, 6, 20, 2, 32, 7)
    cl = np.asarray([4, 20], np.int32)
    want = jops.chunk_attention_reference(*(jnp.asarray(a) for a in arrays),
                                          jnp.asarray(cl))
    got = ops.chunk_attention_reference(*(_t(a) for a in arrays), _t(cl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])


def test_int8_context_chunk_matches_jax(mode):
    q, kn, vn, kc, vc = _chunk_inputs(2, 7, 40, 2, 32, 8)
    cl = np.asarray([33, 5], np.int32)
    jkq, jks = jprecision.quantize_kv(jnp.asarray(kc))
    jvq, jvs = jprecision.quantize_kv(jnp.asarray(vc))
    kq, ks = precision.quantize_kv(_t(kc))
    vq, vs = precision.quantize_kv(_t(vc))
    want = jops.flash_attention_chunk(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jkq, jvq,
        jnp.asarray(cl), k_scale=jks, v_scale=jvs)
    got = ops.flash_attention_chunk(_t(q), _t(kn), _t(vn), kq, vq, _t(cl),
                                    k_scale=ks, v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])


def test_chunk_with_f32_fresh_kv_beside_a_bf16_query_matches_jax(mode):
    """The int8 verify of a bf16 model hands the chunk dequantized f32
    K/V beside a bf16 query; the JAX fallback widens all three to f32,
    and so does the port (the kernel takes one dtype)."""
    q, kn, vn, kc, vc = _chunk_inputs(1, 6, 24, 2, 32, 10)
    q, kc, vc = (_rounded(a, 'bfloat16') for a in (q, kc, vc))
    cl = np.asarray([19], np.int32)
    bf = jnp.bfloat16
    want = jops.flash_attention_chunk(
        jnp.asarray(q, bf), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(kc, bf), jnp.asarray(vc, bf), jnp.asarray(cl))
    got = ops.flash_attention_chunk(_t(q, 'bfloat16'), _t(kn), _t(vn),
                                    _t(kc, 'bfloat16'), _t(vc, 'bfloat16'),
                                    _t(cl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _f32(want),
                               **TOL['bfloat16'])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_empty_context_chunk_is_bitwise_the_causal_forward(dtype):
    """``ctx_len == 0`` (and an empty context) merge as the identity: the
    chunk is bit for bit :func:`flash_attention_fwd`'s causal output,
    which is what lets an unchunked paged prefill equal the slot one."""
    arrays = [_rounded(a, dtype) for a in _chunk_inputs(1, 9, 32, 2, 32, 9)]
    q, kn, vn, kc, vc = (_t(a, dtype) for a in arrays)
    want, _ = ops.flash_attention_fwd(q, kn, vn, causal=True)
    zero = torch.zeros(1, dtype=torch.int32)
    got = ops.flash_attention_chunk(q, kn, vn, kc, vc, zero)
    assert torch.equal(got, want)
    empty = ops.flash_attention_chunk(q, kn, vn, kc[:, :0], vc[:, :0], zero)
    assert torch.equal(empty, want)


# ---------------------------------------------------------------------
# the model functions

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
PS = 8


@functools.lru_cache(maxsize=None)
def _pair():
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))['params'])
    tm = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    models.load_flax_variables(tm, {'params': params})
    return jm, params, tm, models.param_tree(tm)


# the JAX paged functions, compiled once per shape
_jprefill_paged = jax.jit(jmodels.prefill_paged, static_argnums=(0,))
_jdecode_paged = jax.jit(jmodels.decode_step_paged, static_argnums=(0,))


def _jcache(n_pages, int8_kv):
    jm = _pair()[0]
    return jmodels.init_paged_kv_cache(jm, n_pages=n_pages, page_size=PS,
                                       int8_kv=int8_kv)


def _tcache(n_pages, int8_kv):
    return models.init_paged_kv_cache(_pair()[2], n_pages, PS,
                                      int8_kv=int8_kv, device='cpu')


def _stepwise(jax_side, cache, toks, t_pre, table, chunk=None, start=0):
    """Prefill ``toks[start:t_pre]`` in ``chunk``-token pieces (the whole
    remainder when None) through ``table``, then teacher-force the rest
    with paged decode steps; returns ({position: logits}, cache) -- the
    JAX test's ``_stepwise`` for either package."""
    jm, params, tm, tparams = _pair()
    width = chunk or (t_pre - start)
    out, pos = {}, start
    while pos < t_pre:
        n = min(width, t_pre - pos)
        pad = np.zeros((1, width), np.int32)
        pad[0, :n] = toks[pos:pos + n]
        if jax_side:
            lg, cache = _jprefill_paged(
                jm, params, cache, jnp.asarray(pad), jnp.asarray(n),
                jnp.asarray(table), jnp.asarray(pos))
        else:
            lg, cache = models.prefill_paged(tm, tparams, cache, _t(pad), n,
                                             _t(table), pos)
        pos += n
    out[t_pre - 1] = np.asarray(lg)
    for p in range(t_pre, len(toks)):
        tok, posv = np.asarray([toks[p]], np.int32), np.asarray([p],
                                                                np.int32)
        if jax_side:
            lg, cache = _jdecode_paged(
                jm, params, cache, jnp.asarray(tok), jnp.asarray(posv),
                jnp.asarray(table[None]))
        else:
            lg, cache = models.decode_step_paged(tm, tparams, cache, _t(tok),
                                                 _t(posv), _t(table[None]))
        out[p] = np.asarray(lg[0])
    return out, cache


@pytest.mark.parametrize('int8_kv,tol', [(False, 1e-5), (True, 5e-2)])
def test_paged_prefill_and_decode_match_jax_and_the_full_forward(int8_kv,
                                                                 tol):
    jm, params, tm, _ = _pair()
    toks = np.random.RandomState(10).randint(0, 64, 20).astype(np.int32)
    table = np.array([5, 2, 7, 1, 3, 8, 4, 6], np.int32)
    with torch.no_grad():
        got, _ = _stepwise(False, _tcache(9, int8_kv), toks, 6, table)
        full = tm(_t(toks[None]))[0].numpy()
    want, _ = _stepwise(True, _jcache(9, int8_kv), toks, 6, table)
    for p in got:
        np.testing.assert_allclose(got[p], want[p], rtol=tol, atol=tol)
        np.testing.assert_allclose(got[p], full[p], rtol=tol, atol=tol)


def test_chunked_prefill_matches_jax_and_monolithic():
    toks = np.random.RandomState(11).randint(0, 64, 18).astype(np.int32)
    table = np.array([3, 1, 4, 2, 5], np.int32)
    with torch.no_grad():
        mono, _ = _stepwise(False, _tcache(6, False), toks, 13, table)
        chunked, _ = _stepwise(False, _tcache(6, False), toks, 13, table,
                               chunk=4)
    want, _ = _stepwise(True, _jcache(6, False), toks, 13, table, chunk=4)
    for p in mono:
        np.testing.assert_allclose(chunked[p], mono[p], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(chunked[p], want[p], rtol=1e-5,
                                   atol=1e-5)


def test_paged_parity_across_page_reuse_and_shared_prefix_pages():
    """B prefills through pages A just dirtied (no zeroing) and gets its
    fresh-pool logits; C reads A's two banked prefix pages and prefills
    only its suffix (``pos0 = 16``) into a private page, and gets its own
    full forward."""
    _, _, tm, _ = _pair()
    rng = np.random.RandomState(12)
    shared = rng.randint(0, 64, 16).astype(np.int32)
    tok_a = np.concatenate([shared, rng.randint(0, 64, 6).astype(np.int32)])
    tok_b = rng.randint(0, 64, 11).astype(np.int32)
    tok_c = np.concatenate([shared, rng.randint(0, 64, 8).astype(np.int32)])
    with torch.no_grad():
        _, cache = _stepwise(False, _tcache(6, False), tok_a, 20,
                             np.array([1, 2, 3], np.int32))
        got_c, cache = _stepwise(False, cache, tok_c, 20,
                                 np.array([1, 2, 4], np.int32), start=16)
        got_b, _ = _stepwise(False, cache, tok_b, 5,
                             np.array([3, 5], np.int32))
        fresh_b, _ = _stepwise(False, _tcache(6, False), tok_b, 5,
                               np.array([3, 5], np.int32))
        full_c = tm(_t(tok_c[None]))[0].numpy()
    for p in got_b:
        np.testing.assert_allclose(got_b[p], fresh_b[p], rtol=1e-6,
                                   atol=1e-6)
    for p in got_c:
        np.testing.assert_allclose(got_c[p], full_c[p], rtol=1e-5,
                                   atol=1e-5)


def test_unchunked_paged_prefill_is_bitwise_the_slot_prefill():
    jm, params, tm, tparams = _pair()
    toks = np.random.RandomState(13).randint(0, 64, (1, 16)).astype(np.int32)
    with torch.no_grad():
        slot, _ = models.prefill(tm, tparams, models.init_kv_cache(
            tm, 2, device='cpu'), _t(toks), 11, 1)
        paged, _ = models.prefill_paged(tm, tparams, _tcache(4, False),
                                        _t(toks), 11,
                                        _t(np.array([2, 3], np.int32)), 0)
    assert torch.equal(slot, paged)


K = 4


@pytest.mark.parametrize('paged', [False, True])
@pytest.mark.parametrize('int8_kv', [False, True])
def test_spec_verify_matches_jax_and_sequential_decode(paged, int8_kv):
    """One verify pass over a 4-token window gives the logits of the
    sequential teacher-forced decode steps (argmax exactly), and the JAX
    verify's; the next decode step reads the same cache after either."""
    jm, params, tm, tparams = _pair()
    toks = np.random.RandomState(20).randint(0, 64, 6 + K).astype(np.int32)
    t_pre = 6
    pad = toks[None, :t_pre]
    table = np.array([2, 1, 3, 4], np.int32)

    def fresh_port():
        if paged:
            cache = _tcache(5, int8_kv)
            models.prefill_paged(tm, tparams, cache, _t(pad), t_pre,
                                 _t(table), 0)
        else:
            cache = models.init_kv_cache(tm, 2, int8_kv=int8_kv,
                                         device='cpu')
            models.prefill(tm, tparams, cache, _t(pad), t_pre, 1)
        return cache

    def decode(cache, tok, pos):
        tok, pos = _t(np.asarray([tok], np.int32)), _t(np.asarray(
            [pos], np.int32))
        if paged:
            return models.decode_step_paged(tm, tparams, cache, tok, pos,
                                            _t(table[None]))[0][0]
        return models.decode_step(tm, tparams, cache, tok, pos,
                                  slots=_t(np.asarray([1], np.int32)))[0][0]

    win = toks[None, t_pre:t_pre + K]
    base = np.asarray([t_pre], np.int32)
    with torch.no_grad():
        c_seq, c_win = fresh_port(), fresh_port()
        want = [decode(c_seq, toks[t_pre + j], t_pre + j).numpy()
                for j in range(K)]
        if paged:
            got, _ = models.spec_verify_paged(tm, tparams, c_win, _t(win),
                                              _t(base), _t(table[None]))
        else:
            got, _ = models.spec_verify(tm, tparams, c_win, _t(win),
                                        _t(base),
                                        slots=_t(np.asarray([1], np.int32)))
        got = got[0].numpy()
        nxt = int(got[-1].argmax())
        after_seq = decode(c_seq, nxt, t_pre + K).numpy()
        after_win = decode(c_win, nxt, t_pre + K).numpy()
    for j in range(K):
        np.testing.assert_allclose(got[j], want[j], rtol=1e-5, atol=1e-5)
        assert int(got[j].argmax()) == int(want[j].argmax()), j
    np.testing.assert_allclose(after_win, after_seq, rtol=1e-5, atol=1e-5)
    # the JAX verify over the same prefilled cache
    if paged:
        jc = _jcache(5, int8_kv)
        _, jc = jmodels.prefill_paged(jm, params, jc, jnp.asarray(pad),
                                      jnp.asarray(t_pre), jnp.asarray(table),
                                      jnp.asarray(0))
        jgot, _ = jmodels.spec_verify_paged(jm, params, jc, jnp.asarray(win),
                                            jnp.asarray(base),
                                            jnp.asarray(table[None]))
    else:
        jc = jmodels.init_kv_cache(jm, n_slots=2, int8_kv=int8_kv)
        _, jc = jmodels.prefill(jm, params, jc, jnp.asarray(pad),
                                jnp.asarray(t_pre), jnp.asarray(1))
        jgot, _ = jmodels.spec_verify(jm, params, jc, jnp.asarray(win),
                                      jnp.asarray(base),
                                      slots=jnp.asarray([1], jnp.int32))
    np.testing.assert_allclose(got, np.asarray(jgot)[0], rtol=1e-5,
                               atol=1e-5)


def test_full_bucket_verify_matches_compacted_and_drops_the_overhang():
    """The full-slot verify (no slot map) gives the compacted verify's
    logits for the same live row; a window overhanging the cache depth
    writes nothing past it."""
    _, _, tm, tparams = _pair()
    toks = np.random.RandomState(21).randint(0, 64, 10).astype(np.int32)
    win = np.stack([toks[6:10], np.zeros(K, np.int32)]).astype(np.int32)
    with torch.no_grad():
        caches = []
        for _ in range(2):
            cache = models.init_kv_cache(tm, 2, max_len=9, device='cpu')
            models.prefill(tm, tparams, cache, _t(toks[None, :6]), 6, 0)
            caches.append(cache)
        lg_c, _ = models.spec_verify(tm, tparams, caches[0], _t(win[:1]),
                                     _t(np.asarray([6], np.int32)),
                                     slots=_t(np.asarray([0], np.int32)))
        lg_f, cache = models.spec_verify(tm, tparams, caches[1], _t(win),
                                         _t(np.asarray([6, 7], np.int32)))
    np.testing.assert_allclose(lg_f[0, :3].numpy(), lg_c[0, :3].numpy(),
                               rtol=1e-6, atol=1e-6)
    assert cache['k'].shape[2] == 9          # positions 9, 10 dropped


# ---------------------------------------------------------------------
# page accounting

def test_prefix_key_matches_jax():
    rng = np.random.RandomState(5)
    for n in (3, 8, 9, 17, 24):
        p = rng.randint(1, 32, n).tolist()
        assert serving.prefix_key(p, PS) == jpaged.prefix_key(p, PS)


def _drive(pkg):
    """One operation sequence over a pool and its index; returns every
    observable along the way."""
    pool = pkg.PagePool(9, 4)
    index = pkg.RadixPrefixIndex(pool)
    seen = []
    a = [pool.alloc() for _ in range(3)]
    index.insert(list(range(10)), a)              # 2 full pages + a tail
    for page in a:
        pool.release(page)                        # the sequence finished
    seen.append(('banked', index.banked_pages(), pool.in_use(),
                 pool.available(), [pool.refcount(p) for p in range(9)]))
    seen.append(('lookup', index.lookup(list(range(12)))))
    seen.append(('miss', index.lookup([9, 9, 9, 9, 1])))
    seen.append(('partial', index.lookup(list(range(6)))))
    b = [pool.alloc() for _ in range(4)]
    index.insert([7] * 13, b)
    seen.append(('second', index.banked_pages(),
                 [pool.refcount(p) for p in range(9)]))
    seen.append(('hits', index.lookups, index.hits, index.tokens_reused,
                 index.hit_rate()))
    seen.append(('evict', index.evict(2), pool.in_use(),
                 [pool.refcount(p) for p in range(9)]))
    for page in b:
        pool.release(page)
    seen.append(('dry', [pool.alloc() for _ in range(6)], pool.peak_in_use))
    index.flush()
    seen.append(('flushed', index.banked_pages(), pool.in_use(),
                 pool.available()))
    return seen


def test_page_pool_and_radix_index_follow_jax():
    """The same operations give the same page ids, refcounts, hits,
    evictions and peaks as the JAX package's host code."""
    got, want = _drive(serving), _drive(jpaged)
    assert got == want
    assert got[1][1] == ([1, 2], 3, 2)            # 2 full pages + 2 of 4
    with pytest.raises(ValueError, match='free page'):
        serving.PagePool(4, 2).release(3)
    with pytest.raises(ValueError, match='at least 2'):
        serving.PagePool(1, 2)
