"""The port's flash attention forward, backward and decode (plain
versions on the CPU) against the JAX package's ``ops.flash_attention``
(and ``jax.grad`` of it), its internal ``_flash_fwd`` (for ``lse``) and
``ops.flash_attention_decode``, run as the JAX package's own tests run
them: the ``fallback`` (jnp) and ``interpret`` (the Pallas kernels in
the interpreter) modes.

Tolerances: forward f32 rtol/atol 1e-5 (the same recurrence, sums in
another order), gradients f32 1e-4 (sums over every key or query of
products of recomputed probabilities), bf16 5e-2 (one bf16 rounding of
the output may land on either side).  The int8 caches of the two
packages are compared bit for bit.
"""

import importlib
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu import precision as jprecision
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops, precision

# the modules (each package re-exports a function of the same name)
jfa = importlib.import_module('chainermn_tpu.ops.flash_attention')
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


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card with '
                    '`python -m pytest -m cuda tests/test_torch_*.py`')


def _rounded(a, dtype):
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _qkv(shape, dtype, seed):
    """q, k, v ``(B, T, H, D)`` as strided views of one fused
    ``(B, T, 3, H, D)`` projection, as the model hands them over; the
    numpy values for JAX."""
    b, t, h, d = shape
    rng = np.random.RandomState(seed)
    fused = _rounded(rng.randn(b, t, 3, h, d).astype(np.float32), dtype)
    tq = torch.tensor(fused, dtype=TDTYPE[dtype])
    return ([tq[:, :, i] for i in range(3)],
            [jnp.asarray(np.ascontiguousarray(fused[:, :, i]), dtype)
             for i in range(3)])


# T = 130 is ragged against the 128 block: keys padded and masked, query
# rows padded and dropped (two blocks); T = 9 is one block
CASES = [((1, 9, 2, 32), True), ((2, 130, 2, 32), True),
         ((1, 130, 2, 32), False)]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,causal', CASES)
def test_forward_out_and_lse_match_jax(mode, shape, causal, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(shape, dtype, 0)
    b, t, h, d = shape
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    out, lse = ops.flash_attention_fwd(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == (b, t, h, d)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, t)
    np.testing.assert_allclose(out.float().numpy(), _f32(want),
                               **TOL[dtype])
    # lse from the JAX package's internal forward, padded the way its
    # public wrapper pads
    blk = min(128, t)
    pad = (-t) % blk

    def merge(x):
        x = jnp.swapaxes(x, 1, 2).reshape(b * h, t, d)
        return jnp.pad(x, ((0, 0), (0, pad), (0, 0)))

    _, (_, _, _, _, jlse) = jfa._flash_fwd(merge(jq), merge(jk), merge(jv),
                                           causal, d ** -0.5, t, blk, blk)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse)[:, :t].reshape(b, h, t),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        ops.flash_attention(q, k, v, causal=causal).float().numpy(),
        out.float().numpy(), rtol=0, atol=0)


def test_mha_reference_matches_jax():
    (q, k, v), (jq, jk, jv) = _qkv((2, 11, 2, 32), 'float32', 1)
    for causal in (False, True):
        want = jops.mha_reference(jq, jk, jv, causal=causal)
        got = ops.mha_reference(q, k, v, causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **TOL['float32'])
        # the blockwise forward agrees with the full softmax
        np.testing.assert_allclose(
            ops.flash_attention(q, k, v, causal=causal).numpy(),
            got.numpy(), **TOL['float32'])


def test_strided_views_equal_contiguous_operands():
    (q, k, v), _ = _qkv((2, 20, 2, 32), 'float32', 2)
    assert not q.is_contiguous()
    a = ops.flash_attention_fwd(q, k, v, causal=True)
    c = ops.flash_attention_fwd(q.contiguous(), k.contiguous(),
                                v.contiguous(), causal=True)
    for x, y in zip(a, c):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


def test_causal_needs_square():
    (q, k, v), _ = _qkv((1, 4, 1, 32), 'float32', 3)
    with pytest.raises(ValueError, match='t_q == t_kv'):
        ops.flash_attention(q, k[:, :3], v[:, :3], causal=True)


# ---------------------------------------------------------------------
# decode

def _cache(b, s, h, d, dtype, seed):
    rng = np.random.RandomState(seed)
    q = _rounded(rng.randn(b, h, d).astype(np.float32), dtype)
    k = _rounded(rng.randn(b, s, h, d).astype(np.float32), dtype)
    v = _rounded(rng.randn(b, s, h, d).astype(np.float32), dtype)
    return q, k, v


# S = 150 is ragged against the 128 key block (padded and masked);
# lengths include 1 (the pad rows of a decode bucket) and S
DECODE_CASES = [(4, 150, 2, 32, [1, 150, 77, 128]),
                (3, 40, 2, 64, [40, 1, 13])]


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b,s,h,d,lengths', DECODE_CASES)
def test_decode_matches_jax(mode, b, s, h, d, lengths, dtype):
    q, k, v = _cache(b, s, h, d, dtype, 4)
    lens = np.asarray(lengths, np.int32)
    jdt = jnp.dtype(dtype)
    want = jops.flash_attention_decode(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        jnp.asarray(lens))
    tdt = TDTYPE[dtype]
    got = ops.flash_attention_decode(
        torch.tensor(q, dtype=tdt), torch.tensor(k, dtype=tdt),
        torch.tensor(v, dtype=tdt), torch.from_numpy(lens))
    assert got.dtype == tdt and got.shape == (b, h, d)
    np.testing.assert_allclose(got.float().numpy(), _f32(want),
                               **TOL[dtype])


@pytest.mark.parametrize('b,s,h,d,lengths', DECODE_CASES)
def test_int8_decode_matches_jax_with_bit_equal_caches(mode, b, s, h, d,
                                                       lengths):
    q, k, v = _cache(b, s, h, d, 'float32', 5)
    lens = np.asarray(lengths, np.int32)
    jkq, jks = jprecision.quantize_kv(jnp.asarray(k))
    jvq, jvs = jprecision.quantize_kv(jnp.asarray(v))
    kq, ks = precision.quantize_kv(torch.from_numpy(k))
    vq, vs = precision.quantize_kv(torch.from_numpy(v))
    for a, ja in ((kq, jkq), (ks, jks), (vq, jvq), (vs, jvs)):
        assert str(a.dtype) == 'torch.%s' % ja.dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    want = jops.flash_attention_decode(jnp.asarray(q), jkq, jvq,
                                       jnp.asarray(lens), k_scale=jks,
                                       v_scale=jvs)
    got = ops.flash_attention_decode(torch.from_numpy(q), kq, vq,
                                     torch.from_numpy(lens), k_scale=ks,
                                     v_scale=vs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])


def test_quantize_kv_rounds_half_to_even_and_zero_rows():
    x = np.zeros((3, 4), np.float32)
    x[0] = [127.0, 0.5, 1.5, -2.5]       # scale 1: halves go to even
    x[1] = [254.0, 1.0, 3.0, -5.0]       # scale 2: x / 2 has halves
    jq, js = jprecision.quantize_kv(jnp.asarray(x))
    q, s = precision.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[0].tolist() == [127, 0, 2, -2] and s[2] == 1.0
    np.testing.assert_allclose(
        precision.dequantize_kv(q, s).numpy(),
        np.asarray(jprecision.dequantize_kv(jq, js)), rtol=0, atol=0)


@pytest.mark.parametrize('int8', [False, True])
def test_decode_with_slot_map_reads_the_mapped_slots(int8):
    n_slots, s, h, d = 6, 20, 2, 32
    q, k, v = _cache(n_slots, s, h, d, 'float32', 6)
    rows = np.asarray([4, 0, 5], np.int32)
    lens = np.asarray([1, 20, 9], np.int32)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    scales = {}
    if int8:
        kt, ks = precision.quantize_kv(kt)
        vt, vs = precision.quantize_kv(vt)
        scales = dict(k_scale=ks, v_scale=vs)
    got = ops.flash_attention_decode(torch.from_numpy(q[:3]), kt, vt,
                                     torch.from_numpy(lens),
                                     slots=torch.from_numpy(rows), **scales)
    idx = torch.from_numpy(rows).long()
    want = ops.decode_attention_reference(
        torch.from_numpy(q[:3]), kt[idx], vt[idx], torch.from_numpy(lens),
        **{key: val[idx] for key, val in scales.items()})
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL['float32'])


def test_decode_reference_matches_jax_reference():
    q, k, v = _cache(3, 17, 2, 32, 'float32', 7)
    lens = np.asarray([17, 1, 5], np.int32)
    want = jops.decode_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                           jnp.asarray(v), jnp.asarray(lens))
    got = ops.decode_attention_reference(torch.from_numpy(q),
                                         torch.from_numpy(k),
                                         torch.from_numpy(v),
                                         torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])


def test_decode_needs_both_scales():
    q, k, v = (torch.from_numpy(a) for a in _cache(1, 4, 1, 32, 'float32',
                                                   8))
    with pytest.raises(ValueError, match='BOTH'):
        ops.flash_attention_decode(q, k, v, torch.ones(1, dtype=torch.int32),
                                   k_scale=torch.ones(1, 4, 1))


def test_kernel_wrappers_take_cuda_tensors_only():
    (q, k, v), _ = _qkv((1, 4, 1, 32), 'float32', 9)
    with pytest.raises(ValueError, match='CUDA'):
        ops.flash_fwd(q, k, v, True, 0.1)
    with pytest.raises(ValueError, match='CUDA'):
        ops.flash_decode(q[:, 0], k, v, torch.ones(1, dtype=torch.int32),
                         0.1)
    before = ops.launch_counts()
    ops.flash_attention(q, k, v, causal=True)
    ops.flash_attention_decode(q[:, 0], k, v,
                               torch.ones(1, dtype=torch.int32))
    assert ops.launch_counts() == before     # CPU: the plain versions


# ---------------------------------------------------------------------
# backward

GRAD_TOL = {'float32': dict(rtol=1e-4, atol=1e-4),
            'bfloat16': dict(rtol=5e-2, atol=5e-2)}


def _grads(fn, operands, weights):
    """d(sum(fn(q, k, v) * weights)) / d(q, k, v) on fresh leaves that
    keep the operands' strides."""
    leaves = [x.detach().requires_grad_() for x in operands]
    out = fn(*leaves)
    loss = out.sum() if weights is None else (out.float() * weights).sum()
    return torch.autograd.grad(loss, leaves)


def _assert_grads_match_jax(tensors, arrays, causal, dtype, weighted, seed):
    q = tensors[0]
    weights = None
    if weighted:
        weights = np.random.RandomState(seed).randn(*q.shape).astype(
            np.float32)

    def jloss(jq, jk, jv):
        out = jops.flash_attention(jq, jk, jv, causal=causal).astype(
            jnp.float32)
        return jnp.sum(out if weights is None else out * weights)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*arrays)
    got = _grads(lambda a, b, c: ops.flash_attention(a, b, c, causal=causal),
                 tensors,
                 None if weights is None else torch.from_numpy(weights))
    for name, g, w, x in zip(('dq', 'dk', 'dv'), got, want, tensors):
        assert g.dtype == x.dtype and g.shape == x.shape, name
        np.testing.assert_allclose(g.float().numpy(), _f32(w), err_msg=name,
                                   **GRAD_TOL[dtype])


# a weighted loss hands the backward a dense gradient; ``sum()`` hands it
# an expanded scalar (every stride 0)
@pytest.mark.parametrize('weighted', [True, False])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape,causal', CASES)
def test_gradients_match_jax(mode, shape, causal, dtype, weighted):
    tensors, arrays = _qkv(shape, dtype, 20)
    assert not tensors[0].is_contiguous()       # strided qkv views
    _assert_grads_match_jax(tensors, arrays, causal, dtype, weighted, 21)


def test_gradients_match_jax_non_causal_with_other_key_length(mode):
    (q, _, _), (jq, _, _) = _qkv((2, 20, 2, 32), 'float32', 22)
    (_, k, v), (_, jk, jv) = _qkv((2, 150, 2, 32), 'float32', 23)
    _assert_grads_match_jax((q, k, v), (jq, jk, jv), False, 'float32', True,
                            24)


def test_gradients_of_strided_views_equal_contiguous_operands():
    tensors, _ = _qkv((2, 37, 2, 32), 'float32', 25)
    w = torch.from_numpy(np.random.RandomState(26).randn(2, 37, 2, 32)
                         .astype(np.float32))

    def fn(a, b, c):
        return ops.flash_attention(a, b, c, causal=True)

    strided = _grads(fn, tensors, w)
    dense = _grads(fn, [x.contiguous() for x in tensors], w)
    for a, c in zip(strided, dense):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_gradients_match_the_full_softmax_oracle():
    tensors, _ = _qkv((2, 70, 2, 32), 'float32', 27)
    w = torch.from_numpy(np.random.RandomState(28).randn(2, 70, 2, 32)
                         .astype(np.float32))
    for causal in (False, True):
        got = _grads(lambda a, b, c: ops.flash_attention(a, b, c,
                                                         causal=causal),
                     tensors, w)
        want = _grads(lambda a, b, c: ops.mha_reference(a, b, c,
                                                        causal=causal),
                      tensors, w)
        for a, c in zip(got, want):
            torch.testing.assert_close(a, c, **GRAD_TOL['float32'])


def test_lse_carries_no_gradient():
    tensors, _ = _qkv((1, 9, 2, 32), 'float32', 29)
    leaves = [x.detach().requires_grad_() for x in tensors]
    out, lse = ops.flash_attention_fwd(*leaves, causal=True)
    assert out.requires_grad and not lse.requires_grad


def test_backward_kernel_wrappers_take_cuda_tensors_only():
    (q, k, v), _ = _qkv((1, 4, 1, 32), 'float32', 30)
    rows = torch.zeros(1, 1, 4)
    with pytest.raises(ValueError, match='CUDA'):
        ops.flash_bwd_dq(q, k, v, q, q, rows, True, 0.1)
    with pytest.raises(ValueError, match='CUDA'):
        ops.flash_bwd_dkv(q, k, v, q, rows, rows, True, 0.1)
    before = ops.launch_counts()
    _grads(lambda a, b, c: ops.flash_attention(a, b, c, causal=True),
           (q, k, v), None)
    assert ops.launch_counts() == before     # CPU: the plain versions
    assert {'flash_bwd_dq', 'flash_bwd_dkv'} <= set(before)


def test_dq_wrapper_takes_out_and_returns_delta():
    """``flash_bwd_dq(q, k, v, g, out, lse, causal, scale) -> (dq,
    delta)``: the kernel forms ``delta`` from ``g`` and ``out`` itself.
    On CPU tensors it raises, whichever operand lies there."""
    params = list(inspect.signature(ops.flash_bwd_dq).parameters)
    assert params == ['q', 'k', 'v', 'g', 'out', 'lse', 'causal', 'scale']
    (q, k, v), _ = _qkv((1, 4, 1, 32), 'bfloat16', 31)
    lse = torch.zeros(1, 1, 4)
    for i in range(5):
        args = [q, k, v, q, q]
        args[i] = args[i].clone()
        with pytest.raises(ValueError, match='CUDA'):
            ops.flash_bwd_dq(*args, lse, True, 0.1)


@pytest.mark.parametrize('dtype,causal', [('float32', True),
                                          ('float32', False),
                                          ('bfloat16', True)])
def test_autograd_backward_on_the_cpu_matches_the_oracle(dtype, causal):
    """``_FlashAttention.backward`` on CPU tensors (the plain backward,
    which forms its own ``delta``) against autograd through
    ``mha_reference``: f32 at the gradient tolerance, bf16 leaves widened
    to f32 for the oracle, at its bf16 tolerance."""
    tensors, _ = _qkv((2, 37, 2, 64), dtype, 32)
    w = torch.from_numpy(np.random.RandomState(33).randn(2, 37, 2, 64)
                         .astype(np.float32)).to(tensors[0].dtype)
    got = _grads(lambda a, b, c: ops.flash_attention(a, b, c,
                                                     causal=causal),
                 tensors, w)
    want = _grads(lambda a, b, c: ops.mha_reference(a, b, c,
                                                    causal=causal),
                  [x.float() for x in tensors], w.float())
    before = ops.launch_counts()
    for a, c in zip(got, want):
        torch.testing.assert_close(a.float(), c, **GRAD_TOL[dtype])
    assert ops.launch_counts() == before


def test_decode_refuses_autograd():
    """Decode is inference: no backward, as in the JAX package."""
    q, k, v = (torch.from_numpy(a) for a in _cache(1, 4, 1, 32, 'float32',
                                                   10))
    lens = torch.ones(1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match='forward-only'):
        ops.flash_attention_decode(q.requires_grad_(), k, v, lens)
    with torch.no_grad():
        ops.flash_attention_decode(q, k, v, lens)


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card(cuda):
    (q, k, v), _ = _qkv((2, 100, 8, 64), 'bfloat16', 11)
    want, wlse = ops.flash_attention_fwd(q, k, v, causal=True)
    got, lse = ops.flash_attention_fwd(q.cuda(), k.cuda(), v.cuda(),
                                       causal=True)
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    torch.testing.assert_close(lse.cpu(), wlse, rtol=1e-5, atol=1e-4)
    qd, kd, vd = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _cache(4, 64, 8, 64, 'bfloat16', 12))
    lens = torch.tensor([1, 64, 33, 7], dtype=torch.int32)
    want = ops.flash_attention_decode(qd, kd, vd, lens)
    got = ops.flash_attention_decode(qd.cuda(), kd.cuda(), vd.cuda(),
                                     lens.cuda())
    torch.testing.assert_close(got.cpu().float(), want.float(), rtol=1e-2,
                               atol=1e-2)
    assert fa.flash_decode.launches > 0
    # the backward kernels against the plain backward, through autograd
    w = torch.from_numpy(np.random.RandomState(13).randn(2, 100, 8, 64)
                         .astype(np.float32))

    def fn(a, b, c):
        return ops.flash_attention(a, b, c, causal=True)

    want = _grads(fn, (q, k, v), w)
    got = _grads(fn, (q.cuda(), k.cuda(), v.cuda()), w.cuda())
    for g, x in zip(got, want):
        torch.testing.assert_close(g.cpu().float(), x.float(), rtol=1e-2,
                                   atol=1e-2)
    assert fa.flash_bwd_dq.launches > 0 and fa.flash_bwd_dkv.launches > 0
    # the tensor-core kernels (bf16) at the other head widths, ragged
    # across their 64-row tiles; dk and dv bit for bit on a second run
    for shape, seed in (((2, 70, 2, 32), 15), ((1, 130, 2, 128), 16)):
        (q, k, v), _ = _qkv(shape, 'bfloat16', seed)
        tc = ops.tc_launch_counts()
        want, wlse = ops.flash_attention_fwd(q, k, v, causal=True)
        qc, kc, vc = q.cuda(), k.cuda(), v.cuda()
        got, lse = ops.flash_attention_fwd(qc, kc, vc, causal=True)
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=1e-2, atol=1e-2)
        torch.testing.assert_close(lse.cpu(), wlse, rtol=1e-5, atol=1e-4)
        g = torch.from_numpy(np.random.RandomState(seed).randn(*shape)
                             .astype(np.float32)).to(torch.bfloat16)
        pdq, pdk, pdv = fa._bwd_plain(q, k, v, want, wlse, g, True,
                                      shape[3] ** -0.5)
        gc = g.cuda()
        # the dq kernel forms delta = rowsum(g * out) for dk/dv
        dq_runs = [ops.flash_bwd_dq(qc, kc, vc, gc, got, lse, True,
                                    shape[3] ** -0.5) for _ in range(2)]
        dq, delta = dq_runs[0]
        torch.testing.assert_close(dq.cpu().float(), pdq.float(), rtol=1e-2,
                                   atol=1e-2)
        want_delta = (gc.float() * got.float()).sum(-1).transpose(1, 2)
        torch.testing.assert_close(delta, want_delta, rtol=1e-5, atol=1e-4)
        assert all(torch.equal(a, b) for a, b in zip(*dq_runs))
        runs = [ops.flash_bwd_dkv(qc, kc, vc, gc, lse, delta, True,
                                  shape[3] ** -0.5) for _ in range(2)]
        for x, y in zip(runs[0], (pdk, pdv)):
            torch.testing.assert_close(x.cpu().float(), y.float(),
                                       rtol=1e-2, atol=1e-2)
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        after = ops.tc_launch_counts()
        assert after['flash_fwd'] == tc['flash_fwd'] + 1
        assert after['flash_bwd_dq'] == tc['flash_bwd_dq'] + 2
        assert after['flash_bwd_dkv'] == tc['flash_bwd_dkv'] + 2


@pytest.mark.cuda
def test_paged_decode_kernel_matches_plain_on_the_card(cuda):
    """The paged decode kernel against its plain version, and bit-equal
    to the slot decode kernel over the same pages gathered into a
    contiguous cache; dead table entries hold a page id outside the pool
    (never read)."""
    rng = np.random.RandomState(14)
    n_pages, ps, h, d = 20, 8, 8, 64
    k = torch.from_numpy(rng.randn(n_pages, ps, h, d).astype(np.float32))
    v = torch.from_numpy(rng.randn(n_pages, ps, h, d).astype(np.float32))
    q = torch.from_numpy(rng.randn(3, h, d).astype(np.float32))
    lens = torch.tensor([1, 30, 17], dtype=torch.int32)
    live = torch.tensor([[7, 0, 0, 0], [3, 12, 5, 9], [1, 19, 2, 0]],
                        dtype=torch.int32)
    dead = torch.where(live == 0, 1000, live).to(torch.int32)
    dead[1:, 0] = live[1:, 0]
    for dtype in (torch.float32, torch.bfloat16):
        want = ops.flash_attention_decode_paged(
            q.to(dtype), k.to(dtype), v.to(dtype), live, lens)
        kc, vc, qc = (x.to(dtype).cuda() for x in (k, v, q))
        got = ops.flash_attention_decode_paged(qc, kc, vc, dead.cuda(),
                                               lens.cuda())
        torch.testing.assert_close(got.cpu().float(), want.float(),
                                   rtol=1e-2, atol=1e-2)
        slot = ops.flash_attention_decode(
            qc, fa._gather_pages(kc, live.cuda()),
            fa._gather_pages(vc, live.cuda()), lens.cuda())
        assert torch.equal(slot, got)
    assert fa.flash_decode_paged.launches > 0
