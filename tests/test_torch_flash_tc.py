"""The rounding model of the tensor-core flash kernels (the bf16 routes
of ``cmn_flash_fwd``, ``cmn_flash_bwd_dq`` and ``cmn_flash_bwd_dkv`` in
``chainermn_tpu_torch/csrc/flash_attention.cu``) against the JAX
package's ``ops.flash_attention`` and its gradient, run as the JAX
package's own tests run them (the ``fallback`` and ``interpret`` modes);
and the wrapper's alignment helper.

The CUDA kernels run only on the card.  What they round, and where, is
written out here in PyTorch ops on the CPU, at the kernels' tile sizes:
bf16 operands, f32 products (a bf16 x bf16 product is exact in f32, so
``Q.K^T``, ``V.G^T`` and ``K.Q^T`` on ``mma`` match the widened f32
products), the softmax scale applied to the f32 scores after the
product, and the second products' 16-bit operand -- ``p`` in the
forward, ``ds`` in dq, ``p`` and ``ds`` in dk/dv -- split into ``hi =
bf16(x)`` and ``lo = bf16(x - hi)``, each multiplied on its own and
summed in f32.  The dq kernel forms ``delta = rowsum(g * out)`` itself,
in f32, from its g and out tiles.

Tolerances: the bf16 outputs of the model and of the JAX package (f32
inside, rounded once) at ``BF16_TOL = (2**-7, 1e-5)``, the holds
``chip_smoke.py`` puts on the kernels against their plain versions on
the card; ``lse`` at rtol 1e-5, atol 1e-4.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import models, precision, serving

fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')
jfa = importlib.import_module('chainermn_tpu.ops.flash_attention')

torch.set_num_threads(2)

BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
# the kernels' tiles: 64 keys a forward or dq tile, 64 query rows a dk/dv
# tile (32 at D = 128)
FWD_KEYS = 64
DQ_KEYS = 64


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


# ---------------------------------------------------------------------
# the rounding model

def _split(x, split):
    """The 16-bit operand of a second product: ``hi`` and ``lo`` (or one
    bf16 rounding with ``split=False``), as f32 values."""
    hi = x.to(torch.bfloat16).float()
    if not split:
        return (hi,)
    return hi, (x - hi).to(torch.bfloat16).float()


def _merged(x):
    return fa._merge(x).float()


def fwd_model(q, k, v, causal, scale, split=True):
    """The tensor-core forward's arithmetic: returns ``(out f32 before
    its rounding, lse)``, ``(B, Tq, H, D)`` and ``(B, H, Tq)``."""
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    qm, km, vm = _merged(q), _merged(k), _merged(v)
    m = torch.full((b * h, t_q), fa.NEG_INF)
    l = torch.zeros((b * h, t_q))
    acc = torch.zeros((b * h, t_q, d))
    q_pos = torch.arange(t_q)[:, None]
    for k0 in range(0, t_kv, FWD_KEYS):
        kj, vj = km[:, k0:k0 + FWD_KEYS], vm[:, k0:k0 + FWD_KEYS]
        s = torch.einsum('bqd,bkd->bqk', qm, kj) * scale
        if causal:
            k_pos = k0 + torch.arange(kj.shape[1])[None]
            s = torch.where(q_pos >= k_pos, s, fa.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        pv = sum(torch.einsum('bqk,bkd->bqd', part, vj)
                 for part in _split(p, split))
        acc = acc * alpha[..., None] + pv
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    out = (acc / l_safe[..., None]).reshape(b, h, t_q, d).transpose(1, 2)
    return out, (m + torch.log(l_safe)).reshape(b, h, t_q)


def dkv_model(q, k, v, g, out, lse, causal, scale, split=True):
    """The tensor-core dk/dv kernel's arithmetic: returns ``(dk, dv)`` f32
    before their rounding, ``(B, Tkv, H, D)``."""
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    qm, km, vm, gm = _merged(q), _merged(k), _merged(v), _merged(g)
    delta = (gm * _merged(out)).sum(-1)
    lse = lse.reshape(b * h, t_q)
    tile = 32 if d == 128 else 64
    dk = torch.zeros((b * h, t_kv, d))
    dv = torch.zeros((b * h, t_kv, d))
    k_pos = torch.arange(t_kv)[None]
    for q0 in range(0, t_q, tile):
        qj, gj = qm[:, q0:q0 + tile], gm[:, q0:q0 + tile]
        s = torch.einsum('bqd,bkd->bqk', qj, km) * scale
        if causal:
            q_pos = q0 + torch.arange(qj.shape[1])[:, None]
            s = torch.where(q_pos >= k_pos, s, fa.NEG_INF)
        p = torch.exp(s - lse[:, q0:q0 + tile, None])
        dp = torch.einsum('bqd,bkd->bqk', gj, vm)
        ds = p * (dp - delta[:, q0:q0 + tile, None])
        dv += sum(torch.einsum('bqk,bqd->bkd', part, gj)
                  for part in _split(p, split))
        dk += sum(torch.einsum('bqk,bqd->bkd', part, qj)
                  for part in _split(ds, split))
    dk = dk * scale
    return tuple(x.reshape(b, h, t_kv, d).transpose(1, 2) for x in (dk, dv))


def dq_model(q, k, v, g, out, lse, causal, scale, split=True):
    """The tensor-core dq kernel's arithmetic: returns ``(dq f32 before
    its rounding (B, Tq, H, D), delta (B, H, Tq))``, with ``delta`` formed
    as the kernel's prologue forms it."""
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    qm, km, vm, gm = _merged(q), _merged(k), _merged(v), _merged(g)
    delta = (gm * _merged(out)).sum(-1)
    lse = lse.reshape(b * h, t_q)
    dq = torch.zeros((b * h, t_q, d))
    q_pos = torch.arange(t_q)[:, None]
    for k0 in range(0, t_kv, DQ_KEYS):
        kj, vj = km[:, k0:k0 + DQ_KEYS], vm[:, k0:k0 + DQ_KEYS]
        s = torch.einsum('bqd,bkd->bqk', qm, kj) * scale
        if causal:
            k_pos = k0 + torch.arange(kj.shape[1])[None]
            s = torch.where(q_pos >= k_pos, s, fa.NEG_INF)
        p = torch.exp(s - lse[..., None])
        dp = torch.einsum('bqd,bkd->bqk', gm, vj)
        ds = p * (dp - delta[..., None])
        dq += sum(torch.einsum('bqk,bkd->bqd', part, kj)
                  for part in _split(ds, split))
    dq = (dq * scale).reshape(b, h, t_q, d).transpose(1, 2)
    return dq, delta.reshape(b, h, t_q)


# ---------------------------------------------------------------------
# inputs

def _bf16_values(rng, shape, mul=1.0):
    """numpy f32 values that bf16 holds exactly."""
    x = (rng.randn(*shape) * mul).astype(np.float32)
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _operands(shape, t_kv, seed, adversarial=False):
    """q, k, v, g as bf16-valued numpy arrays.  ``adversarial``: scores
    spread over about +-30 (q scaled up) and near-tied rows (keys
    repeated exactly, and others within one bf16 step of a neighbour)."""
    b, t_q, h, d = shape
    rng = np.random.RandomState(seed)
    q = _bf16_values(rng, shape, 7.0 if adversarial else 1.0)
    k = _bf16_values(rng, (b, t_kv, h, d))
    v = _bf16_values(rng, (b, t_kv, h, d))
    g = _bf16_values(rng, shape)
    if adversarial:
        n = k[:, 3::5].shape[1]                   # one bf16 step apart
        k[:, 3::5] = k[:, 2::5][:, :n] * np.float32(1 + 2 ** -7)
        k[:, 1::7] = k[:, 0:1]                    # exact ties with key 0
        k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
    return q, k, v, g


def _torch(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _jax(a, dtype=jnp.bfloat16):
    return jnp.asarray(a, dtype)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _as_bf16(x):
    return x.to(torch.bfloat16).float().numpy()


# (B, Tq, H, D), Tkv, causal: every head width; ragged T across the
# 64-row and 64-key tiles (65, 130); non-causal with Tq != Tkv
CASES = [((1, 130, 2, 32), 130, True),
         ((2, 65, 2, 64), 65, True),
         ((2, 77, 2, 64), 150, False),
         ((1, 130, 2, 128), 130, True),
         ((1, 40, 2, 128), 90, False)]


def _jax_lse(jq, jk, jv, causal, scale):
    """``lse`` from the JAX package's internal forward, padded the way
    its public wrapper pads."""
    b, t_q, h, d = jq.shape
    t_kv = jk.shape[1]
    bq, bk = min(128, t_q), min(128, t_kv)

    def merge(x, blk):
        t = x.shape[1]
        x = jnp.swapaxes(x, 1, 2).reshape(b * h, t, d)
        return jnp.pad(x, ((0, 0), (0, (-t) % blk), (0, 0)))

    _, (_, _, _, _, lse) = jfa._flash_fwd(merge(jq, bq), merge(jk, bk),
                                          merge(jv, bk), causal, scale,
                                          t_kv, bq, bk)
    return np.asarray(lse)[:, :t_q].reshape(b, h, t_q)


def _check_forward(shape, t_kv, causal, seed, adversarial=False):
    q, k, v, _ = _operands(shape, t_kv, seed, adversarial)
    scale = shape[3] ** -0.5
    jq, jk, jv = _jax(q), _jax(k), _jax(v)
    want = jops.flash_attention(jq, jk, jv, causal=causal)
    out, lse = fwd_model(_torch(q), _torch(k), _torch(v), causal, scale)
    np.testing.assert_allclose(_as_bf16(out), _np(want), **BF16_TOL)
    np.testing.assert_allclose(lse.numpy(),
                               _jax_lse(jq, jk, jv, causal, scale),
                               rtol=1e-5, atol=1e-4)


def _check_dkv(shape, t_kv, causal, seed, adversarial=False):
    q, k, v, g = _operands(shape, t_kv, seed, adversarial)
    scale = shape[3] ** -0.5
    jq, jk, jv = _jax(q), _jax(k), _jax(v)
    out, vjp = jax.vjp(
        lambda a, b, c: jops.flash_attention(a, b, c, causal=causal),
        jq, jk, jv)
    _, want_dk, want_dv = vjp(_jax(g))
    _, lse = fwd_model(_torch(q), _torch(k), _torch(v), causal, scale)
    dk, dv = dkv_model(_torch(q), _torch(k), _torch(v), _torch(g),
                       _torch(_np(out)), lse, causal, scale)
    np.testing.assert_allclose(_as_bf16(dv), _np(want_dv), err_msg='dv',
                               **BF16_TOL)
    np.testing.assert_allclose(_as_bf16(dk), _np(want_dk), err_msg='dk',
                               **BF16_TOL)


def _check_dq(shape, t_kv, causal, seed, adversarial=False):
    q, k, v, g = _operands(shape, t_kv, seed, adversarial)
    scale = shape[3] ** -0.5
    jq, jk, jv = _jax(q), _jax(k), _jax(v)
    out, vjp = jax.vjp(
        lambda a, b, c: jops.flash_attention(a, b, c, causal=causal),
        jq, jk, jv)
    want_dq, _, _ = vjp(_jax(g))
    _, lse = fwd_model(_torch(q), _torch(k), _torch(v), causal, scale)
    tout = _torch(_np(out))
    dq, delta = dq_model(_torch(q), _torch(k), _torch(v), _torch(g), tout,
                         lse, causal, scale)
    np.testing.assert_allclose(_as_bf16(dq), _np(want_dq), err_msg='dq',
                               **BF16_TOL)
    # delta: the f32 rowsum of the bf16 g and out, (B, H, Tq) as lse
    want_delta = np.einsum('bqhd,bqhd->bhq', g, _np(out))
    np.testing.assert_allclose(delta.numpy(), want_delta, rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('shape,t_kv,causal', CASES)
def test_forward_model_matches_jax(mode, shape, t_kv, causal):
    _check_forward(shape, t_kv, causal, 0)


@pytest.mark.parametrize('shape,t_kv,causal', CASES)
def test_dkv_model_matches_jax(mode, shape, t_kv, causal):
    _check_dkv(shape, t_kv, causal, 1)


@pytest.mark.parametrize('shape,t_kv,causal', CASES)
def test_dq_model_matches_jax(mode, shape, t_kv, causal):
    _check_dq(shape, t_kv, causal, 5)


@pytest.mark.parametrize('d', [64, 128])
def test_dq_model_matches_jax_adversarial(mode, d):
    _check_dq((1, 130, 2, d), 130, True, 6, adversarial=True)


@pytest.mark.parametrize('d', [64, 128])
def test_forward_model_matches_jax_adversarial(mode, d):
    _check_forward((1, 130, 2, d), 130, True, 2, adversarial=True)


@pytest.mark.parametrize('d', [64, 128])
def test_dkv_model_matches_jax_adversarial(mode, d):
    _check_dkv((1, 130, 2, d), 130, True, 3, adversarial=True)


def test_adversarial_scores_are_wide_and_tied():
    q, k, _, _ = _operands((1, 130, 2, 64), 130, 2, adversarial=True)
    s = np.einsum('bqhd,bkhd->bhqk', q, k) / 8
    assert s.max() > 25 and s.min() < -25
    assert (k[:, 1::7] == k[:, :1]).all()


def _f32_reference(q, k, v, g, causal, scale):
    """The JAX package in f32 on the bf16-valued operands: out, dk, dv
    before any bf16 rounding."""
    out, vjp = jax.vjp(
        lambda a, b, c: jops.flash_attention(a, b, c, causal=causal,
                                             scale=scale),
        *(_jax(x, jnp.float32) for x in (q, k, v)))
    _, dk, dv = vjp(_jax(g, jnp.float32))
    return _np(out), _np(dk), _np(dv)


@pytest.mark.parametrize('d', [64, 128])
def test_split_is_what_keeps_the_second_products_exact(d):
    """On the same inputs, ``p`` (and ``ds``) rounded once to bf16 gives
    at least 16 times the split's error in f32 (before the outputs' own
    rounding), in the forward's out and in dk and dv."""
    shape = (1, 130, 2, d)
    q, k, v, g = _operands(shape, 130, 4)
    scale = d ** -0.5
    ref_out, ref_dk, ref_dv = _f32_reference(q, k, v, g, True, scale)
    tq, tk, tv, tg = (_torch(x) for x in (q, k, v, g))
    errs = {}
    for split in (True, False):
        out, lse = fwd_model(tq, tk, tv, True, scale, split)
        # the backward's out: the f32 reference's own
        dk, dv = dkv_model(tq, tk, tv, tg, _torch(ref_out, torch.float32),
                           lse, True, scale, split)
        errs[split] = [float(np.abs(x.numpy() - r).max()) for x, r in
                       ((out, ref_out), (dk, ref_dk), (dv, ref_dv))]
    for name, one, two in zip(('out', 'dk', 'dv'), errs[False], errs[True]):
        assert one >= 16 * two, (name, one, two)


@pytest.mark.parametrize('d', [64, 128])
def test_split_is_what_keeps_dq_exact(d):
    """On the same inputs, ``ds`` rounded once to bf16 gives at least 16
    times the split's error in dq, in f32 before its own rounding."""
    shape = (1, 130, 2, d)
    q, k, v, g = _operands(shape, 130, 7)
    scale = d ** -0.5
    out, vjp = jax.vjp(
        lambda a, b, c: jops.flash_attention(a, b, c, causal=True,
                                             scale=scale),
        *(_jax(x, jnp.float32) for x in (q, k, v)))
    ref_dq = _np(vjp(_jax(g, jnp.float32))[0])
    tq, tk, tv, tg = (_torch(x) for x in (q, k, v, g))
    _, lse = fwd_model(tq, tk, tv, True, scale)
    errs = {}
    for split in (True, False):
        dq, _ = dq_model(tq, tk, tv, tg, _torch(_np(out), torch.float32),
                         lse, True, scale, split)
        errs[split] = float(np.abs(dq.numpy() - ref_dq).max())
    assert errs[False] >= 16 * errs[True], errs


# ---------------------------------------------------------------------
# the wrapper's alignment helper

def test_aligned_strided_views_pass_through_uncopied():
    qkv = torch.zeros((2, 9, 3, 4, 64), dtype=torch.bfloat16)
    for i in range(3):
        view = qkv.select(2, i)
        assert not view.is_contiguous()
        assert fa._rows16(view) is view


@pytest.mark.parametrize('how', ['offset', 'stride'])
def test_misaligned_operands_come_back_contiguous(how):
    b, t, h, d = 2, 9, 4, 64
    if how == 'offset':
        # rows start 2 bytes past a 16-byte boundary
        flat = torch.arange(1 + b * t * h * d, dtype=torch.float32)
        x = flat.to(torch.bfloat16)[1:].view(b, t, h, d)
    else:
        # a token stride of H * D + 4 elements: rows 8 bytes apart from
        # a 16-byte boundary
        base = torch.arange(b * t * (h * d + 4), dtype=torch.float32)
        x = base.to(torch.bfloat16).view(b, t, h * d + 4)[..., :h * d]
        x = x.view(b, t, h, d) if x.is_contiguous() else \
            x.unflatten(2, (h, d))
    assert not fa._aligned16(x)
    y = fa._rows16(x)
    assert y is not x and y.is_contiguous() and fa._aligned16(y)
    assert torch.equal(y, x)


def test_main_paths_hand_the_kernels_aligned_rows(monkeypatch):
    """The bf16 model's flash-forward operands -- training, whole and
    chunked paged prefill, the speculative verify window -- are the
    ``qkv.select`` views of one projection, 16-byte aligned: on the card
    the wrappers copy nothing (checked here where the CPU takes the
    plain forward with the same operands)."""
    seen = []
    plain = fa._fwd_plain

    def spy(q, k, v, causal, scale):
        seen.append([fa._aligned16(x) for x in (q, k, v)])
        return plain(q, k, v, causal, scale)

    monkeypatch.setattr(fa, '_fwd_plain', spy)
    cfg = dict(vocab_size=64, d_model=64, n_heads=2, d_ff=128, max_len=64,
               device='cpu')
    model = models.TransformerLM(n_layers=2, **cfg,
                                 generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, 64, (2, 40),
                           generator=torch.Generator().manual_seed(1))
    models.lm_loss(model)(tokens, tokens)[0].backward()
    draft = models.TransformerLM(n_layers=1, **cfg,
                                 generator=torch.Generator().manual_seed(2))
    for kw in (dict(prefill_chunk=None), dict(prefill_chunk=8)):
        eng = serving.GenerationEngine(
            model, n_slots=2, max_prompt_len=16, max_len=48, device='cpu',
            policy=precision.Policy.bf16(), paged=True, page_size=8,
            draft_model=draft, draft_params=models.param_tree(draft),
            spec_tokens=3, **kw)
        queue = serving.GenerationQueue(max_prompt_len=16, page_size=8)
        reqs = [queue.submit(np.arange(n) % 64, 6) for n in (5, 16)]
        while not all(r.done() for r in reqs):
            eng.step(queue)
    assert len(seen) > 10 and all(all(x) for x in seen), seen
