"""The split order of the decode kernels (``flash_decode_split_kernel``,
behind ``cmn_flash_decode`` and ``cmn_flash_decode_paged`` in
``chainermn_tpu_torch/csrc/flash_attention.cu``) against the JAX
package's ``ops.flash_attention_decode`` and
``ops.flash_attention_decode_paged``, run as the JAX package's own tests
run them (the ``fallback`` and ``interpret`` modes).

The CUDA kernel runs only on the card.  Its order is written out here in
PyTorch ops on the CPU: the key axis cut into splits of ``DECODE_SPLIT``
positions (the kernel's ``kSplit``, a function of the position alone);
per split, the f32 scores of the pre-scaled query (an int8 K scale
multiplies the score), the split's max ``m``, ``p = exp(s - m)``, ``l =
sum p`` and ``acc = sum p * v_scale * v``, with positions at or past the
row's length never loaded; then the row's live splits merged in split
order: ``M = max m_j``, ``l = sum l_j exp(m_j - M)``, ``acc`` likewise,
``out = acc / max(l, 1e-30)``, rounded once to the query's dtype.  The
paged form reads each live position through the row's page table and
is otherwise the slot form, so the two give equal bits.

Tolerances: bf16 outputs at ``BF16_TOL = (2**-7, 1e-5)`` (f32 inside
both, rounded once: at most one bf16 rounding flip); f32 and int8 (f32
queries, dequantized in f32) at 1e-5 (f32 sums in another order), the
holds ``chip_smoke.py`` puts on the kernels against their plain versions
on the card.
"""

import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops

fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')

torch.set_num_threads(2)

BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)
F32_TOL = dict(rtol=1e-5, atol=1e-5)
KSPLIT = fa.DECODE_SPLIT
# a cache depth that is no multiple of the split, and lengths on both
# sides of the split boundaries: 1, kSplit - 1, kSplit, kSplit + 1, a
# multiple of kSplit, and S
S = 3 * KSPLIT + 8
LENGTHS = [1, KSPLIT - 1, KSPLIT, KSPLIT + 1, 2 * KSPLIT, S]
KINDS = ['float32', 'bfloat16', 'int8']


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


# ---------------------------------------------------------------------
# the split order

def _pad_split(x):
    """Zero-pad axis 1 to whole splits: a block always spans kSplit
    positions, the dead ones never loaded (zero)."""
    pad = (-x.shape[1]) % KSPLIT
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])], 1)


def split_model(q, k, v, lengths, scale, k_scale=None, v_scale=None):
    """The decode kernels' order: ``q`` ``(N, H, D)``; ``k`` / ``v``
    ``(N, S, H, D)``, each row's positions in order (int8 with ``(N, S,
    H)`` scales); ``lengths`` ``(N,)``.  Returns the f32 ``(N, H, D)``
    output before its rounding."""
    n, _, h, d = k.shape
    k, v = _pad_split(k.float()), _pad_split(v.float())
    if k_scale is not None:
        k_scale, v_scale = _pad_split(k_scale), _pad_split(v_scale)
    qs = q.float() * scale
    lens = lengths.long()
    parts = []
    for p0 in range(0, k.shape[1], KSPLIT):
        blk = slice(p0, p0 + KSPLIT)
        live = (p0 + torch.arange(KSPLIT))[None, None, :] < lens[:, None,
                                                                 None]
        kj = torch.where(live[..., None], k[:, blk].transpose(1, 2), 0.)
        vj = torch.where(live[..., None], v[:, blk].transpose(1, 2), 0.)
        s = torch.einsum('nhd,nhkd->nhk', qs, kj)          # (N, H, kSplit)
        if k_scale is not None:
            s = s * torch.where(live, k_scale[:, blk].transpose(1, 2), 1.)
        s = torch.where(live, s, fa.NEG_INF)
        m = s.amax(-1)
        p = torch.where(live, torch.exp(s - m[..., None]), 0.)
        l = p.sum(-1)
        if v_scale is not None:
            p = p * torch.where(live, v_scale[:, blk].transpose(1, 2), 1.)
        acc = torch.einsum('nhk,nhkd->nhd', p, vj)
        parts.append((m, l, acc, p0 < torch.clamp_min(lens, 1)))
    return merge_splits(parts)


def merge_splits(parts):
    """``(m, l, acc, alive)`` of each split in split order -> the merged
    output; a row's dead splits (``alive`` False) take no part."""
    big = torch.stack([torch.where(alive[:, None], m, fa.NEG_INF)
                       for m, _, _, alive in parts]).amax(0)
    l_tot = torch.zeros_like(big)
    acc_tot = torch.zeros_like(parts[0][2])
    for m, l, acc, alive in parts:
        w = torch.where(alive[:, None], torch.exp(m - big), 0.)
        l_tot = l_tot + l * w
        acc_tot = acc_tot + acc * w[..., None]
    return acc_tot / torch.clamp_min(l_tot, 1e-30)[..., None]


def slot_model(q, k, v, lengths, scale, k_scale=None, v_scale=None,
               slots=None):
    """The slot form: row i reads cache slot ``slots[i]`` (or i)."""
    if slots is not None:
        pick = slots.long()
        k, v = k[pick], v[pick]
        if k_scale is not None:
            k_scale, v_scale = k_scale[pick], v_scale[pick]
    return split_model(q, k, v, lengths, scale, k_scale, v_scale)


def _read_live(pool, tables, lengths):
    """Each row's positions in order, read through its page table at the
    live positions only (no table entry at or past ``ceil(length / ps)``
    is read); the dead positions are zero."""
    n, n_max = tables.shape
    ps = pool.shape[1]
    live = (torch.arange(n_max * ps)[None, :]
            < lengths.long()[:, None])
    rows, pos = live.nonzero(as_tuple=True)
    out = pool.new_zeros((n, n_max * ps) + pool.shape[2:])
    out[rows, pos] = pool[tables[rows, pos // ps].long(), pos % ps]
    return out


def paged_model(q, k, v, tables, lengths, scale, k_scale=None,
                v_scale=None):
    """The paged form: position p of row i at page ``tables[i, p //
    ps]``, offset ``p % ps``."""
    read = lambda x: None if x is None else _read_live(  # noqa: E731
        x, tables, lengths)
    return split_model(q, read(k), read(v), lengths, scale, read(k_scale),
                       read(v_scale))


# ---------------------------------------------------------------------
# inputs

def _rounded(a, dtype):
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


def _values(rng, shape, kind):
    """Cache values of ``kind`` as numpy: bf16-valued f32, f32, or int8
    with f32 scales ``shape[:-1]``."""
    if kind == 'int8':
        return (rng.randint(-127, 128, shape).astype(np.int8),
                rng.uniform(0.005, 0.03, shape[:-1]).astype(np.float32))
    x = rng.randn(*shape).astype(np.float32)
    return (_rounded(x, jnp.bfloat16) if kind == 'bfloat16' else x), None


def _q(rng, rows, h, d, kind):
    q = rng.randn(rows, h, d).astype(np.float32)
    return _rounded(q, jnp.bfloat16) if kind == 'bfloat16' else q


def _t(a, kind=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if kind == 'bfloat16' else t


def _j(a, kind=None):
    return jnp.asarray(a, jnp.bfloat16 if kind == 'bfloat16' else None)


def _scales(ks, vs, wrap):
    return {} if ks is None else dict(k_scale=wrap(ks), v_scale=wrap(vs))


def _pool(rows, h, d, ps, kind, seed):
    """q, a page pool, and each row's pages as a shuffled draw; the
    tables' dead entries point at garbage pages inside the pool
    (``tables``) or outside it (``outside``)."""
    rng = np.random.RandomState(seed)
    q = _q(rng, rows, h, d, kind)
    n_max = -(-S // ps) + 1
    n_pages = 1 + rows * n_max + 4
    k, ks = _values(rng, (n_pages, ps, h, d), kind)
    v, vs = _values(rng, (n_pages, ps, h, d), kind)
    pages = rng.permutation(np.arange(1, n_pages))
    tables = np.zeros((rows, n_max), np.int32)
    live = np.zeros((rows, n_max), bool)
    for i, n in enumerate(LENGTHS[:rows]):
        n_live = -(-n // ps)
        tables[i, :n_live] = pages[i * n_max:i * n_max + n_live]
        live[i, :n_live] = True
    garbage = pages[rows * n_max:]
    tables[~live] = rng.choice(garbage, int((~live).sum()))
    outside = np.where(live, tables, n_pages + 1000).astype(np.int32)
    return q, (k, ks), (v, vs), tables, outside


def _check(got, want, kind):
    np.testing.assert_allclose(got, want, **(BF16_TOL if kind == 'bfloat16'
                                             else F32_TOL))


def _out(x, kind):
    """The model's f32 output rounded once to the query's dtype."""
    return x.to(torch.bfloat16).float().numpy() if kind == 'bfloat16' \
        else x.numpy()


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


# ---------------------------------------------------------------------
# CPU: the model against the JAX package, and its two forms

def test_split_is_the_kernels():
    """``DECODE_SPLIT`` is the kernel's ``kSplit`` (one number, named in
    the kernel source and beside its wrapper)."""
    src = (Path(fa.__file__).resolve().parent.parent / 'csrc'
           / 'flash_attention.cu').read_text()
    found = re.findall(r'constexpr int kSplit = (\d+);', src)
    assert found == [str(KSPLIT)]
    assert S % KSPLIT and LENGTHS[-1] == S


@pytest.mark.parametrize('d', [32, 64, 128])
@pytest.mark.parametrize('kind', KINDS)
def test_split_model_matches_jax_decode(mode, kind, d):
    rows, h = len(LENGTHS), 2
    rng = np.random.RandomState(d)
    q = _q(rng, rows, h, d, kind)
    k, ks = _values(rng, (rows, S, h, d), kind)
    v, vs = _values(rng, (rows, S, h, d), kind)
    lens = np.asarray(LENGTHS, np.int32)
    want = jops.flash_attention_decode(
        _j(q, kind), _j(k, kind), _j(v, kind), jnp.asarray(lens),
        **_scales(ks, vs, jnp.asarray))
    got = slot_model(_t(q, kind), _t(k, kind), _t(v, kind), _t(lens),
                     d ** -0.5, **_scales(ks, vs, _t))
    _check(_out(got, kind), _np(want), kind)
    # the port's plain version (the CPU route of the public op) agrees too
    plain = ops.flash_attention_decode(_t(q, kind), _t(k, kind),
                                       _t(v, kind), _t(lens),
                                       **_scales(ks, vs, _t))
    _check(_out(got, kind), plain.float().numpy(), kind)


@pytest.mark.parametrize('d', [32, 64, 128])
@pytest.mark.parametrize('kind', KINDS)
def test_split_model_matches_jax_paged_decode(mode, kind, d):
    rows, h, ps = len(LENGTHS), 2, 32
    q, (k, ks), (v, vs), tables, outside = _pool(rows, h, d, ps, kind,
                                                 100 + d)
    lens = np.asarray(LENGTHS, np.int32)
    want = jops.flash_attention_decode_paged(
        _j(q, kind), _j(k, kind), _j(v, kind), jnp.asarray(tables),
        jnp.asarray(lens), **_scales(ks, vs, jnp.asarray))
    # the model follows only live entries: dead ones point outside the pool
    got = paged_model(_t(q, kind), _t(k, kind), _t(v, kind), _t(outside),
                      _t(lens), d ** -0.5, **_scales(ks, vs, _t))
    _check(_out(got, kind), _np(want), kind)


@pytest.mark.parametrize('d', [32, 64, 128])
@pytest.mark.parametrize('kind', KINDS)
def test_slot_and_paged_forms_are_bit_equal(kind, d):
    """Over shuffled pages, with dead table entries outside the pool, the
    paged form gives the slot form's bits over the same K/V laid out as a
    slot cache (garbage past each length, rows in a shuffled slot
    order)."""
    rows, h, ps = len(LENGTHS), 2, 16
    q, (k, ks), (v, vs), _, outside = _pool(rows, h, d, ps, kind, 200 + d)
    lens = _t(np.asarray(LENGTHS, np.int32))
    tq, tk, tv = _t(q, kind), _t(k, kind), _t(v, kind)
    paged = paged_model(tq, tk, tv, _t(outside), lens, d ** -0.5,
                        **_scales(ks, vs, _t))
    # the slot cache: each row's pages gathered, garbage past the length,
    # the rows stored in shuffled slots
    n_max = outside.shape[1]
    safe = torch.where(_t(outside) < k.shape[0], _t(outside), 0)
    gather = lambda x: x[safe.long()].reshape(  # noqa: E731
        (rows, n_max * ps) + x.shape[2:])
    perm = torch.from_numpy(np.random.RandomState(d).permutation(rows + 3))
    slots = perm[:rows].to(torch.int32)

    def cache(x):
        g = gather(x)
        full = torch.full((rows + 3,) + g.shape[1:], 7, dtype=x.dtype)
        full[slots.long()] = g
        return full

    scales = {} if ks is None else dict(k_scale=cache(_t(ks)),
                                        v_scale=cache(_t(vs)))
    slot = slot_model(tq, cache(tk), cache(tv), lens, d ** -0.5,
                      slots=slots, **scales)
    assert torch.equal(slot, paged)
    again = paged_model(tq, tk, tv, _t(outside), lens, d ** -0.5,
                        **_scales(ks, vs, _t))
    assert torch.equal(again, paged)


@pytest.mark.parametrize('length', [1, KSPLIT - 1, KSPLIT])
def test_a_row_of_one_split_writes_the_split_itself(length):
    """A row with one live split: the kernel writes ``acc / max(l,
    1e-30)`` of that split directly, which is the merge of one (weight
    ``exp(m - m) = 1``)."""
    rng = np.random.RandomState(length)
    q = _t(_q(rng, 1, 2, 64, 'float32'))
    k, _ = _values(rng, (1, S, 2, 64), 'float32')
    v, _ = _values(rng, (1, S, 2, 64), 'float32')
    lens = torch.tensor([length], dtype=torch.int32)
    merged = split_model(q, _t(k), _t(v), lens, 0.125)
    live = torch.arange(KSPLIT)[None, :] < length
    s = torch.einsum('nhd,nkhd->nhk', q * 0.125, _t(k)[:, :KSPLIT])
    s = torch.where(live[:, None], s, fa.NEG_INF)
    m = s.amax(-1)
    p = torch.where(live[:, None], torch.exp(s - m[..., None]), 0.)
    acc = torch.einsum('nhk,nkhd->nhd', p, _t(v)[:, :KSPLIT])
    direct = acc / torch.clamp_min(p.sum(-1), 1e-30)[..., None]
    np.testing.assert_allclose(merged.numpy(), direct.numpy(), **F32_TOL)
    one = merge_splits([(m, p.sum(-1), acc, torch.tensor([True]))])
    assert torch.equal(one, direct)


# ---------------------------------------------------------------------
# the card: the kernels against their plain versions and the model

def _card_cases():
    """(lengths, S, ps): the serving engine's live lengths (32 rows,
    65-96, S 512, page size 16) and the split boundaries."""
    rng = np.random.RandomState(5)
    engine = rng.randint(65, 97, 32).astype(np.int32)
    return [(engine, 512, 16), (np.asarray(LENGTHS, np.int32), S, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize('d', [32, 64, 128])
@pytest.mark.parametrize('kind', KINDS)
def test_kernels_match_plain_and_model_on_the_card(cuda, kind, d):
    h = 8 if d == 64 else 2
    for lengths, s, ps in _card_cases():
        rows = len(lengths)
        rng = np.random.RandomState(s + d)
        q = _t(_q(rng, rows, h, d, kind), kind).cuda()
        k, ks = _values(rng, (rows, s, h, d), kind)
        v, vs = _values(rng, (rows, s, h, d), kind)
        tk, tv = _t(k, kind).cuda(), _t(v, kind).cuda()
        sc = _scales(ks, vs, lambda a: _t(a).cuda())
        lens = _t(lengths).cuda()
        runs = [ops.flash_decode(q, tk, tv, lens, d ** -0.5, **sc)
                for _ in range(2)]
        assert torch.equal(runs[0], runs[1])
        plain = fa._decode_plain(q.cpu(), tk.cpu(), tv.cpu(), lens.cpu(),
                                 d ** -0.5, *(_t(a) if a is not None
                                              else None for a in (ks, vs)),
                                 None)
        _check(runs[0].float().cpu().numpy(), plain.float().numpy(), kind)
        model = slot_model(q.cpu(), tk.cpu(), tv.cpu(), lens.cpu(),
                           d ** -0.5, **{key: val.cpu()
                                         for key, val in sc.items()})
        _check(runs[0].float().cpu().numpy(), _out(model, kind), kind)
        # the same cache as a pool of ps-position pages in shuffled order,
        # dead table entries outside the pool: the slot kernel's bits
        n_max = -(-s // ps)
        perm = torch.randperm(rows * n_max,
                              generator=torch.Generator().manual_seed(d))
        pool = lambda x: x.reshape(  # noqa: E731
            (rows * n_max, ps) + x.shape[2:])[perm.argsort().cuda()]
        tables = perm.reshape(rows, n_max).to(torch.int32).cuda()
        live = (torch.arange(n_max, device='cuda')[None, :] * ps
                < lens[:, None])
        outside = torch.where(live, tables, rows * n_max + 1000).to(
            torch.int32)
        paged = ops.flash_decode_paged(
            q, pool(tk), pool(tv), outside, lens, d ** -0.5,
            **{key: pool(val) for key, val in sc.items()})
        assert torch.equal(paged, runs[0])
