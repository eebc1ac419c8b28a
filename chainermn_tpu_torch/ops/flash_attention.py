"""Flash attention: the prefill forward with its backward, and the
single-query decode read of a slot KV cache.

Counterpart of ``chainermn_tpu/ops/flash_attention.py``.  The ops keep
the JAX package's online-softmax recurrence in float32 (running max
``m``, running sum ``l``, accumulator ``acc``; masked scores set to the
finite ``NEG_INF``; the output divided by ``max(l, 1e-30)``) and its
layouts: ``(B, T, H, D)`` activations, ``(B, S, H, D)`` caches.

- :func:`flash_attention` / :func:`flash_attention_fwd` (causal or not,
  padded keys masked by ``kv_len``, padded query rows dropped): on CUDA
  tensors the kernel ``cmn_flash_fwd`` of ``csrc/flash_attention.cu``
  (:func:`flash_fwd`), on CPU tensors the plain blockwise version
  (:func:`_fwd_blockwise`, the twin of the JAX ``_fwd_blockwise_jnp``).
  Both record a gradient: on CUDA tensors the backward launches the two
  kernels ``cmn_flash_bwd_dq`` (:func:`flash_bwd_dq`, which also forms
  ``delta = rowsum(g * out)``, left to XLA in the JAX package) and
  ``cmn_flash_bwd_dkv`` (:func:`flash_bwd_dkv`, which reads that
  ``delta``); on CPU tensors it runs the plain blockwise version
  (:func:`_bwd_blockwise`, the twin of the JAX one).
- :func:`flash_attention_decode` (one query row per sequence against its
  cache prefix, per-row lengths, float or int8 caches with per-(position,
  head) scales, an optional row -> slot map): on CUDA tensors the kernel
  ``cmn_flash_decode`` (:func:`flash_decode`), which reads the cache in
  place through its strides, a block per split of ``DECODE_SPLIT``
  positions, the splits merged in a fixed order; on CPU tensors the
  plain blockwise version (:func:`_decode_blockwise`), which gathers the
  rows first as the JAX package's ``_attend_cache`` does.  Forward only,
  as in the JAX package (decode is inference): it raises when asked to
  record a gradient.
- :func:`flash_attention_decode_paged` (the same read of a PAGED cache:
  a pool ``(P, page_size, H, D)`` shared by all sequences, addressed
  through per-row page tables): on CUDA tensors the kernel
  ``cmn_flash_decode_paged`` (:func:`flash_decode_paged`), the decode
  kernel with each position's address looked up in the row's table; on
  CPU tensors the plain version (:func:`_decode_paged_plain`, one page
  per row per step).  Forward only.
- :func:`flash_attention_chunk` (a prefill chunk or a speculative
  verify window against its banked context): the causal in-chunk half
  through :func:`flash_attention_fwd` (so ``cmn_flash_fwd`` on CUDA),
  the context half as a blockwise scan in PyTorch ops (as the JAX
  package leaves it to XLA), merged through the two log-sum-exps.
"""

import ctypes

import torch

from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._build import LIBRARIES
from chainermn_tpu_torch.ops._common import NEG_INF

#: key/query block of the plain blockwise versions (the JAX package's
#: default ``CHAINERMN_TPU_FA_BLOCK_Q`` / ``_K``)
BLOCK = 128
#: head widths the kernels are built for
HEAD_DIMS = (32, 64, 128)
#: dtype codes of the decode kernel's cache operand
KV_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: positions of the key axis one block of the decode kernels owns:
#: ``kSplit`` of ``csrc/flash_attention.cu`` (the wrappers size the
#: split workspace with it)
DECODE_SPLIT = 128


def _scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


# ---------------------------------------------------------------------
# plain versions

def mha_reference(q, k, v, causal=False, scale=None):
    """Plain oracle: full softmax attention, ``(B, T, H, D)`` in and
    out (the twin of the JAX ``mha_reference``)."""
    scale = _scale(q, scale)
    scores = torch.einsum('bqhd,bkhd->bhqk', q, k).float() * scale
    if causal:
        tq, tk = scores.shape[-2:]
        mask = (torch.arange(tq, device=q.device)[:, None]
                >= torch.arange(tk, device=q.device)[None, :])
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p.to(v.dtype), v)


def _fwd_blockwise(q, k, v, causal, scale, kv_len, block_k):
    """Plain forward over merged ``(BH, T, D)`` operands whose key
    length is a multiple of ``block_k``: the kernel's recurrence, one
    key block at a time.  Returns ``(out (BH, Tq, D) q.dtype, lse (BH,
    Tq) f32)``."""
    bh, t_q, d = q.shape
    t_kv = k.shape[1]
    qf = q.float() * scale
    m = torch.full((bh, t_q), NEG_INF, device=q.device)
    l = torch.zeros((bh, t_q), device=q.device)
    acc = torch.zeros((bh, t_q, d), device=q.device)
    q_pos = torch.arange(t_q, device=q.device)[:, None]
    for j in range(t_kv // block_k):
        kj = k[:, j * block_k:(j + 1) * block_k].float()
        vj = v[:, j * block_k:(j + 1) * block_k].float()
        s = torch.einsum('bqd,bkd->bqk', qf, kj)
        k_pos = j * block_k + torch.arange(block_k, device=q.device)[None]
        ok = k_pos < kv_len
        if causal:
            ok = ok & (q_pos >= k_pos)
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum('bqk,bkd->bqd', p, vj)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def decode_attention_reference(q, k, v, lengths, scale=None, k_scale=None,
                               v_scale=None):
    """Plain oracle of :func:`flash_attention_decode` (the twin of the
    JAX ``decode_attention_reference``): ``q`` ``(B, H, D)``, ``k`` /
    ``v`` ``(B, S, H, D)`` (int8 with ``(B, S, H)`` scales), positions
    ``>= lengths[b]`` masked; returns ``(B, H, D)`` in ``q.dtype``."""
    scale = _scale(q, scale)
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf = kf * k_scale.float()[..., None]
    if v_scale is not None:
        vf = vf * v_scale.float()[..., None]
    s = torch.einsum('bhd,bkhd->bhk', q.float(), kf) * scale
    k_pos = torch.arange(k.shape[1], device=q.device)
    ok = k_pos[None, None, :] < lengths.to(q.device)[:, None, None]
    p = torch.softmax(torch.where(ok, s, NEG_INF), dim=-1)
    return torch.einsum('bhk,bkhd->bhd', p, vf).to(q.dtype)


def _decode_blockwise(q, k, v, lengths, scale, block_k, k_scale=None,
                      v_scale=None):
    """Plain decode over merged operands: ``q`` ``(BH, D)``, ``k`` / ``v``
    ``(BH, S, D)`` with ``S`` a multiple of ``block_k``, scales ``(BH,
    S)``, ``lengths`` ``(BH,)``; the kernel's recurrence one key block
    at a time."""
    bh, t_kv, d = k.shape
    qf = q.float() * scale
    m = torch.full((bh,), NEG_INF, device=q.device)
    l = torch.zeros((bh,), device=q.device)
    acc = torch.zeros((bh, d), device=q.device)
    for j in range(t_kv // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        kj, vj = k[:, blk].float(), v[:, blk].float()
        if k_scale is not None:
            kj = kj * k_scale[:, blk, None]
            vj = vj * v_scale[:, blk, None]
        s = torch.einsum('bd,bkd->bk', qf, kj)
        k_pos = j * block_k + torch.arange(block_k, device=q.device)
        s = torch.where(k_pos[None, :] < lengths[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[:, None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[:, None] + torch.einsum('bk,bkd->bd', p, vj)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[:, None]).to(q.dtype)


def _gather_pages(x, tables):
    """Each row's pages of a pool ``(P, ps, ...)`` in position order:
    ``(B, n_max * ps, ...)`` for ``tables`` ``(B, n_max)``."""
    b, n_max = tables.shape
    g = x.index_select(0, tables.reshape(-1).long())
    return g.reshape((b, n_max * x.shape[1]) + x.shape[2:])


def decode_attention_paged_reference(q, k, v, page_tables, lengths,
                                     scale=None, k_scale=None, v_scale=None):
    """Plain oracle of :func:`flash_attention_decode_paged` (the twin of
    the JAX ``decode_attention_paged_reference``): gathers each row's
    pages into the contiguous ``(B, S, H, D)`` layout and defers to
    :func:`decode_attention_reference` -- paging is a storage
    indirection, never an arithmetic change."""
    return decode_attention_reference(
        q, _gather_pages(k, page_tables), _gather_pages(v, page_tables),
        lengths, scale=scale,
        k_scale=None if k_scale is None else _gather_pages(k_scale,
                                                           page_tables),
        v_scale=None if v_scale is None else _gather_pages(v_scale,
                                                           page_tables))


def _decode_paged_plain(q, k, v, page_tables, lengths, scale, k_scale=None,
                        v_scale=None):
    """Plain paged decode (the twin of the JAX
    ``_decode_paged_blockwise_jnp``): the kernel's online-softmax update
    over the page-table axis, gathering ONE page per row per step.  Dead
    entries (at or past ``ceil(lengths / ps)``) are not followed: a dead
    step reads page 0 and masks all of it."""
    b, h, d = q.shape
    ps = k.shape[1]
    n_max = page_tables.shape[1]
    lengths = lengths.to(torch.int64)
    tables = page_tables.to(torch.int64)
    qf = q.float() * scale
    m = torch.full((b, h), NEG_INF, device=q.device)
    l = torch.zeros((b, h), device=q.device)
    acc = torch.zeros((b, h, d), device=q.device)
    offsets = torch.arange(ps, device=q.device)
    for j in range(n_max):
        pages = torch.where(j * ps < lengths, tables[:, j], 0)
        kj = k.index_select(0, pages).float()            # (B, ps, H, D)
        vj = v.index_select(0, pages).float()
        if k_scale is not None:
            kj = kj * k_scale.index_select(0, pages).float()[..., None]
            vj = vj * v_scale.index_select(0, pages).float()[..., None]
        s = torch.einsum('bhd,bkhd->bhk', qf, kj)         # (B, H, ps)
        ok = (j * ps + offsets)[None, None, :] < lengths[:, None, None]
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum('bhk,bkhd->bhd', p, vj)
        m = m_new
    return (acc / torch.clamp_min(l, 1e-30)[..., None]).to(q.dtype)


def chunk_attention_reference(q, k_new, v_new, k_ctx, v_ctx, ctx_len,
                              scale=None, k_scale=None, v_scale=None):
    """Plain oracle of :func:`flash_attention_chunk` (the twin of the JAX
    ``chunk_attention_reference``): one softmax over the banked context
    (masked at ``ctx_len``) and the chunk itself (causal)."""
    scale = _scale(q, scale)
    c = q.shape[1]
    kcf, vcf = k_ctx.float(), v_ctx.float()
    if k_scale is not None:
        kcf = kcf * k_scale.float()[..., None]
        vcf = vcf * v_scale.float()[..., None]
    kf = torch.cat([kcf, k_new.float()], dim=1)
    vf = torch.cat([vcf, v_new.float()], dim=1)
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), kf) * scale
    s_ctx = k_ctx.shape[1]
    k_pos = torch.arange(s_ctx + c, device=q.device)[None, None, None, :]
    q_pos = torch.arange(c, device=q.device)[None, None, :, None]
    cl = ctx_len.to(q.device).long()[:, None, None, None]
    in_ctx = (k_pos < s_ctx) & (k_pos < cl)
    in_chunk = (k_pos >= s_ctx) & (k_pos - s_ctx <= q_pos)
    p = torch.softmax(torch.where(in_ctx | in_chunk, s, NEG_INF), dim=-1)
    return torch.einsum('bhqk,bkhd->bqhd', p, vf).to(q.dtype)


def _ctx_blockwise(q, k, v, ctx_len, scale, block_k, k_scale=None,
                   v_scale=None):
    """Non-causal blockwise attention of ``t_q`` query rows against a
    context masked by a per-row length: the chunk's context half (the
    twin of the JAX ``_ctx_blockwise_jnp``).  Merged operands: ``q``
    ``(BH, Tq, D)``, ``k`` / ``v`` ``(BH, S, D)`` with S a multiple of
    ``block_k``, scales ``(BH, S)``, ``ctx_len`` ``(BH,)``.  Returns
    ``(out in q.dtype, lse f32)``."""
    bh, t_q, d = q.shape
    qf = q.float() * scale
    m = torch.full((bh, t_q), NEG_INF, device=q.device)
    l = torch.zeros((bh, t_q), device=q.device)
    acc = torch.zeros((bh, t_q, d), device=q.device)
    for j in range(k.shape[1] // block_k):
        blk = slice(j * block_k, (j + 1) * block_k)
        kj, vj = k[:, blk].float(), v[:, blk].float()
        if k_scale is not None:
            kj = kj * k_scale[:, blk, None]
            vj = vj * v_scale[:, blk, None]
        s = torch.einsum('bqd,bkd->bqk', qf, kj)
        k_pos = j * block_k + torch.arange(block_k, device=q.device)
        s = torch.where(k_pos[None, None, :] < ctx_len[:, None, None], s,
                        NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum('bqk,bkd->bqd', p, vj)
        m = m_new
    l_safe = torch.clamp_min(l, 1e-30)
    return (acc / l_safe[..., None]).to(q.dtype), m + torch.log(l_safe)


def _merge(x):
    """``(B, T, H, ...)`` -> ``(B*H, T, ...)``."""
    x = x.transpose(1, 2)
    return x.reshape((x.shape[0] * x.shape[1],) + x.shape[2:])


def _pad_to(x, length):
    """Zero-pad axis 1 of a merged operand to ``length``."""
    if x.shape[1] == length:
        return x
    pad = x.new_zeros((x.shape[0], length - x.shape[1]) + x.shape[2:])
    return torch.cat([x, pad], dim=1)


def _fwd_plain(q, k, v, causal, scale):
    """The CPU forward: pad to the JAX package's blocks, merge heads,
    :func:`_fwd_blockwise`, drop the padded query rows, unmerge."""
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    block_q, block_k = min(BLOCK, t_q), min(BLOCK, t_kv)
    qm = _pad_to(_merge(q), -(-t_q // block_q) * block_q)
    n_k = -(-t_kv // block_k) * block_k
    km, vm = _pad_to(_merge(k), n_k), _pad_to(_merge(v), n_k)
    out, lse = _fwd_blockwise(qm, km, vm, causal, scale, t_kv, block_k)
    out = out[:, :t_q].reshape(b, h, t_q, d).transpose(1, 2)
    return out, lse[:, :t_q].reshape(b, h, t_q)


def _bwd_blockwise(q, k, v, out, lse, g, causal, scale, block_k):
    """Plain backward over merged ``(BH, T, D)`` operands, one key block
    at a time (the last one may be short): ``p`` recomputed from the
    forward's ``lse`` with the scores formed as :func:`_fwd_blockwise`
    forms them.  Returns ``(dq, dk, dv)`` in the operands' dtypes."""
    t_q, t_kv = q.shape[1], k.shape[1]
    qf, gf = q.float(), g.float()
    qs = qf * scale
    delta = (gf * out.float()).sum(-1)                       # (BH, Tq)
    dq = torch.zeros_like(qf)
    dk, dv = [], []
    q_pos = torch.arange(t_q, device=q.device)[:, None]
    for j0 in range(0, t_kv, block_k):
        kj = k[:, j0:j0 + block_k].float()
        vj = v[:, j0:j0 + block_k].float()
        s = torch.einsum('bqd,bkd->bqk', qs, kj)
        if causal:
            k_pos = j0 + torch.arange(kj.shape[1], device=q.device)[None]
            s = torch.where(q_pos >= k_pos, s, NEG_INF)
        p = torch.exp(s - lse[..., None])                    # (BH, Tq, bk)
        dp = torch.einsum('bqd,bkd->bqk', gf, vj)
        ds = p * (dp - delta[..., None]) * scale
        dq += torch.einsum('bqk,bkd->bqd', ds, kj)
        dk.append(torch.einsum('bqk,bqd->bkd', ds, qf))
        dv.append(torch.einsum('bqk,bqd->bkd', p, gf))
    return (dq.to(q.dtype), torch.cat(dk, dim=1).to(k.dtype),
            torch.cat(dv, dim=1).to(v.dtype))


def _bwd_plain(q, k, v, out, lse, g, causal, scale):
    """The CPU backward: merge heads, :func:`_bwd_blockwise`, unmerge."""
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    grads = _bwd_blockwise(_merge(q), _merge(k), _merge(v), _merge(out),
                           lse.reshape(b * h, t_q), _merge(g), causal, scale,
                           min(BLOCK, t_kv))
    return tuple(x.reshape(b, h, x.shape[1], d).transpose(1, 2)
                 for x in grads)


def _decode_plain(q, k, v, lengths, scale, k_scale, v_scale, slots):
    """The CPU decode: gather the rows' slots, merge heads, pad the
    cache axis to a block multiple, :func:`_decode_blockwise`."""
    if slots is not None:
        slots = slots.long()
        k, v = k.index_select(0, slots), v.index_select(0, slots)
        if k_scale is not None:
            k_scale = k_scale.index_select(0, slots)
            v_scale = v_scale.index_select(0, slots)
    b, h, d = q.shape
    s = k.shape[1]
    block_k = min(BLOCK, s)
    n_k = -(-s // block_k) * block_k
    km, vm = _pad_to(_merge(k), n_k), _pad_to(_merge(v), n_k)
    ksm = vsm = None
    if k_scale is not None:
        ksm = _pad_to(_merge(k_scale.float()), n_k)
        vsm = _pad_to(_merge(v_scale.float()), n_k)
    lengths_bh = lengths.to(torch.int64).repeat_interleave(h)
    out = _decode_blockwise(q.reshape(b * h, d), km, vm, lengths_bh, scale,
                            block_k, ksm, vsm)
    return out.reshape(b, h, d)


# ---------------------------------------------------------------------
# CUDA kernel wrappers

def _lib():
    lib = LIBRARIES.get('flash_attention')
    if not getattr(lib, '_cmn_typed', False):
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.cmn_flash_fwd.argtypes = (
            [vp, vp, vp, i32, i32] + [i64] * 9
            + [vp, vp, i32, i32, i32, i32, ctypes.c_float, i32, vp])
        lib.cmn_flash_fwd.restype = ctypes.c_int
        bwd = [vp, vp, vp, vp, i32, i32, ctypes.POINTER(i64), vp, vp]
        tail = [i32, i32, i32, i32, ctypes.c_float, i32, vp]
        lib.cmn_flash_bwd_dq.argtypes = bwd + [vp, vp] + tail
        lib.cmn_flash_bwd_dq.restype = ctypes.c_int
        lib.cmn_flash_bwd_dkv.argtypes = bwd + [vp, vp] + tail
        lib.cmn_flash_bwd_dkv.restype = ctypes.c_int
        scratch = [vp, i64, vp, i64, vp]   # workspace, tickets, stream
        lib.cmn_flash_decode.argtypes = (
            [vp, i32, i64, i64, vp, vp, i32] + [i64] * 6 + [vp, vp]
            + [i64] * 6 + [vp, vp, vp, i32, i32, i32, i32, ctypes.c_float]
            + scratch)
        lib.cmn_flash_decode.restype = ctypes.c_int
        lib.cmn_flash_decode_paged.argtypes = (
            [vp, i32, i64, i64, vp, vp, i32] + [i64] * 6 + [vp, vp]
            + [i64] * 6 + [vp, i32, i32, vp, vp, i32, i32, i32,
                           ctypes.c_float] + scratch)
        lib.cmn_flash_decode_paged.restype = ctypes.c_int
        lib.cmn_fa_strerror.argtypes = [ctypes.c_int]
        lib.cmn_fa_strerror.restype = ctypes.c_char_p
        lib._cmn_typed = True
    return lib


def _check_cuda(what, *tensors):
    for t in tensors:
        if t is not None and t.device.type != 'cuda':
            raise ValueError('%s: the kernel takes CUDA tensors, got %s'
                             % (what, t.device))


def _check_qkv(what, q, k, v, causal):
    """The checks every prefill kernel makes of its ``(B, T, H, D)``
    operands; returns ``(b, t_q, t_kv, h, d, dtype code)``."""
    _check_cuda(what, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError('%s: expects (B, T, H, D) operands, got %s %s %s'
                         % (what, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    b, t_q, h, d = q.shape
    t_kv = k.shape[1]
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError('%s: q %s and k %s disagree on B, H or D'
                         % (what, tuple(q.shape), tuple(k.shape)))
    if d not in HEAD_DIMS:
        raise ValueError('%s: head dim %d, the kernel takes %s'
                         % (what, d, HEAD_DIMS))
    if causal and t_q != t_kv:
        raise ValueError('causal attention requires t_q == t_kv, got %d '
                         'vs %d' % (t_q, t_kv))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError('%s: q, k, v must share a dtype, got %s %s %s'
                        % (what, q.dtype, k.dtype, v.dtype))
    code = _common.dtype_code(q, what)
    for t, name in ((q, 'q'), (k, 'k'), (v, 'v')):
        if t.stride(3) != 1:
            raise ValueError('%s: %s needs a contiguous head dim, got '
                             'strides %s' % (what, name, t.stride()))
    if min(t_q, t_kv, b) == 0:
        raise ValueError('%s: empty operand' % what)
    return b, t_q, t_kv, h, d, code


def flash_fwd(q, k, v, causal, scale):
    """Kernel wrapper: attention forward of CUDA ``(B, T, H, D)``
    operands of one dtype, read through their strides (the head axis D
    must be contiguous; ``qkv[:, :, 0]`` views are taken as they are).
    bf16 operands launch the tensor-core kernel (counted in
    ``flash_fwd.tc_launches`` too), which copies rows with 16-byte
    ``cp.async``: an operand whose rows are not 16-byte aligned is handed
    over as a contiguous copy (:func:`_rows16`).  f32 operands launch the
    scalar kernel.  Returns ``(out (B, Tq, H, D) contiguous, q.dtype; lse
    (B, H, Tq) f32)``.  Replaces ``_fwd_pallas``."""
    b, t_q, t_kv, h, d, code = _check_qkv('flash_fwd', q, k, v, causal)
    tc = q.dtype == torch.bfloat16
    if tc:
        q, k, v = _rows16(q), _rows16(k), _rows16(v)
    out = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t_q), dtype=torch.float32, device=q.device)
    lib = _lib()
    err = lib.cmn_flash_fwd(
        _common.ptr(q), _common.ptr(k), _common.ptr(v), code, d,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2),
        _common.ptr(out), _common.ptr(lse), b, h, t_q, t_kv, float(scale),
        int(bool(causal)), _common.stream_ptr(q.device))
    _common.check_launch(err, lib.cmn_fa_strerror, 'flash_fwd')
    flash_fwd.launches += 1
    flash_fwd.tc_launches += tc
    return out, lse


flash_fwd.launches = 0
flash_fwd.tc_launches = 0


def _bwd_operands(what, q, k, v, g, lse, delta, causal, out=None):
    """Check the backward kernels' operands; returns the kernels' leading
    arguments, the operands they point to and ``(b, t_q, t_kv, h, d)``.
    ``g`` (and ``out``) are made contiguous when their head axis is not:
    the gradient of ``out.sum()`` is an expanded scalar with every stride
    0.  bf16 operands, which the tensor-core kernels copy with 16-byte
    ``cp.async``, are handed over as contiguous copies where their rows
    are not 16-byte aligned (:func:`_rows16`).  With ``out`` (the dq
    kernel), ``delta`` is the kernel's output, allocated here when
    ``None``, and the strides are those of q, k, v, g and out."""
    b, t_q, t_kv, h, d, code = _check_qkv(what, q, k, v, causal)
    _check_cuda(what, g, lse, delta, out)
    like_q = [(g, 'g')] + ([] if out is None else [(out, 'out')])
    for t, name in like_q:
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError('%s: %s must be like q, %s %s, got %s %s'
                             % (what, name, tuple(q.shape), q.dtype,
                                tuple(t.shape), t.dtype))
    if g.stride(3) != 1:
        g = g.contiguous()
    if out is not None and out.stride(3) != 1:
        out = out.contiguous()
    operands = [q, k, v, g] + ([] if out is None else [out])
    if q.dtype == torch.bfloat16:
        operands = [_rows16(x) for x in operands]
    if delta is None:
        delta = torch.empty((b, h, t_q), dtype=torch.float32,
                            device=q.device)
    for t, name in ((lse, 'lse'), (delta, 'delta')):
        if (t.shape != (b, h, t_q) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError('%s: %s must be a contiguous float32 %s, got '
                             '%s %s' % (what, name, (b, h, t_q), t.dtype,
                                        tuple(t.shape)))
    strides = (ctypes.c_int64 * (3 * len(operands)))(
        *(x.stride(i) for x in operands for i in range(3)))
    lead = (*(_common.ptr(x) for x in operands[:4]), code, d, strides,
            _common.ptr(lse), _common.ptr(delta))
    # the operands are returned too: the caller allocates its outputs
    # before the launch, and a copy freed by then could be handed out again
    return lead, (operands, delta), (b, t_q, t_kv, h, d)


def flash_bwd_dq(q, k, v, g, out, lse, causal, scale):
    """Kernel wrapper: ``dq`` of the attention forward, and ``delta =
    rowsum(g * out)`` for :func:`flash_bwd_dkv`.  ``q``, ``k``, ``v`` as
    :func:`flash_fwd` takes them (read in place through their strides),
    ``g`` the gradient of ``out`` and ``out`` the forward's output (both
    ``(B, Tq, H, D)`` in ``q.dtype``, any strides), ``lse`` the
    forward's, f32 ``(B, H, Tq)``.  bf16 operands launch the tensor-core
    kernel (counted in ``flash_bwd_dq.tc_launches`` too; rows not 16-byte
    aligned are handed over as contiguous copies, as in
    :func:`flash_fwd`), f32 operands the scalar kernel.  Returns ``(dq
    (B, Tq, H, D) contiguous in q.dtype, delta (B, H, Tq) f32)``.
    Replaces the first ``pallas_call`` of ``_bwd_pallas``
    (``_bwd_dq_kernel``) and the ``delta`` before it."""
    lead, (operands, delta), (b, t_q, t_kv, h, d) = _bwd_operands(
        'flash_bwd_dq', q, k, v, g, lse, None, causal, out=out)
    dq = torch.empty((b, t_q, h, d), dtype=q.dtype, device=q.device)
    lib = _lib()
    err = lib.cmn_flash_bwd_dq(
        *lead, _common.ptr(operands[4]), _common.ptr(dq), b, h, t_q, t_kv,
        float(scale), int(bool(causal)), _common.stream_ptr(q.device))
    _common.check_launch(err, lib.cmn_fa_strerror, 'flash_bwd_dq')
    flash_bwd_dq.launches += 1
    flash_bwd_dq.tc_launches += q.dtype == torch.bfloat16
    return dq, delta


flash_bwd_dq.launches = 0
flash_bwd_dq.tc_launches = 0


def flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale):
    """Kernel wrapper: ``dk`` and ``dv`` of the attention forward, from
    the operands of :func:`flash_bwd_dq` and the ``delta`` it returned.
    bf16 operands launch the tensor-core kernel (counted in
    ``flash_bwd_dkv.tc_launches`` too; rows not 16-byte aligned are
    handed over as contiguous copies, as in :func:`flash_fwd`), f32
    operands the scalar kernel.  Returns ``(dk, dv)``, each ``(B, Tkv, H,
    D)`` contiguous in ``k.dtype``.  Replaces the second ``pallas_call``
    of ``_bwd_pallas`` (``_bwd_dkv_kernel``)."""
    lead, _keep, (b, t_q, t_kv, h, d) = _bwd_operands(
        'flash_bwd_dkv', q, k, v, g, lse, delta, causal)
    dk = torch.empty((b, t_kv, h, d), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, t_kv, h, d), dtype=v.dtype, device=v.device)
    lib = _lib()
    err = lib.cmn_flash_bwd_dkv(
        *lead, _common.ptr(dk), _common.ptr(dv), b, h, t_q, t_kv,
        float(scale), int(bool(causal)), _common.stream_ptr(q.device))
    _common.check_launch(err, lib.cmn_fa_strerror, 'flash_bwd_dkv')
    flash_bwd_dkv.launches += 1
    flash_bwd_dkv.tc_launches += q.dtype == torch.bfloat16
    return dk, dv


flash_bwd_dkv.launches = 0
flash_bwd_dkv.tc_launches = 0


def _aligned16(t):
    """True when every ``(B, T, H, D)`` row of ``t`` starts on a 16-byte
    boundary: the decode kernels read cache rows as 16-byte vectors, the
    tensor-core kernels copy them with 16-byte ``cp.async``."""
    size = t.element_size()
    return (t.data_ptr() % 16 == 0
            and all((s * size) % 16 == 0 for s in t.stride()[:3])
            and (t.shape[3] * size) % 16 == 0)


def _rows16(t):
    """A bf16 operand of the tensor-core kernels as they can read it:
    ``t`` itself when its rows are 16-byte aligned (the model's
    ``qkv.select`` views are), else a contiguous copy (a fresh
    allocation, so aligned)."""
    if _aligned16(t):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_decode(q, k, v, lengths, scale, k_scale=None, v_scale=None,
                 slots=None):
    """Kernel wrapper: one query row per (row, head) against its cache
    prefix.  ``q`` CUDA ``(N, H, D)`` bf16/f32 (D contiguous, other axes
    through strides); ``k`` / ``v`` one layer's cache ``(n_slots, S, H,
    D)`` bf16/f32, or int8 with f32 ``k_scale`` / ``v_scale`` ``(n_slots,
    S, H)``, read in place through their strides; ``lengths`` int32
    ``(N,)``, each in 1..S; ``slots`` int32 ``(N,)`` maps row i to its
    cache slot (``None``: row i reads slot i).  Returns ``(N, H, D)``
    contiguous in ``q.dtype``.  One launch: a block per (row, head,
    split of ``DECODE_SPLIT`` positions), the splits merged in split
    order by the row's last block (:func:`_decode_scratch`).  Replaces
    ``_decode_pallas``."""
    what = 'flash_decode'
    _check_cuda(what, q, k, v, lengths, k_scale, v_scale, slots)
    n, h, d, q_code = _check_decode_operands(what, q, k, v, k_scale,
                                             v_scale, '(slots, S, H, D)')
    _check_int_vectors(what, (lengths, 'lengths', (n,)),
                       (slots, 'slots', (n,)))
    n_slots, s_max = k.shape[:2]
    if slots is None and n > n_slots:
        raise ValueError('flash_decode: %d rows but %d cache slots and no '
                         'slots map' % (n, n_slots))
    out = torch.empty((n, h, d), dtype=q.dtype, device=q.device)
    scratch, _keep = _decode_scratch(q, n, h, d, s_max)
    lib = _lib()
    err = lib.cmn_flash_decode(
        *_decode_lead(q, q_code, k, v, k_scale, v_scale),
        _common.ptr(lengths), _common.ptr(slots), _common.ptr(out),
        n, h, s_max, d, float(scale), *scratch)
    _common.check_launch(err, lib.cmn_fa_strerror, what)
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def _check_decode_operands(what, q, k, v, k_scale, v_scale, layout):
    """The checks both decode kernels make of ``q`` ``(N, H, D)`` and of
    one layer's cache ``(X, Y, H, D)`` (``layout`` names X and Y) with
    its int8 scales; returns ``(n, h, d, q dtype code)``."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError('%s: expects q (N, H, D) and k, v %s, got %s %s %s'
                         % (what, layout, tuple(q.shape), tuple(k.shape),
                            tuple(v.shape)))
    n, h, d = q.shape
    if k.shape[2:] != (h, d):
        raise ValueError('%s: q %s and cache %s disagree on H or D'
                         % (what, tuple(q.shape), tuple(k.shape)))
    if d not in HEAD_DIMS:
        raise ValueError('%s: head dim %d, the kernel takes %s'
                         % (what, d, HEAD_DIMS))
    q_code = _common.dtype_code(q, what + ' q')
    if k.dtype not in KV_CODES or v.dtype != k.dtype:
        raise TypeError('%s: cache dtypes %s %s (float32, bfloat16 or int8)'
                        % (what, k.dtype, v.dtype))
    quantized = k.dtype == torch.int8
    if quantized != (k_scale is not None) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError('%s: an int8 cache needs both k_scale and v_scale, '
                         'a float cache neither' % what)
    if q.stride(2) != 1:
        raise ValueError('%s: q needs a contiguous head dim, got strides %s'
                         % (what, q.stride()))
    for t, name in ((k, 'k'), (v, 'v')):
        if t.stride(3) != 1 or not _aligned16(t):
            raise ValueError('%s: %s needs a contiguous head dim and 16-byte '
                             'aligned rows, got strides %s'
                             % (what, name, t.stride()))
    if quantized:
        for t, name in ((k_scale, 'k_scale'), (v_scale, 'v_scale')):
            if t.shape != k.shape[:3] or t.dtype != torch.float32:
                raise ValueError('%s: %s must be float32 %s, got %s %s'
                                 % (what, name, tuple(k.shape[:3]), t.dtype,
                                    tuple(t.shape)))
    if n == 0:
        raise ValueError('%s: no rows' % what)
    return n, h, d, q_code


def _check_int_vectors(what, *operands):
    """Each ``(tensor, name, shape)``: a contiguous int32 tensor of that
    shape (``None`` tensors pass)."""
    for t, name, want in operands:
        if t is not None and (t.dtype != torch.int32
                              or tuple(t.shape) != want
                              or not t.is_contiguous()):
            raise ValueError('%s: %s must be a contiguous int32 %s tensor, '
                             'got %s %s' % (what, name, want, t.dtype,
                                            tuple(t.shape)))


def _decode_scratch(q, n, h, d, s_max):
    """The trailing arguments of both decode entry points -- a float32
    workspace for the splits' ``(m, l, acc)`` (``torch.empty``: a merge
    reads only entries its launch wrote), its size, the ticket counters,
    their count, and the stream -- and the tensors they point to, which
    the caller holds until the launch is queued.  Under a CUDA graph
    capture the workspace comes from the graph's pool, which keeps it for
    every replay, and the counters are the capture's own
    (:func:`~chainermn_tpu_torch.ops._common.tickets`)."""
    n_split = -(-s_max // DECODE_SPLIT)
    ws = torch.empty(n * h * n_split * (d + 2), dtype=torch.float32,
                     device=q.device)
    stream = torch.cuda.current_stream(q.device)
    tickets = _common.tickets(q.device, n * h)
    return ((_common.ptr(ws), ws.numel(), _common.ptr(tickets),
             tickets.numel(), ctypes.c_void_p(stream.cuda_stream)),
            (ws, tickets))


def _decode_lead(q, q_code, k, v, k_scale, v_scale):
    """The leading arguments both decode entry points share: q and its
    strides, the cache operands with their strides, the scales with
    theirs (zeros for a float cache)."""
    ks = k_scale.stride() if k_scale is not None else (0, 0, 0)
    vs = v_scale.stride() if v_scale is not None else (0, 0, 0)
    return (_common.ptr(q), q_code, q.stride(0), q.stride(1),
            _common.ptr(k), _common.ptr(v), KV_CODES[k.dtype],
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            _common.ptr(k_scale), _common.ptr(v_scale),
            ks[0], ks[1], ks[2], vs[0], vs[1], vs[2])


def flash_decode_paged(q, k, v, page_tables, lengths, scale, k_scale=None,
                       v_scale=None):
    """Kernel wrapper: one query row per (row, head) against its pages.
    ``q`` CUDA ``(N, H, D)`` bf16/f32 (D contiguous); ``k`` / ``v`` one
    layer's pool ``(P, ps, H, D)`` bf16/f32, or int8 with f32 ``k_scale``
    / ``v_scale`` ``(P, ps, H)``, read in place through their strides (a
    layer slice of the 5-D cache is taken as it is); ``page_tables``
    int32 ``(N, n_max)`` contiguous, position p of row i at page
    ``page_tables[i, p // ps]``; ``lengths`` int32 ``(N,)``, each in
    1..n_max * ps.  Table entries at or past ``ceil(lengths[i] / ps)``
    are never read.  Returns ``(N, H, D)`` contiguous in ``q.dtype``.
    The slot kernel's split and merge over the row's positions, so its
    bits equal :func:`flash_decode`'s over the same pages gathered.
    Replaces ``_decode_paged_pallas``."""
    what = 'flash_decode_paged'
    _check_cuda(what, q, k, v, page_tables, lengths, k_scale, v_scale)
    n, h, d, q_code = _check_decode_operands(what, q, k, v, k_scale,
                                             v_scale, '(P, ps, H, D)')
    if page_tables.dim() != 2 or page_tables.shape[0] != n:
        raise ValueError('%s: page_tables must be (%d, n_max), got %s'
                         % (what, n, tuple(page_tables.shape)))
    n_max = page_tables.shape[1]
    _check_int_vectors(what, (page_tables, 'page_tables', (n, n_max)),
                       (lengths, 'lengths', (n,)))
    if n_max == 0:
        raise ValueError('%s: empty page tables' % what)
    out = torch.empty((n, h, d), dtype=q.dtype, device=q.device)
    scratch, _keep = _decode_scratch(q, n, h, d, n_max * k.shape[1])
    lib = _lib()
    err = lib.cmn_flash_decode_paged(
        *_decode_lead(q, q_code, k, v, k_scale, v_scale),
        _common.ptr(page_tables), n_max, k.shape[1], _common.ptr(lengths),
        _common.ptr(out), n, h, d, float(scale), *scratch)
    _common.check_launch(err, lib.cmn_fa_strerror, what)
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


# ---------------------------------------------------------------------
# public ops

class _FlashAttention(torch.autograd.Function):
    """``(out, lse)`` of the attention forward; ``lse`` carries no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        if _common.on_cuda(q, k, v):
            out, lse = flash_fwd(q, k, v, causal, scale)
        else:
            out, lse = _fwd_plain(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out, lse = ctx.saved_tensors
        if not _common.on_cuda(q, k, v, g):
            dq, dk, dv = _bwd_plain(q, k, v, out, lse, g, ctx.causal,
                                    ctx.scale)
            return dq, dk, dv, None, None
        dq, delta = flash_bwd_dq(q, k, v, g, out, lse, ctx.causal,
                                 ctx.scale)
        dk, dv = flash_bwd_dkv(q, k, v, g, lse, delta, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention_fwd(q, k, v, causal=False, scale=None):
    """Attention forward with its log-sum-exp: ``q`` ``(B, Tq, H, D)``,
    ``k`` / ``v`` ``(B, Tkv, H, D)``; returns ``(out (B, Tq, H, D),
    lse (B, H, Tq) f32)``, ``lse`` in the scaled-score units the
    chunked-prefill merge needs.  With ``causal=True``, Tq must equal
    Tkv.  ``out`` is differentiable in ``q``, ``k`` and ``v``."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError('causal attention requires t_q == t_kv, got %d '
                         'vs %d' % (q.shape[1], k.shape[1]))
    return _FlashAttention.apply(q, k, v, bool(causal), _scale(q, scale))


def flash_attention(q, k, v, causal=False, scale=None):
    """Fused attention. ``q`` ``(B, Tq, H, D)``, ``k`` / ``v`` ``(B, Tkv,
    H, D)``; returns ``(B, Tq, H, D)`` in ``q.dtype``."""
    return flash_attention_fwd(q, k, v, causal, scale)[0]


def flash_attention_decode(q, k, v, lengths, scale=None, k_scale=None,
                           v_scale=None, slots=None):
    """Single-token decode attention against a per-sequence KV cache.

    ``q`` ``(B, H, D)``: one query row per sequence.  ``k`` / ``v``
    ``(B, S, H, D)``, or with ``slots`` (``(B,)``, row b reads cache slot
    ``slots[b]``) one layer's whole slot cache ``(n_slots, S, H, D)``.
    Positions ``>= lengths[b]`` receive no probability mass, so a reused
    slot needs no zeroing.  int8 caches pass ``k_scale`` / ``v_scale``
    ``(.., S, H)`` from :func:`chainermn_tpu_torch.precision.quantize_kv`,
    dequantized in the kernel before the products.  Lengths are 1..S.
    """
    _common.forbid_grad('flash_attention_decode', q, k, v, k_scale, v_scale)
    if (k_scale is None) != (v_scale is None):
        raise ValueError('int8 KV decode needs BOTH k_scale and v_scale '
                         '(or neither)')
    scale = _scale(q, scale)
    if _common.on_cuda(q, k, v, lengths, k_scale, v_scale, slots):
        return flash_decode(
            q, k, v, lengths.to(torch.int32).contiguous(), scale, k_scale,
            v_scale,
            None if slots is None else slots.to(torch.int32).contiguous())
    return _decode_plain(q, k, v, lengths, scale, k_scale, v_scale, slots)


def flash_attention_decode_paged(q, k, v, page_tables, lengths, scale=None,
                                 k_scale=None, v_scale=None):
    """Single-token decode attention against a PAGED KV cache.

    ``q`` ``(B, H, D)``: one query row per sequence.  ``k`` / ``v``
    ``(P, page_size, H, D)``: the page pool shared by all sequences.
    ``page_tables`` ``(B, n_max)``: each sequence's pages in position
    order (position ``p`` at page ``page_tables[b, p // page_size]``,
    offset ``p % page_size``).  ``lengths`` ``(B,)``: the live prefix;
    table entries at or past ``ceil(lengths[b] / page_size)`` are never
    read, so an allocator can leave them pointing at its scratch page.
    int8 pools pass ``k_scale`` / ``v_scale`` ``(P, page_size, H)``.  The
    arithmetic is that of :func:`flash_attention_decode`; forward only.
    """
    _common.forbid_grad('flash_attention_decode_paged', q, k, v, k_scale,
                        v_scale)
    if k.dim() != 4:
        raise ValueError('paged cache must be (P, page_size, H, D), got '
                         'shape %r' % (tuple(k.shape),))
    if (k_scale is None) != (v_scale is None):
        raise ValueError('int8 KV decode needs BOTH k_scale and v_scale '
                         '(or neither)')
    scale = _scale(q, scale)
    if _common.on_cuda(q, k, v, page_tables, lengths, k_scale, v_scale):
        return flash_decode_paged(
            q, k, v, page_tables.to(torch.int32).contiguous(),
            lengths.to(torch.int32).contiguous(), scale, k_scale, v_scale)
    return _decode_paged_plain(q, k, v, page_tables, lengths, scale,
                               k_scale, v_scale)


def flash_attention_chunk(q, k_new, v_new, k_ctx, v_ctx, ctx_len, scale=None,
                          k_scale=None, v_scale=None):
    """Prefill-chunk attention: C fresh query rows at absolute positions
    ``ctx_len + [0, C)`` against the banked context plus causal attention
    within the chunk.

    ``q`` / ``k_new`` / ``v_new`` ``(B, C, H, D)``; ``k_ctx`` / ``v_ctx``
    ``(B, S, H, D)`` gathered cache rows (int8 with ``k_scale`` /
    ``v_scale`` ``(B, S, H)``; the chunk half always attends the fresh
    K/V); ``ctx_len`` ``(B,)``: context positions at or past it are
    masked.  The causal in-chunk half goes through
    :func:`flash_attention_fwd` (the kernel ``cmn_flash_fwd`` on CUDA
    tensors), the context half through a blockwise scan in PyTorch ops,
    and the two are merged exactly through their log-sum-exps.  With an
    empty context (``ctx_len == 0``, or ``S == 0``) the merge leaves the
    in-chunk half untouched: the result is bitwise the causal forward.
    Forward only."""
    _common.forbid_grad('flash_attention_chunk', q, k_new, v_new, k_ctx,
                        v_ctx)
    if (k_scale is None) != (v_scale is None):
        raise ValueError('int8 KV context needs BOTH k_scale and v_scale '
                         '(or neither)')
    b, c, h, d = q.shape
    s_ctx = k_ctx.shape[1]
    scale = _scale(q, scale)
    if k_new.dtype != q.dtype:
        # dequantized fresh K/V (f32) beside a bf16 query: the kernel takes
        # one dtype, and the JAX fallback widens all three to f32 anyway
        q_c, k_new, v_new = q.float(), k_new.float(), v_new.float()
    else:
        q_c = q
    out_c, lse_c = flash_attention_fwd(q_c, k_new, v_new, causal=True,
                                       scale=scale)
    out_c = out_c.to(q.dtype)
    block = min(BLOCK, max(s_ctx, 1))
    n_k = -(-s_ctx // block) * block
    km, vm = _pad_to(_merge(k_ctx), n_k), _pad_to(_merge(v_ctx), n_k)
    ksm = vsm = None
    if k_scale is not None:
        ksm = _pad_to(_merge(k_scale.float()), n_k)
        vsm = _pad_to(_merge(v_scale.float()), n_k)
    ctx_bh = ctx_len.to(device=q.device,
                        dtype=torch.int64).repeat_interleave(h)
    out_x, lse_x = _ctx_blockwise(_merge(q), km, vm, ctx_bh, scale, block,
                                  ksm, vsm)
    # exact log-sum-exp merge; an empty context (lse_x ~ -1e30) gives
    # w_c = exp(0) = 1 and w_x = 0 exactly, and out_x stays finite
    lse_x = lse_x.reshape(b, h, c)
    m_tot = torch.maximum(lse_c, lse_x)
    w_c = torch.exp(lse_c - m_tot).transpose(1, 2)[..., None]  # (B, C, H, 1)
    w_x = torch.exp(lse_x - m_tot).transpose(1, 2)[..., None]
    out_x = out_x.reshape(b, h, c, d).transpose(1, 2)
    out = (out_c.float() * w_c + out_x.float() * w_x) / (w_c + w_x)
    return out.to(q.dtype)
