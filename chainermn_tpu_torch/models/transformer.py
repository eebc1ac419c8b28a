"""Decoder-only transformer LM, its training loss and its
slot-KV-cache serving functions.

Counterpart of ``chainermn_tpu/models/transformer.py``: the same blocks
(pre-LayerNorm, fused qkv projection, causal flash attention, gelu MLP),
the same parameter tree, the next-token loss (:func:`lm_loss`,
:func:`lm_loss_sum`) over the fused cross-entropy, and module-level
serving functions (:func:`init_kv_cache`, :func:`prefill`,
:func:`decode_step`) that do the same arithmetic as
:meth:`TransformerLM.forward` over the same parameters.
:meth:`TransformerLM.forward` records gradients (LayerNorm, flash
attention and the cross-entropy each carry their backward); the serving
functions are inference: call them under ``torch.no_grad()``.

Parameters keep flax's names AND layouts (``qkv/kernel`` is ``(d, 3, H,
d_head)``, a Dense ``kernel`` is ``(in, out)``), so a flax tree carries
over leaf for leaf (:mod:`flax_weights`).  The master parameters are
float32; ``dtype`` is the compute dtype every matmul runs in, and the
LM head is a float32 product over activations first rounded to
``dtype``, as in the JAX package.

Not ported yet (they raise ``NotImplementedError``): ``tp_axis``,
``sequence_axis`` and dropout (ROADMAP.md A6, A7), the paged cache and
speculative verification (ROADMAP.md A8).
"""

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch import ops
from chainermn_tpu_torch.ops._common import resolve_device
from chainermn_tpu_torch.precision import quantize_kv


def _trunc_normal(shape, std, generator):
    """flax's truncated-normal initializers: +-2 std, rescaled so the
    variance is ``std ** 2``."""
    w = torch.empty(shape)
    s = std / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)
    return nn.Parameter(w)


class Dense(nn.Module):
    """``flax.linen.Dense`` twin: ``kernel`` ``(in, out)`` (flax's
    layout), ``bias`` ``(out,)``; input, kernel and bias promoted to
    ``dtype``."""

    def __init__(self, in_features, features, dtype, generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = _trunc_normal((in_features, features),
                                    in_features ** -0.5, generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return _dense(x, {'kernel': self.kernel, 'bias': self.bias},
                      self.dtype)


class QKV(nn.Module):
    """``flax.linen.DenseGeneral((3, H, d_head), axis=-1)`` twin: kernel
    ``(d, 3, H, d_head)``, bias ``(3, H, d_head)``."""

    def __init__(self, d_model, n_heads, dtype, generator):
        super().__init__()
        d_head = d_model // n_heads
        self.dtype = dtype
        self.kernel = _trunc_normal((d_model, 3, n_heads, d_head),
                                    d_model ** -0.5, generator)
        self.bias = nn.Parameter(torch.zeros(3, n_heads, d_head))

    def forward(self, h):
        return _qkv_proj(h, {'qkv': {'kernel': self.kernel,
                                     'bias': self.bias}}, self.dtype)


class Embed(nn.Module):
    """``flax.linen.Embed`` twin: ``embedding`` ``(V, d)``, rows cast to
    ``dtype``."""

    def __init__(self, vocab_size, d_model, dtype, generator):
        super().__init__()
        self.dtype = dtype
        self.embedding = _trunc_normal((vocab_size, d_model),
                                       vocab_size ** -0.5, generator)

    def forward(self, tokens):
        return _embed(self.embedding, tokens, self.dtype)


def _unported(sequence_axis, tp_axis, dropout):
    if sequence_axis is not None or tp_axis is not None:
        raise NotImplementedError(
            'sequence_axis / tp_axis are not ported yet (ROADMAP.md A7)')
    if dropout:
        raise NotImplementedError(
            'dropout is not ported yet (ROADMAP.md A6)')


class TransformerBlock(nn.Module):
    """Pre-LN block: LN -> qkv -> causal flash attention -> proj
    residual -> LN -> gelu MLP residual."""

    def __init__(self, d_model, n_heads, d_ff, dtype=torch.bfloat16,
                 sequence_axis=None, dropout=0.0, tp_axis=None,
                 generator=None):
        super().__init__()
        _unported(sequence_axis, tp_axis, dropout)
        self.d_model = d_model
        self.dtype = dtype
        self.ln1_scale = nn.Parameter(torch.ones(d_model))
        self.ln1_bias = nn.Parameter(torch.zeros(d_model))
        self.qkv = QKV(d_model, n_heads, dtype, generator)
        self.proj = Dense(d_model, d_model, dtype, generator)
        self.ln2_scale = nn.Parameter(torch.ones(d_model))
        self.ln2_bias = nn.Parameter(torch.zeros(d_model))
        self.ff_in = Dense(d_model, d_ff, dtype, generator)
        self.ff_out = Dense(d_ff, d_model, dtype, generator)

    def forward(self, x):
        h = ops.layer_norm(x, self.ln1_scale, self.ln1_bias).to(self.dtype)
        qkv = self.qkv(h)                       # (B, T, 3, H, d_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = ops.flash_attention(q, k, v, causal=True)
        x = x + self.proj(attn.reshape(attn.shape[:2] + (self.d_model,)))
        h = ops.layer_norm(x, self.ln2_scale, self.ln2_bias).to(self.dtype)
        return x + self.ff_out(_gelu(self.ff_in(h)))


class TransformerLM(nn.Module):
    """Causal LM: ``tokens`` ``(B, T)`` int -> logits ``(B, T, V)`` f32.

    Parameters are made on the CPU from ``generator`` (default: seed 0)
    and moved to ``device`` (default: the current CUDA device; raises
    when there is none)."""

    def __init__(self, vocab_size=32000, d_model=512, n_heads=8,
                 n_layers=6, d_ff=2048, max_len=32768, dtype=torch.bfloat16,
                 sequence_axis=None, dropout=0.0, tp_axis=None, device=None,
                 generator=None):
        super().__init__()
        _unported(sequence_axis, tp_axis, dropout)
        if d_model % n_heads:
            raise ValueError('n_heads=%d must divide d_model=%d'
                             % (n_heads, d_model))
        device = resolve_device(device)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.vocab_size = vocab_size
        self.d_model = d_model
        self.n_heads = n_heads
        self.n_layers = n_layers
        self.d_ff = d_ff
        self.max_len = max_len
        self.dtype = dtype
        self.embed = Embed(vocab_size, d_model, dtype, generator)
        self.pos_embed = _trunc_normal((max_len, d_model), 0.02, generator)
        for i in range(n_layers):
            setattr(self, 'block_%d' % i, TransformerBlock(
                d_model, n_heads, d_ff, dtype, generator=generator))
        self.lnf_scale = nn.Parameter(torch.ones(d_model))
        self.lnf_bias = nn.Parameter(torch.zeros(d_model))
        self.lm_head = Dense(d_model, vocab_size, torch.float32, generator)
        self.to(device)

    def forward(self, tokens):
        t = tokens.shape[1]
        x = self.embed(tokens) + self.pos_embed[:t].to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, 'block_%d' % i)(x)
        x = ops.layer_norm(x, self.lnf_scale, self.lnf_bias)
        return self.lm_head(x.to(self.dtype))


def lm_loss_sum(apply_fn, pad_id=-1):
    """Next-token loss in sum/count form: the returned ``loss_fn(tokens,
    targets)`` gives ``((loss_sum, token_count), {})``.  ``apply_fn`` is
    the model, or any callable from ``tokens`` ``(B, T)`` to logits ``(B,
    T, V)``.  Targets equal to ``pad_id`` are handed to the cross-entropy
    as they are (a label outside the vocabulary picks nothing) and masked
    out afterwards, so their rows get no gradient.  :func:`lm_loss` is
    the mean form of this same computation."""

    def loss_fn(tokens, targets):
        logits = apply_fn(tokens)
        b, t, v = logits.shape
        flat = targets.reshape(b * t)
        ce = ops.softmax_cross_entropy(logits.reshape(b * t, v),
                                       flat.to(torch.int32))
        mask = (flat != pad_id).to(torch.float32)
        return ((ce * mask).sum(), mask.sum()), {}

    return loss_fn


def lm_loss(apply_fn, pad_id=-1):
    """Next-token loss over ``(tokens, targets)`` through the fused
    cross-entropy: the returned ``loss_fn(tokens, targets)`` gives
    ``(loss, {'perp': exp(min(loss, 20))})``, the form
    :class:`chainermn_tpu_torch.training.StandardUpdater` takes.
    ``pad_id`` target positions are masked out (use -1 when every
    position is real)."""
    sum_fn = lm_loss_sum(apply_fn, pad_id)

    def loss_fn(tokens, targets):
        (total, n), _ = sum_fn(tokens, targets)
        loss = total / n.clamp_min(1.0)
        return loss, {'perp': torch.exp(loss.detach().clamp_max(20.0))}

    return loss_fn


# ---------------------------------------------------------------------
# incremental decode: slot-addressed KV cache
#
# PREFILL computes the causal forward of one prompt once and banks every
# layer's K/V in a cache SLOT; each DECODE step runs one token per row,
# writes its K/V at the row's position and attends the single query row
# against the slot's cache prefix.  The cache is a dict of stacked
# per-layer tensors.  The JAX package returns a new cache from every
# call and donates the old one; here the functions update the cache
# tensors IN PLACE (and return the same dict), which is what donation
# buys there: steady-state decode allocates nothing cache-sized.

def init_kv_cache(model, n_slots, max_len=None, dtype=None, tp=1,
                  int8_kv=False, device=None):
    """Zeroed slot-addressed KV cache for ``model``:
    ``{'k'|'v': (n_layers, n_slots, S, H, d_head)}`` with ``S = max_len
    or model.max_len``, in ``dtype`` (default ``model.dtype``), on
    ``device`` (default: the current CUDA device).  ``int8_kv=True``
    stores k / v as int8 and adds ``'k_scale'`` / ``'v_scale'``
    ``(n_layers, n_slots, S, H)`` float32.  Slots are reused without
    zeroing: reads mask by the live length."""
    if tp != 1:
        raise NotImplementedError(
            'a tensor-parallel cache is not ported yet (ROADMAP.md A7)')
    device = resolve_device(device)
    d_head = model.d_model // model.n_heads
    shape = (model.n_layers, int(n_slots), int(max_len or model.max_len),
             model.n_heads, d_head)
    if int8_kv:
        return {'k': torch.zeros(shape, dtype=torch.int8, device=device),
                'v': torch.zeros(shape, dtype=torch.int8, device=device),
                'k_scale': torch.zeros(shape[:-1], device=device),
                'v_scale': torch.zeros(shape[:-1], device=device)}
    dtype = dtype or model.dtype
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device)}


def _cache_int8(cache):
    return 'k_scale' in cache


def _dense(x, p, dtype):
    """``nn.Dense`` twin: promote input, kernel and bias to ``dtype``."""
    return x.to(dtype) @ p['kernel'].to(dtype) + p['bias'].to(dtype)


def _qkv_proj(h, bp, dtype):
    """``nn.DenseGeneral((3, H, d_head), axis=-1)`` twin over ``(..., d)``
    activations: returns ``(..., 3, H, d_head)``."""
    w = bp['qkv']['kernel'].to(dtype)
    out = h.to(dtype) @ w.reshape(w.shape[0], -1)
    return out.reshape(h.shape[:-1] + w.shape[1:]) \
        + bp['qkv']['bias'].to(dtype)


def _embed(table, tokens, dtype):
    return table.index_select(0, tokens.reshape(-1)).reshape(
        tokens.shape + table.shape[1:]).to(dtype)


def _gelu(x):
    # flax's nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate='tanh')


def _mlp(h, bp, dtype):
    return _dense(_gelu(_dense(h, bp['ff_in'], dtype)), bp['ff_out'], dtype)


def _write_kv(cache, layer, k_new, v_new, slots, positions):
    """Write one token's K/V per row, in place: ``k_new`` / ``v_new``
    ``(N, H, d_head)`` at ``(layer, slots[i], positions[i])``;
    ``slots=None`` means row i IS slot i."""
    n = k_new.shape[0]
    rows = (torch.arange(n, device=k_new.device) if slots is None
            else slots.long())
    pos = positions.long()
    if _cache_int8(cache):
        for name, val in (('k', k_new), ('v', v_new)):
            qv, scale = quantize_kv(val)
            cache[name][layer, rows, pos] = qv
            cache[name + '_scale'][layer, rows, pos] = scale
        return cache
    cache['k'][layer, rows, pos] = k_new.to(cache['k'].dtype)
    cache['v'][layer, rows, pos] = v_new.to(cache['v'].dtype)
    return cache


def _attend_cache(cache, layer, q, slots, lengths):
    """One decode-attention read: row i's query against its slot's cache
    prefix.  The kernel reads the layer's cache in place in both cases;
    with ``slots`` (a compacted bucket) it follows the row -> slot map,
    where the plain version gathers the rows first."""
    scales = {}
    if _cache_int8(cache):
        scales = dict(k_scale=cache['k_scale'][layer],
                      v_scale=cache['v_scale'][layer])
    return ops.flash_attention_decode(q, cache['k'][layer],
                                      cache['v'][layer], lengths,
                                      slots=slots, **scales)


def _head_logits(model, params, x):
    """The LM head: an f32 Dense over activations rounded to
    ``model.dtype`` first."""
    return _dense(x.to(model.dtype), params['lm_head'], torch.float32)


def _decode_core(model, params, cache, tokens, positions, write, attend):
    """Shared single-token decode body: embed + per layer (norm -> qkv
    -> ``write`` one token's K/V -> ``attend`` the cache -> proj residual
    -> MLP residual) -> final norm -> head."""
    dtype = model.dtype
    x = _embed(params['embed']['embedding'], tokens, dtype)
    x = x + _embed(params['pos_embed'], positions, dtype)
    for i in range(model.n_layers):
        bp = params['block_%d' % i]
        h = ops.layer_norm(x, bp['ln1_scale'], bp['ln1_bias']).to(dtype)
        qkv = _qkv_proj(h, bp, dtype)            # (N, 3, H, d_head)
        q, k_new, v_new = qkv[:, 0], qkv[:, 1], qkv[:, 2]
        cache = write(cache, i, k_new, v_new)
        attn = attend(cache, i, q)
        x = x + _dense(attn.reshape(attn.shape[0], -1), bp['proj'], dtype)
        h = ops.layer_norm(x, bp['ln2_scale'], bp['ln2_bias']).to(dtype)
        x = x + _mlp(h, bp, dtype)
    x = ops.layer_norm(x, params['lnf_scale'], params['lnf_bias'])
    return _head_logits(model, params, x), cache


def decode_step(model, params, cache, tokens, positions, slots=None):
    """One incremental decode step: ``tokens`` ``(N,)`` int -- the last
    sampled token per row -- at ``positions`` ``(N,)`` (0-based; this
    token's K/V lands there and attention covers ``positions + 1``
    entries).  ``slots`` ``(N,)`` maps rows to cache slots for a
    compacted bucket; ``None`` (the full bucket) requires ``N ==
    n_slots``.  Returns ``(logits (N, V) f32, cache)``; the cache is
    updated in place."""
    if slots is None and tokens.shape[0] != cache['k'].shape[1]:
        raise ValueError(
            'full-bucket decode needs one row per cache slot (%d rows vs '
            '%d slots); pass slots= for a compacted bucket'
            % (tokens.shape[0], cache['k'].shape[1]))
    lengths = positions.to(torch.int32) + 1

    def write(cache, layer, k_new, v_new):
        return _write_kv(cache, layer, k_new, v_new, slots, positions)

    def attend(cache, layer, q):
        return _attend_cache(cache, layer, q, slots, lengths)

    return _decode_core(model, params, cache, tokens, positions, write,
                        attend)


def prefill(model, params, cache, tokens, length, slot):
    """Prefill one prompt into cache slot ``slot``: ``tokens`` ``(1, T)``
    padded to a prompt bucket, ``length`` the valid prefix (positions
    beyond it are written but never attended: decode lengths start at
    ``length``).  Runs the causal forward once, banks every layer's K/V
    at ``cache[:, slot, :T]`` in place, and returns ``(logits (V,) f32
    at position length - 1, cache)``."""
    dtype = model.dtype
    b, t = tokens.shape
    if b != 1:
        raise ValueError('prefill takes one prompt per call, got batch %d'
                         % b)
    slot, length = int(slot), int(length)
    x = _embed(params['embed']['embedding'], tokens, dtype)
    x = x + params['pos_embed'][:t].to(dtype)
    int8_kv = _cache_int8(cache)
    for i in range(model.n_layers):
        bp = params['block_%d' % i]
        h = ops.layer_norm(x, bp['ln1_scale'], bp['ln1_bias']).to(dtype)
        qkv = _qkv_proj(h, bp, dtype)            # (1, T, 3, H, d_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = ops.flash_attention(q, k, v, causal=True)
        for name, val in (('k', k[0]), ('v', v[0])):
            if int8_kv:
                qv, scale = quantize_kv(val)
                cache[name][i, slot, :t] = qv
                cache[name + '_scale'][i, slot, :t] = scale
            else:
                cache[name][i, slot, :t] = val
        x = x + _dense(attn.reshape(1, t, -1), bp['proj'], dtype)
        h = ops.layer_norm(x, bp['ln2_scale'], bp['ln2_bias']).to(dtype)
        x = x + _mlp(h, bp, dtype)
    # the head only needs the last valid position's activation
    x_last = ops.layer_norm(x[0, length - 1:length], params['lnf_scale'],
                            params['lnf_bias'])
    return _head_logits(model, params, x_last)[0], cache

