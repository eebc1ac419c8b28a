"""Sequence/context parallelism: ring attention and all-to-all (Ulysses)
attention, and the mapped global loss.

Counterpart of ``chainermn_tpu/parallel/sequence.py``, in the same two
schemes:

- :func:`ring_attention`: the sequence stays sharded; each process
  rotates its key/value block around the ring through the port's
  differentiable permutation (``functions.point_to_point_communication``,
  the ``lax.ppermute`` twin; its backward is the reverse rotation),
  accumulating attention in the f32 online-softmax form of the JAX
  package (running max, rescaled numerator and denominator) with the
  causal positions taken from the ring index.  It is the same blockwise
  einsum in PyTorch ops as the reference's (no Pallas kernel there
  either), so it keeps ``(B, H, T_local, T_local)`` f32 score blocks for
  the backward.
- :func:`ulysses_attention`: an all-to-all reshards (sequence <-> heads)
  so each process runs plain full-sequence attention on its head group
  through ``ops.flash_attention`` (the flash kernels on CUDA tensors),
  and a second one reshards the output back; both are differentiable
  (the backward is the reverse resharding).  Needs ``n_heads % P == 0``.

Every process of the axis must make the same calls in the same order
(the collectives are eager ``torch.distributed`` calls): the model's
layers do.
"""

import torch
import torch.distributed as dist

from chainermn_tpu_torch.functions.point_to_point_communication import (
    _Permute)
from chainermn_tpu_torch.parallel.meshplan import resolve_axis


def ring_attention(q, k, v, axis, causal=False, scale=None):
    """Blockwise ring attention.  ``q, k, v`` ``(B, T_local, H, D)``,
    the sequence dim sharded over ``axis`` (process ``i`` holds global
    positions ``[i * T_local, (i + 1) * T_local)``).  Returns the local
    query block's ``(B, T_local, H, D)`` attention output,
    mathematically full softmax attention over the global sequence."""
    ax = resolve_axis(axis)
    n_ring, me = ax.size, ax.index
    t_local = q.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qt = q.transpose(1, 2) * scale                      # (B, H, Tq, D)
    neg_inf = torch.finfo(torch.float32).min
    b, _, h, d = q.shape
    dev = q.device
    m = torch.full((b, h, t_local), neg_inf, dtype=torch.float32,
                   device=dev)
    num = torch.zeros((b, h, t_local, d), dtype=torch.float32, device=dev)
    den = torch.zeros((b, h, t_local), dtype=torch.float32, device=dev)
    pairs = [(ax.ranks[i], ax.ranks[(i + 1) % n_ring])
             for i in range(n_ring)]
    kv = torch.stack([k, v])
    q_pos = me * t_local + torch.arange(t_local, device=dev)[:, None]
    for step in range(n_ring):
        kt, vt = kv[0].transpose(1, 2), kv[1].transpose(1, 2)
        # the source process of the block held after ``step`` rotations
        src = (me - step) % n_ring
        scores = torch.einsum('bhqd,bhkd->bhqk', qt, kt).to(torch.float32)
        if causal:
            k_pos = (src * t_local
                     + torch.arange(kt.shape[2], device=dev)[None, :])
            scores = torch.where(q_pos >= k_pos, scores, neg_inf)
        new_m = torch.maximum(m, scores.amax(-1))
        # guard fully masked rows (a block wholly in the future)
        correction = torch.exp(m - new_m)
        p = torch.exp(scores - new_m[..., None])
        p = torch.where(torch.isfinite(scores), p, 0.0)
        num = num * correction[..., None] + torch.einsum(
            'bhqk,bhkd->bhqd', p.to(vt.dtype), vt).to(torch.float32)
        den = den * correction + p.sum(-1)
        m = new_m
        if step + 1 < n_ring:
            # the JAX scan rotates after its last block too; that block
            # is never read, so the rotation is skipped here
            kv = _Permute.apply(kv, pairs, ax.ranks[me])
    out = num / den[..., None].clamp_min(1e-30)
    return out.transpose(1, 2).to(q.dtype)


def _all_to_all(x, ax, split_axis, concat_axis):
    """Tiled ``lax.all_to_all``: ``x`` split into ``P`` chunks along
    ``split_axis``, chunk ``j`` sent to the axis's process ``j``, the
    chunks received concatenated along ``concat_axis`` in process
    order."""
    inp = torch.stack(x.chunk(ax.size, dim=split_axis)).contiguous()
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, group=ax.group)
    return torch.cat(out.unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):

    cmn_collective = 'all_to_all'

    @staticmethod
    def forward(ctx, x, ax, split_axis, concat_axis):
        ctx.axis, ctx.split_axis, ctx.concat_axis = ax, split_axis, concat_axis
        return _all_to_all(x, ax, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        return (_all_to_all(g, ctx.axis, ctx.concat_axis, ctx.split_axis),
                None, None, None)


def all_to_all(x, axis, split_axis, concat_axis):
    """Differentiable tiled all-to-all over ``axis`` (identity over an
    axis of one process); the backward is the reverse resharding."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x
    return _AllToAll.apply(x, ax, split_axis, concat_axis)


def ulysses_attention(q, k, v, axis, causal=False, scale=None,
                      attn_fn=None):
    """All-to-all sequence parallelism.  ``q, k, v`` ``(B, T_local, H,
    D)``, the sequence dim sharded over ``axis`` (size P).  One
    all-to-all (of q, k and v stacked) reshards to ``(B, T, H/P, D)``,
    the full sequence of the local head group, where
    ``attn_fn(q, k, v, causal=, scale=)`` runs (default
    ``ops.flash_attention``); a second reshards the output back."""
    ax = resolve_axis(axis)
    p, h = ax.size, q.shape[2]
    if h % p:
        raise ValueError(
            'ulysses_attention needs n_heads %% axis_size == 0, got '
            '%d heads over %d devices (use ring_attention instead)'
            % (h, p))
    qkv = all_to_all(torch.stack([q, k, v]), axis, split_axis=3,
                     concat_axis=2)
    if attn_fn is None:
        from chainermn_tpu_torch import ops
        attn_fn = ops.flash_attention
    out = attn_fn(qkv[0], qkv[1], qkv[2], causal=causal, scale=scale)
    return all_to_all(out, axis, split_axis=1, concat_axis=2)


class _ShareSum(torch.autograd.Function):
    """Sum over the axis forward, identity backward: each process's
    backward then carries its own share of the global loss."""

    cmn_collective = 'share_sum'

    @staticmethod
    def forward(ctx, x, ax):
        ctx.axis = ax
        out = x.detach().clone()
        dist.all_reduce(out, group=ax.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def share_sum(x, axis):
    """The sum of ``x`` over ``axis`` whose gradient reaches each
    process's own ``x`` alone (no collective in the backward)."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x
    return _ShareSum.apply(x, ax)


def mapped_global_loss(loss_fn, mesh, batch_spec, axes=None,
                       token_weighted=False):
    """The sequence-parallel training loss.

    Returns ``mapped(*batch) -> scalar``: ``loss_fn(*local)`` on this
    process's shard of every batch array (cut by ``batch_spec``, a tuple
    of None / axis name / tuple of names per dim, as the JAX
    ``PartitionSpec``), with ``mesh``'s axes bound, reduced over ``axes``
    (default: all of them).  ``aux`` is discarded.

    ``token_weighted=False``: ``loss_fn(*local) -> (loss, aux)``, and the
    per-shard MEAN losses are averaged, which equals the global mean
    only when every shard weighs its tokens equally.
    ``token_weighted=True``: ``loss_fn(*local) -> ((loss_sum, weight),
    aux)``, and the result is ``sum(loss_sum) / sum(weight)``, the exact
    global weighted mean however padding lands across shards.

    The value is the global loss on every process.  Its backward gives
    each process its SHARE of the gradient (the JAX package
    differentiates from outside the mapped function, where XLA sums the
    shares): call :func:`sum_grads` over the same axes after
    ``backward()``, and every replicated parameter's gradient is the
    gradient of the global loss.
    """
    if axes is None:
        axes = mesh.axis_names

    def mapped(*batch):
        local = [mesh.local(b, batch_spec) for b in batch]
        with mesh.bind():
            n = resolve_axis(axes).size
            if token_weighted:
                (loss_sum, weight), _ = loss_fn(*local)
                den = torch.as_tensor(weight, dtype=torch.float32,
                                      device=loss_sum.device).detach()
                if n > 1:
                    den = den.clone()
                    dist.all_reduce(den, group=resolve_axis(axes).group)
                return share_sum(loss_sum, axes) / den.clamp_min(1e-9)
            loss, _ = loss_fn(*local)
            return share_sum(loss, axes) / n

    return mapped


@torch.no_grad()
def sum_grads(params, mesh, axes=None):
    """Sum every parameter's gradient over ``axes`` of ``mesh`` (default:
    all), in place: after :func:`mapped_global_loss`'s backward, each
    replicated parameter then holds the global loss's gradient."""
    if axes is None:
        axes = mesh.axis_names
    ax = mesh.axis(axes)
    if ax.size == 1:
        return params
    grads = [p.grad for p in params if p.grad is not None]
    from chainermn_tpu_torch.communicators import memory_utility

    def reduce(buf):
        dist.all_reduce(buf, group=ax.group)
        return buf
    for g, r in zip(grads, memory_utility.fused_reduce(grads, reduce)):
        g.copy_(r)
    return params
