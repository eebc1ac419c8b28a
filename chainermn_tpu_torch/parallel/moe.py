"""Expert parallelism: the switch-style MoE layer.

Counterpart of ``chainermn_tpu/parallel/moe.py``.  The experts are
sharded over the processes of a mesh axis (``'expert'``, one or more
experts each); each process routes its own tokens (top-k with a
capacity), and the routed rows travel to the process that owns their
expert and back through a differentiable all-to-all over the axis
(``sequence.all_to_all``: its backward is the reverse exchange).

Dispatch is sort-based, as in the JAX package: the token rows are
stably sorted by expert, a row's queue position is its offset from its
expert's segment start, and dispatch and combine are O(T·d) index
writes and reads of the ``(E·C, d)`` expert buffer.  Rows past an
expert's capacity go to a trash row ``E·C`` that is sliced away
(``index_add_`` onto it, in the dispatch and in the combine's backward,
is nondeterministic on CUDA and harmless: every real slot is written
once, so the rest is exact).  The O(T·E·C) one-hot
form is kept only as :func:`dense_dispatch_reference`, the oracle the
tests hold the sort path to.

Gradients (the convention of :mod:`chainermn_tpu_torch.parallel`): each
process seeds its own share of the loss -- the JAX test's
``psum(sum y**2)`` becomes the local ``sum y**2`` and ``pmean(aux)``
becomes ``aux / ep`` -- and the replicated leaves (the router, and a
block's attention and LayerNorm weights) then have their gradients
summed over the expert axis (``sequence.sum_grads(params, mesh,
axes=('expert',))``), which is what ``shard_map``'s transpose does in
JAX.  The expert leaves ``w_in`` / ``w_out`` get the other processes'
share through the backward of the exchange and are not summed again.
"""

import numpy as np
import torch
import torch.nn.functional as F

from chainermn_tpu_torch.parallel.meshplan import resolve_axis
from chainermn_tpu_torch.parallel.sequence import all_to_all
from chainermn_tpu_torch.parallel.tensor import qkv_attention


def _route(params, x, k=1):
    """The router: ``probs`` (T, E), ``expert_idx`` (T, k), ``gate`` (T,
    k).  ``k = 1`` is switch routing (the gate is the raw top
    probability); ``k > 1`` renormalizes the k gates to sum to 1 (GShard).
    The top k come from a stable descending sort, so ties go to the lower
    expert index, as ``lax.top_k`` breaks them (``torch.topk`` leaves
    their order unspecified, and ties are real on bf16 probabilities)."""
    logits = x @ params['router']                     # (T, E)
    probs = torch.exp(logits - logits.amax(-1, keepdim=True).detach())
    probs = probs / probs.sum(-1, keepdim=True)
    values, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, expert_idx = values[:, :k], order[:, :k]
    if k > 1:
        gate = gate / gate.sum(-1, keepdim=True)
    return probs, expert_idx, gate


def sort_dispatch(x, expert_idx, n_experts, capacity):
    """Sort-based dispatch of the rows of ``x`` (T, d) to their experts
    (``expert_idx`` (T,)): returns ``(expert_in (E, C, d), combine,
    keep (T,) bool)``, where ``combine(out (E, C, d')) -> (T, d')`` reads
    each kept row's slot back in token order (zeros for a dropped row).
    The stable sort keeps first-come priority within an expert, so the
    capacity cut keeps exactly the rows the dense form keeps."""
    tokens, d_model = x.shape
    dev = x.device
    order = torch.sort(expert_idx, stable=True).indices        # (T,)
    sorted_expert = expert_idx[order]
    counts = torch.bincount(expert_idx, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts                  # segments
    pos_sorted = torch.arange(tokens, device=dev) - starts[sorted_expert]
    keep_sorted = pos_sorted < capacity
    slot = sorted_expert * capacity + pos_sorted.clamp(max=capacity - 1)
    # a dropped row writes to the trash row, sliced away below
    slot = torch.where(keep_sorted, slot,
                       torch.full_like(slot, n_experts * capacity))
    expert_in = x.new_zeros((n_experts * capacity + 1, d_model)).index_add(
        0, slot, x.index_select(0, order))
    expert_in = expert_in[:-1].reshape(n_experts, capacity, d_model)

    def combine(out):
        out_flat = torch.cat([out.reshape(n_experts * capacity, -1),
                              out.new_zeros((1, out.shape[-1]))])
        # (T, d'), a dropped row reads the trash row's zeros.  Gathered
        # with index_select: its backward adds into the rows it read, each
        # real slot once; an indexing gather's backward (index_put_ with
        # accumulate) sorts, and with many drops its one hot trash row
        # cost 43 of a step's 63 ms of device on the H100
        y_sorted = out_flat.index_select(0, slot)
        return out.new_zeros((tokens, out.shape[-1])).index_copy(
            0, order, y_sorted)

    keep = torch.zeros(tokens, dtype=torch.bool, device=dev)
    keep[order] = keep_sorted
    return expert_in, combine, keep


def dense_dispatch_reference(x, expert_idx, n_experts, capacity):
    """The O(T·E·C) one-hot dispatch: the oracle of :func:`sort_dispatch`
    in the tests, never on the main path."""
    onehot = F.one_hot(expert_idx.long(), n_experts).to(torch.int32)
    pos = (torch.cumsum(onehot, 0) * onehot).sum(-1) - 1
    keep = pos < capacity
    eye_c = torch.eye(capacity, dtype=torch.float32, device=x.device)
    disp = (onehot.to(torch.float32)[:, :, None]
            * eye_c[pos.clamp(0, capacity - 1)][:, None, :]
            * keep[:, None, None].to(torch.float32))
    expert_in = torch.einsum('td,tec->ecd', x, disp.to(x.dtype))

    def combine(out):
        return torch.einsum('ecd,tec->td', out, disp.to(out.dtype))

    return expert_in, combine, keep


class MoELayer:
    """Functional switch FFN over the expert axis.

    Params (per process, expert-sharded over ``axis``): ``router`` (d,
    E) replicated; ``w_in`` (E_local, d, d_ff) and ``w_out`` (E_local,
    d_ff, d).  ``k``: experts per token (1: switch routing; 2: each
    token to its two best experts, combined with renormalized gates).
    ``activation`` defaults to relu."""

    def __init__(self, axis='expert', capacity_factor=1.25, activation=None,
                 k=1):
        if k < 1:
            raise ValueError('k must be >= 1')
        self.axis = axis
        self.capacity_factor = capacity_factor
        self.activation = activation or torch.relu
        self.k = k

    def init_params(self, seed, d_model, d_ff, n_experts_total, n_devices):
        """The GLOBAL parameter tree as numpy arrays, drawn from
        ``seed`` (an int): shard ``w_in`` / ``w_out`` with
        ``MeshPlan.expert_param_specs`` (leading experts dim) and
        replicate the router.  The JAX layer draws from a
        ``jax.random`` key; the scales are its own."""
        if n_experts_total % n_devices:
            raise ValueError('experts must divide devices')
        rng = np.random.RandomState(seed)
        return {
            'router': (rng.standard_normal((d_model, n_experts_total))
                       * 0.02).astype(np.float32),
            'w_in': (rng.standard_normal((n_experts_total, d_model, d_ff))
                     * d_model ** -0.5).astype(np.float32),
            'w_out': (rng.standard_normal((n_experts_total, d_ff, d_model))
                      * d_ff ** -0.5).astype(np.float32),
        }

    def __call__(self, params, x):
        """``x`` (tokens_local, d) -> ``(y, {'aux_loss',
        'dropped_fraction'})``, with the axis bound (``with
        plan.bind():``); every process of the axis calls it in step."""
        ax = resolve_axis(self.axis)
        k = self.k
        n_dev = ax.size
        tokens, d_model = x.shape
        n_experts = params['router'].shape[-1]
        local_experts = n_experts // n_dev
        capacity = max(1, int(self.capacity_factor * tokens * k
                              // n_experts))

        probs, expert_idx, gate = _route(params, x, k)     # (T, k) each
        # the k assignments dispatch as T*k rows, token-major, so within
        # an expert earlier tokens win the capacity race
        idx_flat = expert_idx.reshape(tokens * k)
        x_rep = x.repeat_interleave(k, 0) if k > 1 else x
        expert_in, combine, keep = sort_dispatch(x_rep, idx_flat, n_experts,
                                                 capacity)
        gate = gate * keep.reshape(tokens, k).to(gate.dtype)

        # the rows to the process that owns their expert
        expert_in = expert_in.reshape(n_dev, local_experts, capacity,
                                      d_model)
        expert_in = all_to_all(expert_in, self.axis, 0, 0)
        # (n_dev, local, C, d): every process's rows for MY experts
        expert_in = expert_in.transpose(0, 1).reshape(
            local_experts, n_dev * capacity, d_model)
        h = self.activation(torch.bmm(expert_in, params['w_in']))
        out = torch.bmm(h, params['w_out'])
        out = out.reshape(local_experts, n_dev, capacity, d_model)
        out = all_to_all(out.transpose(0, 1), self.axis, 0, 0)
        out = out.reshape(n_experts, capacity, d_model)
        y_flat = combine(out)                              # (T*k, d)
        y = torch.einsum('tkd,tk->td', y_flat.reshape(tokens, k, d_model),
                         gate.to(y_flat.dtype))

        # the switch / GShard load-balancing loss over all k assignments
        density = torch.zeros(n_experts, dtype=torch.float32,
                              device=x.device).index_add(
            0, idx_flat, torch.ones(tokens * k, device=x.device)) \
            / (tokens * k)
        aux = torch.sum(density * probs.mean(0)) * n_experts
        return y, {'aux_loss': aux,
                   'dropped_fraction': 1.0 - keep.to(torch.float32).mean()}


def moe_transformer_block(x, params, layer, n_heads, causal=True,
                          layer_norm=None, attn_fn=None):
    """A transformer block whose feed-forward is the switch MoE: LN ->
    attention -> residual -> LN -> MoE FFN -> residual.

    The batch is sharded over ``layer.axis`` (the expert axis owns the
    experts and the batch, the standard EP layout); attention weights are
    replicated and each process attends over its own token shard through
    :func:`~chainermn_tpu_torch.parallel.tensor.qkv_attention` (the
    flash kernels on CUDA tensors), LayerNorm through ``layer_norm``
    (default ``ops.layer_norm``, the LayerNorm kernel on CUDA tensors),
    and the MoE FFN dispatches the flattened ``(B_local * T, d)`` rows.

    ``params``: ``ln1_scale/ln1_bias``, ``wqkv`` (d, 3, H, d_head),
    ``wo`` (H*d_head, d), ``bo``, ``ln2_scale/ln2_bias`` (replicated),
    and ``moe`` (this process's shard of :meth:`MoELayer.init_params`).
    Returns ``(y, aux)``; add ``aux['aux_loss']`` (scaled) to the
    loss."""
    if layer_norm is None:
        from chainermn_tpu_torch import ops
        layer_norm = ops.layer_norm
    if params['wqkv'].shape[2] != n_heads:
        raise ValueError('wqkv carries %d heads but n_heads=%d'
                         % (params['wqkv'].shape[2], n_heads))
    b, t, d = x.shape
    h = layer_norm(x, params['ln1_scale'], params['ln1_bias'])
    attn = qkv_attention(h, params['wqkv'], causal=causal, attn_fn=attn_fn)
    x = x + (attn @ params['wo'] + params['bo'])
    h = layer_norm(x, params['ln2_scale'], params['ln2_bias'])
    y_flat, aux = layer(params['moe'], h.reshape(b * t, d))
    return x + y_flat.reshape(b, t, d), aux
