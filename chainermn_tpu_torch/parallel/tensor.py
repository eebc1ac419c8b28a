"""Tensor (operator) parallelism primitives.

Counterpart of ``chainermn_tpu/parallel/tensor.py``: the Megatron pair of
a column-parallel projection (weights split on the output dim, no
communication in) and a row-parallel one (weights split on the input
dim, one sum over the axis out), and the blocks built from them.  Each
process holds its own shard as an ordinary tensor; an axis name resolves
to its process group through the bound mesh
(:func:`~chainermn_tpu_torch.parallel.meshplan.resolve_axis`).

Gradients.  Every process runs its own backward.  Two conventions hold
a block differentiated per process to the unsharded oracle, as in the
JAX package:

- the conjugate pair (:func:`tp_copy` at a region's entry,
  :func:`tp_reduce` at its exit; ``row_parallel_dense(grad_conjugate=
  True)``), the updaters' mode: the loss is replicated over the axis,
  every process seeds its backward with 1, and each parameter's gradient
  comes out exact on every process, a shard's for its shard, a
  replicated parameter's replicated;
- the raw sum (:func:`psum`, the default of ``row_parallel_dense``),
  whose backward is a sum too, as ``lax.psum``'s transpose is inside
  ``shard_map``: that is the gradient JAX takes from OUTSIDE a mapped
  function when each process seeds its backward with its share of the
  global loss (1/n of a replicated one) and a replicated input's
  gradients are summed over the axis afterwards
  (``parallel.sequence.mapped_global_loss`` seeds so).

The JAX package's telemetry marks (``tensor:tp_reduce``) are trace-time
events of a compiled step; they have no eager counterpart here.
"""

import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch.parallel.meshplan import resolve_axis


def _all_reduce(x, axis):
    out = x.contiguous().clone()
    dist.all_reduce(out, group=axis.group)
    return out


class _Reduce(torch.autograd.Function):
    """Sum over the axis forward; ``backward`` is the identity
    (``conjugate``) or the sum again (the raw transpose)."""

    #: the collective's name for ``parallel.pipeline``'s 1F1B guard, which
    #: reads ``axis`` (and ``conjugate``) off the backward node
    cmn_collective = 'psum'

    @staticmethod
    def forward(ctx, x, axis, conjugate):
        ctx.axis, ctx.conjugate = axis, conjugate
        return _all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.conjugate:
            return g, None, None
        return _all_reduce(g, ctx.axis), None, None


class _Copy(torch.autograd.Function):
    """Identity forward; the sum over the axis backward."""

    cmn_collective = 'tp_copy'

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.axis), None


def psum(x, axis):
    """``lax.psum`` over ``axis``: the sum of every process's ``x``; its
    backward sums the cotangents as well."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x
    return _Reduce.apply(x, ax, False)


def tp_reduce(x, axis):
    """Megatron ``g``: exit a tensor-parallel region.  Forward sums over
    ``axis`` (completes the sharded contraction); backward is the
    identity: the downstream cotangent is already replicated over the
    axis, and a summed transpose would scale it by the axis size."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x
    return _Reduce.apply(x, ax, True)


def tp_copy(x, axis):
    """Megatron ``f``: enter a tensor-parallel region with a replicated
    activation.  Forward is the identity; backward sums the cotangents
    over ``axis``: each process's backward computes only its own weight
    shard's contribution to dL/dx, and the residual stream (and every
    parameter upstream) needs their sum."""
    ax = resolve_axis(axis)
    if ax.size == 1:
        return x
    return _Copy.apply(x, ax)


def column_parallel_dense(x, w, b=None):
    """``y_local = x @ w_local``: ``w`` sharded on its columns (the
    output dim); the output stays sharded on the feature dim, no
    collective."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def row_parallel_dense(x_local, w, axis, b=None, grad_conjugate=False):
    """``y = psum_axis(x_local @ w_local)``: ``w`` sharded on its rows
    (the input dim), the input feature-sharded from a column-parallel
    layer; the sum completes the logical matmul, and the bias is added
    once, after it.  ``grad_conjugate=True`` exits through
    :func:`tp_reduce` (identity backward) instead of :func:`psum`: the
    updaters' mode, paired with :func:`tp_copy` at the region's entry
    (see the module docstring)."""
    y = x_local @ w
    y = tp_reduce(y, axis) if grad_conjugate else psum(y, axis)
    if b is not None:
        y = y + b
    return y


def tp_mlp(x, w_in, b_in, w_out, b_out, axis, activation=torch.tanh,
           grad_conjugate=False):
    """Column -> activation -> row feed-forward with one sum in all.
    ``activation=None`` gives a purely linear block.
    ``grad_conjugate=True``: the region enters through :func:`tp_copy`
    and exits through :func:`tp_reduce` (the updaters' mode, see the
    module docstring)."""
    if grad_conjugate:
        x = tp_copy(x, axis)
    h = column_parallel_dense(x, w_in, b_in)
    if activation is not None:
        h = activation(h)
    return row_parallel_dense(h, w_out, axis, b_out,
                              grad_conjugate=grad_conjugate)


def qkv_attention(x, wqkv, causal=False, attn_fn=None, bqkv=None):
    """The fused QKV projection (``wqkv`` ``(d_model, 3, heads,
    d_head)``, optional ``bqkv`` ``(3, heads, d_head)``) -> attention ->
    heads re-flattened, ``(B, T, heads * d_head)``; with the LOCAL head
    group under tensor parallelism.  ``attn_fn(q, k, v, causal=)``
    defaults to ``ops.flash_attention`` (the flash kernels on CUDA
    tensors); q, k and v are views of the one ``qkv`` tensor, strided
    with a contiguous head dim, which the kernels read as they are."""
    d = wqkv.shape[0]
    qkv = (x @ wqkv.reshape(d, -1)).reshape(x.shape[:-1] + wqkv.shape[1:])
    if bqkv is not None:
        qkv = qkv + bqkv
    if attn_fn is None:
        from chainermn_tpu_torch import ops
        attn_fn = ops.flash_attention
    attn = attn_fn(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], causal=causal)
    return attn.reshape(attn.shape[:2] + (-1,))


def tp_attention(x, wqkv, wo, axis, n_heads, causal=False, bo=None,
                 attn_fn=None, grad_conjugate=False):
    """Megatron-sharded self-attention, one sum per block: the QKV
    projection is column-parallel with HEADS as the sharded unit
    (``wqkv`` ``(d_model, 3, local_heads, d_head)``), each process
    attends over its own head group, and the output projection is
    row-parallel (``wo`` ``(local_heads * d_head, d_model)``).  Needs
    ``n_heads % axis_size == 0``.  ``x`` ``(B, T, d_model)`` is
    replicated over ``axis``; so is the result.  ``grad_conjugate``: as
    :func:`tp_mlp`'s."""
    p = resolve_axis(axis).size
    if n_heads % p:
        raise ValueError('tp_attention needs n_heads %% axis_size '
                         '== 0, got %d heads over %d devices'
                         % (n_heads, p))
    if wqkv.shape[2] * p != n_heads:
        raise ValueError('wqkv carries %d local heads on %d devices '
                         'but n_heads=%d'
                         % (wqkv.shape[2], p, n_heads))
    if grad_conjugate:
        x = tp_copy(x, axis)
    attn = qkv_attention(x, wqkv, causal=causal, attn_fn=attn_fn)
    return row_parallel_dense(attn, wo, axis, bo,
                              grad_conjugate=grad_conjugate)


def _gelu(x):
    # flax's nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate='tanh')


def tp_transformer_block(x, params, axis, n_heads, causal=True,
                         layer_norm=None, grad_conjugate=False):
    """A full Megatron block: LN -> TP attention -> residual -> LN -> TP
    MLP -> residual, two sums per block.  ``params``:
    ``ln1_scale/ln1_bias/wqkv/wo/bo`` and
    ``ln2_scale/ln2_bias/w_in/b_in/w_out/b_out`` (``b_in`` sharded with
    ``w_in``'s columns, ``bo`` / ``b_out`` replicated).  ``layer_norm``
    defaults to ``ops.layer_norm`` (the LayerNorm kernel on CUDA
    tensors).  ``grad_conjugate=True`` runs both halves through the
    conjugate pair (what a pipeline stage, whose every process seeds its
    own copy of the loss, needs)."""
    if layer_norm is None:
        from chainermn_tpu_torch import ops
        layer_norm = ops.layer_norm
    h = layer_norm(x, params['ln1_scale'], params['ln1_bias'])
    x = x + tp_attention(h, params['wqkv'], params['wo'], axis, n_heads,
                         causal=causal, bo=params['bo'],
                         grad_conjugate=grad_conjugate)
    h = layer_norm(x, params['ln2_scale'], params['ln2_bias'])
    return x + tp_mlp(h, params['w_in'], params['b_in'], params['w_out'],
                      params['b_out'], axis, activation=_gelu,
                      grad_conjugate=grad_conjugate)
