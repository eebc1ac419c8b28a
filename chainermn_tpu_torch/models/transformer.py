"""Decoder-only transformer LM, its training loss and its serving
functions over a slot or a paged KV cache.

Counterpart of ``chainermn_tpu/models/transformer.py``: the same blocks
(pre-LayerNorm, fused qkv projection, causal flash attention, gelu MLP),
the same parameter tree, the next-token loss (:func:`lm_loss`,
:func:`lm_loss_sum`) over the fused cross-entropy, and module-level
serving functions that do the same arithmetic as
:meth:`TransformerLM.forward` over the same parameters: a slot cache
(:func:`init_kv_cache`, :func:`prefill`, :func:`decode_step`), a paged
cache (:func:`init_paged_kv_cache`, :func:`prefill_paged` for one
prompt chunk, :func:`decode_step_paged`), and the speculative verify
pass over either (:func:`spec_verify`, :func:`spec_verify_paged`).
:meth:`TransformerLM.forward` records gradients (LayerNorm, flash
attention and the cross-entropy each carry their backward); the serving
functions are inference: call them under ``torch.no_grad()``.

Parameters keep flax's names AND layouts (``qkv/kernel`` is ``(d, 3, H,
d_head)``, a Dense ``kernel`` is ``(in, out)``), so a flax tree carries
over leaf for leaf (:mod:`flax_weights`).  The master parameters are
float32; ``dtype`` is the compute dtype every matmul runs in, and the
LM head is a float32 product over activations first rounded to
``dtype``, as in the JAX package.

The parallel axes (:mod:`chainermn_tpu_torch.parallel`): ``tp_axis``
(Megatron tensor parallelism, with :func:`tp_param_specs` /
:func:`tp_oracle`) and ``sequence_axis`` (ring or Ulysses attention)
train, and :func:`pipeline_parts` / :func:`pipeline_stage_specs` split
the model into pipeline stages; the serving functions take an unsharded
model.  Not ported yet
(they raise ``NotImplementedError``): dropout (ROADMAP.md A6) and a
tensor-parallel cache (A7; serving a ``tp_axis`` model is ROADMAP.md
item 9).
"""

import torch
import torch.nn.functional as F
from torch import nn

from chainermn_tpu_torch import ops
from chainermn_tpu_torch.models.flax_weights import (
    param_tree, shard_leaf, shard_variables)
from chainermn_tpu_torch.ops._common import resolve_device
from chainermn_tpu_torch.precision import dequantize_kv, quantize_kv


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


def _check_options(sequence_axis, tp_axis, dropout, sp_scheme, where):
    if tp_axis is not None and sequence_axis is not None:
        raise ValueError(
            'tp_axis and sequence_axis cannot both be set on one block'
            if where == 'block' else
            'tp_axis and sequence_axis cannot both be set (compose tp with '
            'data/pipeline axes via MeshPlan instead)')
    if tp_axis is not None and dropout > 0:
        raise ValueError('tp_axis blocks run without dropout (per-rank rng '
                         'divergence would silently break the head groups); '
                         'build with dropout=0.0')
    if dropout:
        raise NotImplementedError(
            'dropout is not ported yet (ROADMAP.md A6)')
    if sp_scheme not in ('ring', 'ulysses'):
        raise ValueError("sp_scheme must be 'ring' or 'ulysses', got %r"
                         % (sp_scheme,))


def _lookup(tree, path):
    for part in path:
        tree = tree[part]
    return tree


@torch.no_grad()
def _keep_shards(module, specs, mesh, names=None):
    """Replace ``module``'s parameters (those under ``names``, default
    all) by this process's shards of them on ``mesh``, in place."""
    for key, p in list(module.named_parameters()):
        path = key.split('.')
        if names is not None and path[0] not in names:
            continue
        spec = _lookup(specs, path)
        if all(e is None for e in spec):
            continue
        owner = module.get_submodule('.'.join(path[:-1]))
        setattr(owner, path[-1],
                nn.Parameter(shard_leaf(p.data, spec, mesh).clone()))


def _tp_mesh(tp_axis):
    """The bound mesh of ``tp_axis`` and ``(size, index)`` on it."""
    from chainermn_tpu_torch.parallel.meshplan import bound_mesh
    mesh = bound_mesh(tp_axis)
    return mesh, mesh.axis_size(tp_axis), mesh.axis_index(tp_axis)


class TransformerBlock(nn.Module):
    """Pre-LN block: LN -> qkv -> causal flash attention -> proj
    residual -> LN -> gelu MLP residual.

    ``sequence_axis``: the tokens are sharded over that mesh axis, and
    attention is ``parallel.ring_attention`` or ``ulysses_attention``
    (``sp_scheme``) over it.  ``tp_axis``: Megatron tensor parallelism
    over that axis (heads and MLP columns split, one sum per half-block,
    through the conjugate ``tp_copy`` / ``tp_reduce`` pair); the axis is
    resolved in the bound mesh when the block is built (its parameters
    are this process's shards of the unsharded block's, made from the
    same generator) and again at every call."""

    def __init__(self, d_model, n_heads, d_ff, dtype=torch.bfloat16,
                 sequence_axis=None, dropout=0.0, tp_axis=None,
                 generator=None, sp_scheme='ring'):
        super().__init__()
        _check_options(sequence_axis, tp_axis, dropout, sp_scheme, 'block')
        self.d_model = d_model
        self.n_heads = n_heads
        self.d_ff = d_ff
        self.dtype = dtype
        self.sequence_axis = sequence_axis
        self.sp_scheme = sp_scheme
        self.tp_axis = tp_axis
        self.ln1_scale = nn.Parameter(torch.ones(d_model))
        self.ln1_bias = nn.Parameter(torch.zeros(d_model))
        self.qkv = QKV(d_model, n_heads, dtype, generator)
        self.proj = Dense(d_model, d_model, dtype, generator)
        self.ln2_scale = nn.Parameter(torch.ones(d_model))
        self.ln2_bias = nn.Parameter(torch.zeros(d_model))
        self.ff_in = Dense(d_model, d_ff, dtype, generator)
        self.ff_out = Dense(d_ff, d_model, dtype, generator)
        self.tp_size, self.tp_index = 1, 0
        if tp_axis is not None:
            mesh, tp, index = _tp_mesh(tp_axis)
            if n_heads % tp or d_ff % tp:
                raise ValueError(
                    'tp_axis=%r of size %d must divide n_heads=%d and '
                    'd_ff=%d' % (tp_axis, tp, n_heads, d_ff))
            self.tp_size, self.tp_index = tp, index
            _keep_shards(self, tp_param_specs(param_tree(self), tp_axis),
                         mesh)

    def forward(self, x):
        if self.tp_axis is not None and _tp_mesh(self.tp_axis)[1:] != (
                self.tp_size, self.tp_index):
            raise ValueError('the block was built for place %d of %d on '
                             'tp_axis=%r; the bound mesh says %r'
                             % (self.tp_index, self.tp_size, self.tp_axis,
                                _tp_mesh(self.tp_axis)[1:]))
        p = {'ln1_scale': self.ln1_scale, 'ln1_bias': self.ln1_bias,
             'qkv': {'kernel': self.qkv.kernel, 'bias': self.qkv.bias},
             'proj': {'kernel': self.proj.kernel, 'bias': self.proj.bias},
             'ln2_scale': self.ln2_scale, 'ln2_bias': self.ln2_bias,
             'ff_in': {'kernel': self.ff_in.kernel, 'bias': self.ff_in.bias},
             'ff_out': {'kernel': self.ff_out.kernel,
                        'bias': self.ff_out.bias}}
        return block_forward(p, x, self.dtype, tp_axis=self.tp_axis,
                             sequence_axis=self.sequence_axis,
                             sp_scheme=self.sp_scheme)


def block_forward(p, x, dtype, tp_axis=None, sequence_axis=None,
                  sp_scheme='ring'):
    """A :class:`TransformerBlock`'s forward over its parameter tree ``p``
    (the flax names: ``ln1_scale``, ``qkv/kernel``, ...; with ``tp_axis``
    this process's shards): what the block's ``forward`` runs, and what a
    pipeline stage (:func:`pipeline_parts`) runs over each row of its
    stacked tree without a module."""
    if tp_axis is not None:
        return _tp_block(p, x, dtype, tp_axis)
    h = ops.layer_norm(x, p['ln1_scale'], p['ln1_bias']).to(dtype)
    qkv = _qkv_proj(h, p, dtype)                 # (B, T, 3, H, d_head)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if sequence_axis is not None:
        from chainermn_tpu_torch.parallel import sequence
        sp = (sequence.ulysses_attention if sp_scheme == 'ulysses'
              else sequence.ring_attention)
        attn = sp(q, k, v, sequence_axis, causal=True)
    else:
        attn = ops.flash_attention(q, k, v, causal=True)
    x = x + _dense(attn.reshape(attn.shape[:2] + (-1,)), p['proj'], dtype)
    h = ops.layer_norm(x, p['ln2_scale'], p['ln2_bias']).to(dtype)
    return x + _mlp(h, p, dtype)


def _tp_block(p, x, dt, axis):
    """The Megatron-sharded block (the JAX block's ``_tp_call``)."""
    from chainermn_tpu_torch.parallel import tensor
    h = ops.layer_norm(x, p['ln1_scale'], p['ln1_bias']).to(dt)
    h = tensor.tp_copy(h, axis)
    attn = tensor.qkv_attention(h, p['qkv']['kernel'].to(dt), causal=True,
                                bqkv=p['qkv']['bias'].to(dt))
    x = x + tensor.row_parallel_dense(
        attn, p['proj']['kernel'].to(dt), axis, p['proj']['bias'].to(dt),
        grad_conjugate=True)
    h = ops.layer_norm(x, p['ln2_scale'], p['ln2_bias']).to(dt)
    h = tensor.tp_copy(h, axis)
    g = _gelu(tensor.column_parallel_dense(
        h, p['ff_in']['kernel'].to(dt), p['ff_in']['bias'].to(dt)))
    return x + tensor.row_parallel_dense(
        g, p['ff_out']['kernel'].to(dt), axis, p['ff_out']['bias'].to(dt),
        grad_conjugate=True)


class TransformerLM(nn.Module):
    """Causal LM: ``tokens`` ``(B, T)`` int -> logits ``(B, T, V)`` f32.

    Parameters are made on the CPU from ``generator`` (default: seed 0)
    and moved to ``device`` (default: the current CUDA device; raises
    when there is none).

    ``sequence_axis``: call with the tokens of this process's sequence
    shard; position embeddings are offset by the shard's global start,
    and every block attends over the axis (``sp_scheme`` ``'ring'`` or
    ``'ulysses'``).  ``tp_axis`` (exclusive with ``sequence_axis``):
    Megatron tensor parallelism; build and call the model with a mesh
    that binds the axis (``with plan.bind():``, or a ``StandardUpdater``
    over ``plan.communicator()``).  Heads and MLP columns split over the
    axis, the embedding table is vocab-row-sharded (a masked local
    lookup and one sum) and the vocab projection row-parallel over
    ``d_model``.  The parameters keep the unsharded model's names, each
    holding this process's shard (``param_specs``, the
    :func:`tp_param_specs` of the full tree); ``load_flax_variables``
    takes the FULL (oracle) tree and keeps the shard, and
    ``StandardUpdater.params`` gathers the shards back.  Activations are
    replicated over the axis, so the batch is sharded over the data axis
    only."""

    def __init__(self, vocab_size=32000, d_model=512, n_heads=8,
                 n_layers=6, d_ff=2048, max_len=32768, dtype=torch.bfloat16,
                 sequence_axis=None, dropout=0.0, sp_scheme='ring',
                 tp_axis=None, device=None, generator=None):
        super().__init__()
        _check_options(sequence_axis, tp_axis, dropout, sp_scheme, 'lm')
        if d_model % n_heads:
            raise ValueError('n_heads=%d must divide d_model=%d'
                             % (n_heads, d_model))
        mesh, tp, index = ((None, 1, 0) if tp_axis is None
                           else _tp_mesh(tp_axis))
        if vocab_size % tp or d_model % tp:
            raise ValueError(
                'tp_axis=%r of size %d must divide vocab_size=%d and '
                'd_model=%d' % (tp_axis, tp, vocab_size, d_model))
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
        self.sequence_axis = sequence_axis
        self.sp_scheme = sp_scheme
        self.tp_axis = tp_axis
        self.tp_size, self.tp_index, self.tp_mesh = tp, index, mesh
        self.embed = Embed(vocab_size, d_model, dtype, generator)
        self.pos_embed = _trunc_normal((max_len, d_model), 0.02, generator)
        for i in range(n_layers):
            setattr(self, 'block_%d' % i, TransformerBlock(
                d_model, n_heads, d_ff, dtype, sequence_axis,
                tp_axis=tp_axis, generator=generator, sp_scheme=sp_scheme))
        self.lnf_scale = nn.Parameter(torch.ones(d_model))
        self.lnf_bias = nn.Parameter(torch.zeros(d_model))
        self.lm_head = Dense(d_model, vocab_size, torch.float32, generator)
        self.param_specs = None
        if tp_axis is not None:
            # the specs depend on names and ranks alone: the blocks are
            # cut already, the embedding and the head now
            self.param_specs = tp_param_specs(param_tree(self), tp_axis)
            _keep_shards(self, self.param_specs, mesh,
                         names=('embed', 'lm_head'))
        self.to(device)

    def shard_flax_variables(self, variables):
        """The full flax tree -> this process's shard of it (identity
        without ``tp_axis``); ``load_flax_variables`` calls it."""
        if self.tp_axis is None:
            return variables
        return dict(variables, params=shard_variables(
            variables['params'], self.param_specs, self.tp_mesh))

    def forward(self, tokens):
        t = tokens.shape[1]
        if self.tp_axis is not None:
            x = self._tp_embed(tokens)
        else:
            x = self.embed(tokens)
        pos0 = 0
        if self.sequence_axis is not None:
            from chainermn_tpu_torch.parallel.meshplan import resolve_axis
            pos0 = resolve_axis(self.sequence_axis).index * t
        x = x + self.pos_embed[pos0:pos0 + t].to(self.dtype)
        for i in range(self.n_layers):
            x = getattr(self, 'block_%d' % i)(x)
        x = ops.layer_norm(x, self.lnf_scale, self.lnf_bias)
        if self.tp_axis is not None:
            return self._tp_head(x)
        return self.lm_head(x.to(self.dtype))

    def _tp_embed(self, tokens):
        """Vocab-row-sharded lookup: this process owns rows ``[r*V/tp,
        (r+1)*V/tp)``; off-shard tokens give zeros, and one sum
        (``tp_reduce``: identity backward, so the local rows get exactly
        their own gradients) completes the lookup."""
        from chainermn_tpu_torch.parallel import tensor
        table = self.embed.embedding
        v_local = table.shape[0]
        local = tokens.long() - self.tp_index * v_local
        in_shard = (local >= 0) & (local < v_local)
        rows = _embed(table, local.clamp(0, v_local - 1), table.dtype)
        x = torch.where(in_shard[..., None], rows,
                        rows.new_zeros(())).to(self.dtype)
        # exact in any dtype: per token exactly one process is nonzero
        return tensor.tp_reduce(x, self.tp_axis)

    def _tp_head(self, x):
        """Row-parallel vocab projection: ``d_model`` sliced per
        process, the f32 contraction completed by one sum, the bias
        added once after it."""
        from chainermn_tpu_torch.parallel import tensor
        d_local = self.d_model // self.tp_size
        xh = tensor.tp_copy(x.to(self.dtype), self.tp_axis)
        x_local = xh[..., self.tp_index * d_local:
                     (self.tp_index + 1) * d_local]
        return tensor.row_parallel_dense(
            x_local.to(torch.float32),
            self.lm_head.kernel.to(torch.float32), self.tp_axis,
            self.lm_head.bias, grad_conjugate=True)


def tp_oracle(model, device=None):
    """The unsharded twin of a ``tp_axis`` model: the same
    configuration with ``tp_axis=None``, made from the default generator
    (whose weights are the tensor-parallel model's gathered, when it was
    made from the default generator too).  On ``device`` (default: the
    model's)."""
    if device is None:
        device = model.lnf_scale.device
    return TransformerLM(model.vocab_size, model.d_model, model.n_heads,
                         model.n_layers, model.d_ff, model.max_len,
                         model.dtype, sp_scheme=model.sp_scheme,
                         device=device)


def tp_param_specs(params, axis='model'):
    """The spec tree of a ``TransformerLM(tp_axis=axis)`` parameter tree
    (which is the unsharded model's tree): attention heads and MLP
    columns / rows on ``axis``, embedding rows on the vocab dim,
    ``lm_head`` rows on ``d_model``, everything else (layer norms, the
    position table, the biases added after a sum) replicated, ``()``.
    A spec is a tuple of None / axis name per leading dim, the JAX
    ``PartitionSpec``'s entries; ``models.shard_variables`` cuts a
    process's shard of a full tree with it, ``gather_variables`` gathers
    the shards back."""

    def one(path, leaf):
        nd = leaf.ndim
        if 'embedding' in path:
            return (axis, None)
        if 'qkv' in path:
            return ((None, None, axis, None) if nd == 4
                    else (None, axis, None))
        if 'ff_in' in path:
            return (None, axis) if nd == 2 else (axis,)
        if 'ff_out' in path or 'proj' in path or 'lm_head' in path:
            # row-parallel kernels; their biases ride after the sum,
            # replicated
            return (axis, None) if nd == 2 else ()
        return ()

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        return one(path, tree)

    return walk(params, ())


def pipeline_parts(model, params=None, n_stages=1, pad_id=-1,
                   tp_axis=None, local_loss=False):
    """Split a ``TransformerLM`` into the pieces of
    :class:`~chainermn_tpu_torch.training.PipelineUpdater` /
    ``MeshPipelineUpdater``: ``(stage_fn, prologue, loss_on_last,
    params_stacked, extra)``, as the JAX function does.

    ``params``: the model's flax parameter tree (nested dicts of numpy
    arrays; default: the model's own).  The block stack becomes the
    stage-stacked body, numpy leaves ``(n_stages, n_layers / n_stages,
    ...)`` in the JAX layout (``block_i``'s leaves at ``[i // n, i %
    n]``); the embedding, the position table, the final norm and the
    head become the replicated ``extra`` tree.  The pipelined
    composition computes what ``model`` and :func:`lm_loss` compute with
    the same parameters, through the same kernels: ``stage_fn`` runs
    this stage's blocks (:func:`block_forward` over each row of its
    stacked tree), ``prologue`` the embedding lookup and positions,
    ``loss_on_last`` the final norm (``ops.layer_norm``), the f32 head
    and ``ops.softmax_cross_entropy``.

    ``model`` must have ``sequence_axis=None`` and ``tp_axis=None`` (the
    tree is the unsharded one) and no dropout.  ``tp_axis`` (a plan's
    ``model`` axis) makes the stage body tensor-parallel: each block runs
    the Megatron path (the conjugate pair) over the bound mesh (the
    updater binds it), its leaves sharded by :func:`pipeline_stage_specs`.

    ``loss_on_last`` is the GLOBAL masked mean: the sums over the data
    axis come before the division, each a ``parallel.psum`` (whose
    backward sums, so the updater's mean of the gradients over data is
    the global loss's gradient, nothing counted twice); it needs the
    gpipe schedule.  ``local_loss=True`` gives the collective-free local
    masked mean (1F1B), exact whenever every data replica holds the same
    number of valid tokens (always at ``pad_id=-1``)."""
    if model.sequence_axis is not None:
        raise ValueError('pipeline_parts shards the batch dimension; '
                         'build the model with sequence_axis=None')
    if model.tp_axis is not None:
        raise ValueError('pipeline_parts expects the unsharded block '
                         'body; build the model with tp_axis=None '
                         '(stage-internal tensor parallelism is the '
                         'tp_axis= argument HERE, over the oracle '
                         'parameter tree)')
    if getattr(model, 'dropout', 0.0):
        raise ValueError('pipeline_parts runs the blocks without '
                         'dropout rngs; build the model with '
                         'dropout=0.0 (training would otherwise '
                         'silently drop the regularization the '
                         'unpipelined run applies)')
    if model.n_layers % n_stages:
        raise ValueError('%d layers do not split into %d stages'
                         % (model.n_layers, n_stages))
    from chainermn_tpu_torch.models.flax_weights import to_flax_variables
    from chainermn_tpu_torch.parallel.pipeline import stack_stage_params
    if params is None:
        params = to_flax_variables(model)['params']
    n_per = model.n_layers // n_stages
    layers = [params['block_%d' % i] for i in range(model.n_layers)]
    params_stacked = stack_stage_params([
        stack_stage_params(layers[s * n_per:(s + 1) * n_per])
        for s in range(n_stages)])
    extra = {'embedding': params['embed']['embedding'],
             'pos_embed': params['pos_embed'],
             'lnf_scale': params['lnf_scale'],
             'lnf_bias': params['lnf_bias'],
             'lm_head': params['lm_head']}
    def stage_fn(p_stage, x):
        for j in range(n_per):
            x = block_forward(_rows(p_stage, j), x, model.dtype,
                              tp_axis=tp_axis)
        return x

    def prologue(e, tokens):
        x = _embed(e['embedding'], tokens, model.dtype)
        return x + e['pos_embed'][:tokens.shape[1]].to(model.dtype)

    def masked_ce(e, outs, y_micro):
        h = ops.layer_norm(outs, e['lnf_scale'],
                           e['lnf_bias']).to(model.dtype)
        logits = (h.to(torch.float32)
                  @ e['lm_head']['kernel'].to(torch.float32)
                  + e['lm_head']['bias'])
        flat = logits.reshape(-1, logits.shape[-1])
        yy = y_micro.reshape(-1).to(torch.int32)
        ce = ops.softmax_cross_entropy(flat, yy)
        mask = (yy != pad_id).to(torch.float32)
        return (ce * mask).sum(), mask.sum()

    def loss_on_last(e, outs, y_micro):
        from chainermn_tpu_torch.parallel import tensor
        total, n = masked_ce(e, outs, y_micro)
        total = tensor.psum(total, 'data')
        n = tensor.psum(n.detach(), 'data').clamp_min(1.0)
        loss = total / n
        return loss, {'perp': torch.exp(loss.detach().clamp_max(20.0))}

    def local_loss_on_last(e, outs, y_micro):
        total, n = masked_ce(e, outs, y_micro)
        loss = total / n.clamp_min(1.0)
        return loss, {'perp': torch.exp(loss.detach().clamp_max(20.0))}

    return (stage_fn, prologue,
            local_loss_on_last if local_loss else loss_on_last,
            params_stacked, extra)


def _rows(tree, j):
    """Row ``j`` of every leaf of a stacked tree (views)."""
    return {k: _rows(v, j) if isinstance(v, dict) else v[j]
            for k, v in tree.items()}


def pipeline_stage_specs(params_stacked, pipe_axis='pipe', tp_axis=None):
    """The spec tree of a :func:`pipeline_parts` stacked stage tree:
    every leaf leads with ``pipe_axis``; with ``tp_axis`` the block's
    dims shard as :func:`tp_param_specs` shards one unstacked block,
    behind the two stacking dims ``(n_stages, layers_per_stage)``
    (``(pipe_axis, None) + spec``; a replicated leaf is
    ``(pipe_axis,)``)."""
    if tp_axis is None:
        return _map_leaves(lambda leaf: (pipe_axis,), params_stacked)
    block = tp_param_specs(_rows(_rows(params_stacked, 0), 0), tp_axis)
    return _map_leaves(lambda spec: (pipe_axis, None) + spec if spec
                       else (pipe_axis,), block)


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


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
    return _zero_cache(model, (int(n_slots), int(max_len or model.max_len)),
                       dtype, int8_kv, device)


def _zero_cache(model, slab, dtype, int8_kv, device):
    """``{'k'|'v': (n_layers, *slab, H, d_head)}`` zeros in ``dtype``
    (default ``model.dtype``), or int8 with f32 ``k_scale`` / ``v_scale``
    ``(n_layers, *slab, H)``."""
    if getattr(model, 'tp_axis', None) is not None:
        raise NotImplementedError(
            'serving a tp_axis model (a tensor-parallel cache) is not '
            'ported yet (ROADMAP.md A7)')
    device = resolve_device(device)
    shape = (model.n_layers,) + slab + (model.n_heads,
                                        model.d_model // model.n_heads)
    if int8_kv:
        return {'k': torch.zeros(shape, dtype=torch.int8, device=device),
                'v': torch.zeros(shape, dtype=torch.int8, device=device),
                'k_scale': torch.zeros(shape[:-1], device=device),
                'v_scale': torch.zeros(shape[:-1], device=device)}
    dtype = dtype or model.dtype
    return {'k': torch.zeros(shape, dtype=dtype, device=device),
            'v': torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_kv_cache(model, n_pages, page_size, dtype=None, tp=1,
                        int8_kv=False, device=None):
    """Zeroed PAGED KV cache: a pool of ``n_pages`` pages of
    ``page_size`` positions each, shared by every sequence:
    ``{'k'|'v': (n_layers, n_pages, page_size, H, d_head)}`` (+
    ``'k_scale'`` / ``'v_scale'`` ``(n_layers, n_pages, page_size, H)``
    float32 under ``int8_kv``), on ``device`` (default: the current CUDA
    device).  Sequences address it through page tables
    (:func:`decode_step_paged`, :func:`prefill_paged`); allocation,
    sharing and copy-on-write are host code in
    :mod:`chainermn_tpu_torch.serving.paged`.  Page 0 is the allocator's
    scratch page: pad rows write there and no live table points at it.
    Pages are reused without zeroing: reads mask by the live length."""
    if tp != 1:
        raise NotImplementedError(
            'a tensor-parallel cache is not ported yet (ROADMAP.md A7)')
    return _zero_cache(model, (int(n_pages), int(page_size)), dtype,
                       int8_kv, device)


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
    return _scatter_kv(cache, layer, k_new, v_new, rows, positions.long())


def _scatter_kv(cache, layer, k_new, v_new, idx0, idx1):
    """Write K/V ``(..., H, d_head)`` in place at ``(layer, idx0, idx1)``
    (slot and position, or page and offset; index tensors of the K/V's
    leading shape), quantized with their scales under int8."""
    if _cache_int8(cache):
        for name, val in (('k', k_new), ('v', v_new)):
            qv, scale = quantize_kv(val)
            cache[name][layer, idx0, idx1] = qv
            cache[name + '_scale'][layer, idx0, idx1] = scale
        return cache
    cache['k'][layer, idx0, idx1] = k_new.to(cache['k'].dtype)
    cache['v'][layer, idx0, idx1] = v_new.to(cache['v'].dtype)
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


def _index(value, device):
    """An int, or an integer tensor of one element, as a ``(1,)`` int64
    tensor on ``device``: the scalar operands of the prefill functions,
    which index the cache and the activations on the device (the JAX
    body's ``dynamic_slice``), so that a CUDA graph captured over them
    reads each call's values and nothing waits for the host."""
    return torch.as_tensor(value, device=device).reshape(1).long()


def _last_row(x, length):
    """Row ``length - 1`` of ``x`` ``(1, T, d)`` as ``(1, d)``."""
    return x[0].index_select(0, length - 1)


def prefill(model, params, cache, tokens, length, slot):
    """Prefill one prompt into cache slot ``slot``: ``tokens`` ``(1, T)``
    padded to a prompt bucket, ``length`` the valid prefix (positions
    beyond it are written but never attended: decode lengths start at
    ``length``).  ``length`` and ``slot`` are ints or one-element integer
    tensors on the cache's device (no host read).  Runs the causal
    forward once, banks every layer's K/V at ``cache[:, slot, :T]`` in
    place, and returns ``(logits (V,) f32 at position length - 1,
    cache)``."""
    dtype = model.dtype
    b, t = tokens.shape
    if b != 1:
        raise ValueError('prefill takes one prompt per call, got batch %d'
                         % b)
    device = tokens.device
    length = _index(length, device)
    positions = torch.arange(t, device=device)
    slots = _index(slot, device).expand(t)
    x = _embed(params['embed']['embedding'], tokens, dtype)
    x = x + params['pos_embed'][:t].to(dtype)
    for i in range(model.n_layers):
        bp = params['block_%d' % i]
        h = ops.layer_norm(x, bp['ln1_scale'], bp['ln1_bias']).to(dtype)
        qkv = _qkv_proj(h, bp, dtype)            # (1, T, 3, H, d_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = ops.flash_attention(q, k, v, causal=True)
        _scatter_kv(cache, i, k[0], v[0], slots, positions)
        x = x + _dense(attn.reshape(1, t, -1), bp['proj'], dtype)
        h = ops.layer_norm(x, bp['ln2_scale'], bp['ln2_bias']).to(dtype)
        x = x + _mlp(h, bp, dtype)
    # the head only needs the last valid position's activation
    x_last = ops.layer_norm(_last_row(x, length), params['lnf_scale'],
                            params['lnf_bias'])
    return _head_logits(model, params, x_last)[0], cache


# ---------------------------------------------------------------------
# incremental decode: paged KV cache
#
# The pool of init_paged_kv_cache is read through per-sequence page
# tables: position p of a sequence lives at page table[p // page_size],
# offset p % page_size.  The arithmetic is the slot functions': only the
# write and the attention read go through the tables.

def decode_step_paged(model, params, cache, tokens, positions, page_tables):
    """One incremental decode step against a PAGED cache: ``tokens`` /
    ``positions`` ``(N,)`` as in :func:`decode_step`, ``page_tables``
    ``(N, n_max)`` int mapping row i's position ``p`` to page
    ``page_tables[i, p // page_size]``.  The entry covering
    ``positions[i]`` must be allocated; entries past the live prefix are
    never read (pad rows carry all-zero tables: they write and read the
    scratch page 0).  Returns ``(logits (N, V) f32, cache)``; the cache
    is updated in place."""
    ps = cache['k'].shape[2]
    positions = positions.long()
    lengths = (positions + 1).to(torch.int32)
    n = tokens.shape[0]
    tables = page_tables.to(torch.int32)
    pages = tables[torch.arange(n, device=tables.device),
                   positions // ps].long()
    offsets = positions % ps

    def write(cache, layer, k_new, v_new):
        return _scatter_kv(cache, layer, k_new, v_new, pages, offsets)

    def attend(cache, layer, q):
        scales = {}
        if _cache_int8(cache):
            scales = dict(k_scale=cache['k_scale'][layer],
                          v_scale=cache['v_scale'][layer])
        return ops.flash_attention_decode_paged(
            q, cache['k'][layer], cache['v'][layer], tables, lengths,
            **scales)

    return _decode_core(model, params, cache, tokens, positions, write,
                        attend)


def _gather_context(cache, layer, tables):
    """Each row's pages of one layer, ``(N, n_max * page_size, ...)``
    per leaf: the banked context a chunk or a verify window attends."""
    n, n_max = tables.shape
    idx = tables.reshape(-1).long()

    def gather(name):
        g = cache[name][layer].index_select(0, idx)
        return g.reshape((n, n_max * g.shape[1]) + g.shape[2:])

    ctx = {'k_ctx': gather('k'), 'v_ctx': gather('v')}
    if _cache_int8(cache):
        ctx.update(k_scale=gather('k_scale'), v_scale=gather('v_scale'))
    return ctx


def prefill_paged(model, params, cache, tokens, length, page_table, pos0,
                  first=None):
    """Prefill ONE CHUNK of a prompt into a paged cache: ``tokens`` ``(1,
    C)`` the chunk padded to a fixed width, ``length`` its valid prefix,
    ``page_table`` ``(n_max,)`` the sequence's pages, ``pos0`` the
    absolute position of its first token (tokens banked by earlier
    chunks).  ``length`` and ``pos0`` are ints or one-element integer
    tensors on the cache's device.  ``first`` says whether the chunk is
    the prompt's first (``pos0 == 0``, nothing banked before it); None
    decides it from ``pos0``, which reads a tensor ``pos0`` on the host
    (a CUDA graph is captured once for each value of ``first``).  Returns
    ``(logits (V,) f32 at chunk position length - 1, cache)``.

    Each chunk's K/V is written into its pages in place (pad rows go to
    the scratch page 0); attention is
    :func:`~chainermn_tpu_torch.ops.flash_attention_chunk`, causal
    within the chunk plus the banked context masked at ``pos0``.  With
    ``pos0 == 0`` there is no context to read: attention is the slot
    :func:`prefill`'s causal :func:`~chainermn_tpu_torch.ops.
    flash_attention_fwd`, so an unchunked paged prefill is bitwise the
    slot one (a first chunk given with ``first=False`` attends an empty
    context through the chunk op instead).  int8 KV:
    the chunk attends its fresh float K/V as the slot prefill does; only
    the banked context is dequantized.  Nothing before ``pos0`` is
    written (shared prefix pages stay read-only)."""
    dtype = model.dtype
    b, c = tokens.shape
    if b != 1:
        raise ValueError('prefill_paged takes one prompt chunk per call, got '
                         'batch %d' % b)
    device = tokens.device
    length, pos0 = _index(length, device), _index(pos0, device)
    if first is None:
        first = not bool(pos0)
    table = page_table.reshape(-1).to(torch.int32)
    n_max = table.shape[0]
    ps = cache['k'].shape[2]
    x = _embed(params['embed']['embedding'], tokens, dtype)
    t = torch.arange(c, device=device)
    # the JAX package's dynamic_slice: the window start is clamped so the
    # window stays inside the table
    start = torch.clamp(pos0, 0, max(0, params['pos_embed'].shape[0] - c))
    x = x + params['pos_embed'].index_select(0, start + t).to(dtype)
    p_abs = pos0 + t
    page_idx = torch.clamp(p_abs // ps, 0, n_max - 1)
    pages = torch.where(t < length, table[page_idx], 0).long()
    offsets = p_abs % ps
    ctx_len = pos0.to(torch.int32)
    for i in range(model.n_layers):
        bp = params['block_%d' % i]
        h = ops.layer_norm(x, bp['ln1_scale'], bp['ln1_bias']).to(dtype)
        qkv = _qkv_proj(h, bp, dtype)            # (1, C, 3, H, d_head)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        _scatter_kv(cache, i, k[0], v[0], pages, offsets)
        if first:
            # no banked context: the slot prefill's causal forward
            attn = ops.flash_attention_fwd(q, k, v, causal=True)[0]
        else:
            attn = ops.flash_attention_chunk(
                q, k, v, ctx_len=ctx_len,
                **_gather_context(cache, i, table[None]))
        x = x + _dense(attn.reshape(1, c, -1), bp['proj'], dtype)
        h = ops.layer_norm(x, bp['ln2_scale'], bp['ln2_bias']).to(dtype)
        x = x + _mlp(h, bp, dtype)
    x_last = ops.layer_norm(_last_row(x, length), params['lnf_scale'],
                            params['lnf_bias'])
    return _head_logits(model, params, x_last)[0], cache


# ---------------------------------------------------------------------
# speculative decoding: the k-token verify pass

def _verify_core(model, params, cache, tokens, positions, write, attend):
    """The windowed twin of :func:`_decode_core`: ``tokens`` ``(N, K)``,
    row i's window of K consecutive tokens from absolute position
    ``positions[i]``; embed + per layer (norm -> qkv -> ``write`` the
    window's K/V -> ``attend(cache, layer, q, k_new, v_new)`` window-
    causal against the banked prefix -> proj residual -> MLP residual)
    -> final norm -> head at all K positions.  Returns ``(logits (N, K,
    V) f32, cache)``."""
    dtype = model.dtype
    n, kk = tokens.shape
    window = positions.long()[:, None] + torch.arange(
        kk, device=positions.device)[None, :]
    # a window overhanging the position table: its columns are never
    # committed, any row of the table will do
    window = torch.clamp(window, max=params['pos_embed'].shape[0] - 1)
    x = _embed(params['embed']['embedding'], tokens, dtype)
    x = x + _embed(params['pos_embed'], window, dtype)
    for i in range(model.n_layers):
        bp = params['block_%d' % i]
        h = ops.layer_norm(x, bp['ln1_scale'], bp['ln1_bias']).to(dtype)
        qkv = _qkv_proj(h, bp, dtype)            # (N, K, 3, H, d_head)
        q, k_new, v_new = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        cache = write(cache, i, k_new, v_new)
        attn = attend(cache, i, q, k_new, v_new)
        x = x + _dense(attn.reshape(n, kk, -1), bp['proj'], dtype)
        h = ops.layer_norm(x, bp['ln2_scale'], bp['ln2_bias']).to(dtype)
        x = x + _mlp(h, bp, dtype)
    x = ops.layer_norm(x, params['lnf_scale'], params['lnf_bias'])
    return _head_logits(model, params, x), cache


def _roundtrip_kv(cache, k_new, v_new):
    """What the sequential decode loop's next step would read back for
    the window's fresh K/V: the cache-dtype cast, or the int8 quantize ->
    dequantize round trip.  Fed as the chunk's fresh half, they make the
    verify pass argmax-equal to the decode loop in every cache mode."""
    if _cache_int8(cache):
        return (dequantize_kv(*quantize_kv(k_new)),
                dequantize_kv(*quantize_kv(v_new)))
    dt = cache['k'].dtype
    return k_new.to(dt), v_new.to(dt)


def _attend_window(cache, q, k_new, v_new, positions, ctx):
    k_att, v_att = _roundtrip_kv(cache, k_new, v_new)
    return ops.flash_attention_chunk(q, k_att, v_att, ctx_len=positions,
                                     **ctx)


def spec_verify(model, params, cache, tokens, positions, slots=None):
    """Speculative-decoding verify pass over a slot cache: score K
    consecutive tokens per row in one pass.  ``tokens`` ``(N, K)``: row
    i's window ``[last committed token, draft_1, ..., draft_{K-1}]`` at
    absolute positions ``positions[i] + [0, K)``; ``slots`` as in
    :func:`decode_step` (``None``: the full bucket, one row per slot).
    Returns ``(logits (N, K, V) f32, cache)``: ``logits[i, j]`` is the
    next-token distribution given the window through ``tokens[i, j]``.

    Attention is :func:`~chainermn_tpu_torch.ops.flash_attention_chunk`
    (the window is the chunk, the slot's cache the context masked at
    ``positions``), with the fresh half round-tripped through the cache
    dtype.  Window positions at or past the cache depth are not written
    and never committed: their columns write the last column inside the
    depth once more, with its own values (a write of fixed shape, so
    nothing waits for the host).  Rollback after the accept decision is a
    position rewind: rejected columns' K/V stay as masked garbage."""
    n_slots, depth = cache['k'].shape[1:3]
    if slots is None and tokens.shape[0] != n_slots:
        raise ValueError(
            'full-bucket verify needs one row per cache slot (%d rows vs %d '
            'slots); pass slots= for a compacted bucket'
            % (tokens.shape[0], n_slots))
    n, kk = tokens.shape
    positions = positions.long()
    rows = (torch.arange(n, device=positions.device) if slots is None
            else slots.long())
    rows_w = rows[:, None].expand(n, kk)
    # column j writes column min(j, depth - 1 - p) at that column's own
    # position: a column past the depth repeats the last one inside it (a
    # row at or past the depth, which no decode step can serve either,
    # writes its first column at depth - 1)
    cols = torch.clamp(torch.minimum(
        torch.arange(kk, device=positions.device)[None, :],
        depth - 1 - positions[:, None]), min=0)
    target = torch.clamp(positions[:, None] + cols, max=depth - 1)

    def pick(x):
        idx = cols.reshape(cols.shape + (1,) * (x.dim() - 2))
        return torch.gather(x, 1, idx.expand(x.shape))

    def write(cache, layer, k_new, v_new):
        return _scatter_kv(cache, layer, pick(k_new), pick(v_new), rows_w,
                           target)

    def attend(cache, layer, q, k_new, v_new):
        ctx = {'k_ctx': cache['k'][layer], 'v_ctx': cache['v'][layer]}
        if _cache_int8(cache):
            ctx.update(k_scale=cache['k_scale'][layer],
                       v_scale=cache['v_scale'][layer])
        if slots is not None:
            ctx = {key: val.index_select(0, rows) for key, val in ctx.items()}
        return _attend_window(cache, q, k_new, v_new, positions, ctx)

    return _verify_core(model, params, cache, tokens, positions, write,
                        attend)


def spec_verify_paged(model, params, cache, tokens, positions, page_tables):
    """:func:`spec_verify` against a PAGED cache: ``page_tables`` ``(N,
    n_max)`` as in :func:`decode_step_paged`; the entries covering
    ``[positions[i], positions[i] + K)`` must be allocated, and window
    rows past the table's span go to the scratch page like pad rows.
    The context is gathered through the tables and masked at
    ``positions``."""
    n, kk = tokens.shape
    tables = page_tables.to(torch.int32)
    n_max = tables.shape[1]
    ps = cache['k'].shape[2]
    positions = positions.long()
    window = positions[:, None] + torch.arange(kk, device=positions.device)
    page_idx = torch.clamp(window // ps, 0, n_max - 1)
    pages = torch.where(window < n_max * ps,
                        torch.gather(tables.long(), 1, page_idx), 0)
    offsets = window % ps

    def write(cache, layer, k_new, v_new):
        return _scatter_kv(cache, layer, k_new, v_new, pages, offsets)

    def attend(cache, layer, q, k_new, v_new):
        return _attend_window(cache, q, k_new, v_new, positions,
                              _gather_context(cache, layer, tables))

    return _verify_core(model, params, cache, tokens, positions, write,
                        attend)
