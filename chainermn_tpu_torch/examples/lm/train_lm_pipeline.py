"""Pipeline-parallel transformer LM training.

The port's twin of ``examples/lm/train_lm_pipeline.py``: a causal
``TransformerLM`` whose body (the stack of ``TransformerBlock``s) is split
over pipeline stages, one process a stage, each holding only its stage's
weights, while the ends (the embedding and position table in the
prologue, the final norm and head in the loss) are replicated
``extra_params`` trained with it (``PipelineUpdater(prologue=...,
extra_params=...)``).  A ``(data, stage)`` mesh of processes
micro-batches the batch through the GPipe schedule; the flash,
LayerNorm and cross-entropy kernels are each stage's compute path on a
card.  With ``--tp N > 1`` each stage is ``--layers-per-stage``
Megatron ``tp_transformer_block``s over a third mesh axis, ``tp``
(``_tp_parts``).  Everything is float32, as in the JAX example.

It trains on the JAX example's synthetic order-1 Markov text, made from
``numpy.random.RandomState(0)``, in the same windows.

    torchrun --standalone --nproc-per-node 4 \\
        -m chainermn_tpu_torch.examples.lm.train_lm_pipeline \\
        --cpu --quick --stages 2                     # gloo, (2, 2)
    torchrun --standalone --nproc-per-node 4 \\
        -m chainermn_tpu_torch.examples.lm.train_lm_pipeline \\
        --cpu --quick --stages 2 --tp 2              # (1, 2, 2)
    python -m chainermn_tpu_torch.examples.lm.train_lm_pipeline \\
        --stages 1                                   # one card

``--stages`` defaults to half the processes (at least 2), as the JAX
example's to half its devices; the processes must divide into
``stages x tp``.  ``--cpu`` runs on the CPU over gloo.
"""

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch import ops
from chainermn_tpu_torch.communicators.base import join_default_group
from chainermn_tpu_torch.examples.lm.train_lm import synthetic_tokens
from chainermn_tpu_torch.models import TransformerLM, load_flax_variables
from chainermn_tpu_torch.models.transformer import pipeline_parts
from chainermn_tpu_torch.parallel.pipeline import (stack_stage_params,
                                                  tree_leaves)
from chainermn_tpu_torch.parallel.tensor import tp_transformer_block
from chainermn_tpu_torch.training.pipeline_updater import (
    PipelineUpdater, pipeline_mesh)


def _tp_parts(args, n_stages):
    """The 3-D variant: each stage is ``--layers-per-stage`` Megatron
    ``tp_transformer_block``s whose weights are sharded over the ``tp``
    axis (heads for the attention, columns / rows for the MLP, through
    the conjugate pair); the embedding, positions, final norm and head
    stay replicated extras.  The weights are the JAX example's draws from
    ``RandomState(0)``, in its order; the specs lead with ``'stage'``."""
    d, h = args.d_model, args.n_heads
    dh, ff, L = d // h, 4 * d, args.layers_per_stage
    if h % args.tp:
        raise SystemExit('tp must divide n-heads (tp_attention '
                         'shards heads across the tp axis)')
    rng = np.random.RandomState(0)
    f32 = np.float32

    def block_params():
        return {
            'ln1_scale': np.ones((d,), f32), 'ln1_bias': np.zeros((d,), f32),
            'wqkv': (rng.randn(d, 3, h, dh) * d ** -0.5).astype(f32),
            'wo': (rng.randn(h * dh, d) * d ** -0.5).astype(f32),
            'bo': np.zeros((d,), f32),
            'ln2_scale': np.ones((d,), f32), 'ln2_bias': np.zeros((d,), f32),
            'w_in': (rng.randn(d, ff) * d ** -0.5).astype(f32),
            'b_in': np.zeros((ff,), f32),
            'w_out': (rng.randn(ff, d) * ff ** -0.5).astype(f32),
            'b_out': np.zeros((d,), f32),
        }

    # L blocks per stage: the layer dim stacked inside the stage dim
    stacked = stack_stage_params([
        stack_stage_params([block_params() for _ in range(L)])
        for _ in range(n_stages)])
    param_specs = {
        'ln1_scale': ('stage',), 'ln1_bias': ('stage',),
        'wqkv': ('stage', None, None, None, 'tp'),
        'wo': ('stage', None, 'tp'), 'bo': ('stage',),
        'ln2_scale': ('stage',), 'ln2_bias': ('stage',),
        'w_in': ('stage', None, None, 'tp'),
        'b_in': ('stage', None, 'tp'),
        'w_out': ('stage', None, 'tp', None), 'b_out': ('stage',),
    }
    extra = {
        'embed': (rng.randn(args.vocab, d) * 0.02).astype(f32),
        'pos': (rng.randn(args.seq_len, d) * 0.02).astype(f32),
        'lnf_g': np.ones((d,), f32),
        'lnf_b': np.zeros((d,), f32),
        'head': (rng.randn(d, args.vocab) * 0.02).astype(f32),
    }

    def stage_fn(p_stage, x):
        for j in range(L):
            bp = {k: v[j] for k, v in p_stage.items()}
            x = tp_transformer_block(x, bp, 'tp', n_heads=h,
                                     grad_conjugate=True)
        return x

    def prologue(e, tokens):
        return (e['embed'].index_select(0, tokens.reshape(-1).long())
                .reshape(tokens.shape + (d,))
                + e['pos'][None, :tokens.shape[1]])

    def loss_on_last(e, outs, y_micro):
        hh = ops.layer_norm(outs.reshape(-1, d), e['lnf_g'], e['lnf_b'])
        logits = hh @ e['head']
        loss = F.cross_entropy(logits, y_micro.reshape(-1).long())
        return loss, {'perp': torch.exp(loss.detach().clamp_max(20.0))}

    return stage_fn, prologue, loss_on_last, stacked, extra, param_specs


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument('--batchsize', '-b', type=int, default=8,
                   help='global batch (split over the data axis)')
    p.add_argument('--seq-len', type=int, default=256)
    p.add_argument('--steps', type=int, default=150)
    p.add_argument('--vocab', type=int, default=512)
    p.add_argument('--d-model', type=int, default=128)
    p.add_argument('--n-heads', type=int, default=4)
    p.add_argument('--layers-per-stage', type=int, default=1)
    p.add_argument('--stages', type=int, default=None,
                   help='pipeline stages (default: half the processes, '
                        'min 2)')
    p.add_argument('--micro', type=int, default=4,
                   help='micro-batches per step')
    p.add_argument('--tp', type=int, default=1,
                   help='tensor-parallel width: >1 adds a tp mesh '
                        'axis and Megatron-shards each stage block '
                        '(3-D PP x TP x DP)')
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU over gloo')
    p.add_argument('--quick', action='store_true')
    return p


def main(argv=None, params=None, on_step=None):
    """Train; returns ``{'losses', 'step_seconds', 'tokens_per_step',
    'updater', 'mesh'}``.  ``params``: the flax parameter tree of the
    ``--tp 1`` model to start from (the JAX example's ``init`` tree;
    default: the port's seeded init).  ``on_step(step, loss)`` is called
    after every step.  The default group is joined (torchrun's
    environment, else a world of one) and destroyed at the end if it was
    made here."""
    args = _parser().parse_args(argv)
    if args.quick:
        args.steps = min(args.steps, 40)
        args.seq_len = min(args.seq_len, 128)
    if args.tp < 1:
        raise SystemExit('--tp must be >= 1')
    device, made = join_default_group('cpu' if args.cpu else None)
    world, rank = dist.get_world_size(), dist.get_rank()
    n_stages = args.stages or max(2, world // (2 * args.tp))
    mesh = pipeline_mesh(n_stages, n_tp=args.tp, device=device)
    n_layers = n_stages * args.layers_per_stage
    say = print if rank == 0 else (lambda *a, **k: None)
    say('mesh: %s  (%d layers, %d per stage)'
        % (dict(mesh.shape), n_layers, args.layers_per_stage))

    if args.tp == 1:
        # the real model class, split by pipeline_parts: the block stack
        # -> the stage-sharded body, the ends -> replicated extras
        model = TransformerLM(
            vocab_size=args.vocab, d_model=args.d_model,
            n_heads=args.n_heads, n_layers=n_layers,
            d_ff=4 * args.d_model, max_len=args.seq_len,
            dtype=torch.float32, device='cpu')
        if params is not None:
            load_flax_variables(model, {'params': params})
        stage_fn, prologue, loss_on_last, stacked, extra = \
            pipeline_parts(model, n_stages=n_stages)
        param_specs = None
        del model
    else:
        stage_fn, prologue, loss_on_last, stacked, extra, \
            param_specs = _tp_parts(args, n_stages)

    corpus = synthetic_tokens(
        args.batchsize * (args.seq_len + 1) * 8, args.vocab,
        np.random.RandomState(0))

    def sample_batch(step):
        span = args.batchsize * (args.seq_len + 1)
        i = (step * args.batchsize * args.seq_len) % (len(corpus) - span)
        w = corpus[i:i + span].reshape(args.batchsize, args.seq_len + 1)
        return [(w[j, :-1], w[j, 1:]) for j in range(args.batchsize)]

    upd = PipelineUpdater(
        iter([]), lambda ps: torch.optim.AdamW(ps, lr=args.lr,
                                               weight_decay=0.01),
        stage_fn, loss_on_last, stacked, mesh, n_micro=args.micro,
        prologue=prologue, extra_params=extra, param_specs=param_specs,
        device=device)

    losses, seconds = [], []
    t0 = time.time()
    for s in range(args.steps):
        t_step = time.perf_counter()
        m = upd.update_core(upd.shard_batch(sample_batch(s)))
        losses.append(float(m['loss']))       # waits for the step
        seconds.append(time.perf_counter() - t_step)
        if on_step is not None:
            on_step(s, losses[-1])
        if s % 10 == 0 or s == args.steps - 1:
            tok_s = (args.batchsize * args.seq_len * (s + 1)
                     / (time.time() - t0))
            say('step %4d  loss %.4f  perp %.1f  (%.0f tok/s)'
                % (s, losses[-1], float(m['perp']), tok_s))
    first, final = losses[0], losses[-1]
    say('loss %.4f -> %.4f (uniform=%.4f)'
        % (first, final, np.log(args.vocab)))

    # memory-scaling evidence: exact per-process shard sizes
    n_body = sum(int(np.prod(np.shape(v)))
                 for v in tree_leaves(stacked))
    n_local = sum(p.numel() for p in upd._stage_list)
    say('body params: %.2fM total, %.2fM per device (1/%.1f)'
        % (n_body / 1e6, n_local / 1e6, n_body / max(n_local, 1)))
    if made:
        dist.destroy_process_group()
    if final >= first:
        raise SystemExit('loss did not improve')
    return {'losses': losses, 'step_seconds': seconds,
            'tokens_per_step': args.batchsize * args.seq_len,
            'updater': upd, 'mesh': mesh}


if __name__ == '__main__':
    main()
