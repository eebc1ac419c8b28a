"""Long-context causal LM training with sequence parallelism.

The port's twin of ``examples/lm/train_lm.py``: a ``TransformerLM`` whose
sequence dimension is sharded over an ``sp`` axis of processes (ring or
Ulysses attention, ``--sp-scheme``) and whose batch is sharded over
``dp``, trained with AdamW (``torch.optim.AdamW(lr, weight_decay=
0.01)``, the arithmetic of ``optax.adamw``) on the global loss of
``parallel.mapped_global_loss``.  The flash, LayerNorm and cross-entropy
kernels are the compute path on a card.

Without a corpus on disk it trains on the JAX example's synthetic
order-1 Markov text, made from ``numpy.random.RandomState(0)``, in the
same windows; ``--tokens`` takes a 1-D int ``.npy`` of token ids.

    torchrun --nproc-per-node 4 -m chainermn_tpu_torch.examples.lm.train_lm \\
        --cpu --quick --mesh 2x2 --sp-scheme ulysses      # gloo
    python -m chainermn_tpu_torch.examples.lm.train_lm --seq-len 8192

``--mesh DPxSP`` must cover the processes (default: all on sp).  As in
the JAX example the sequence axis is bound only when sp > 1 (plain flash
attention otherwise); ``--bind-sp`` binds it at sp = 1 too, which runs
the chosen scheme over a ring of one.  ``--cpu`` runs on the CPU over
gloo (the JAX example's 8 virtual devices); ``--dtype`` is the compute
dtype (the JAX model's default, bfloat16).
"""

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators.base import join_default_group
from chainermn_tpu_torch.models import (
    TransformerLM, lm_loss, load_flax_variables)
from chainermn_tpu_torch.parallel import (
    ProcessMesh, mapped_global_loss, sum_grads)

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}


def synthetic_tokens(n_tokens, vocab, rng):
    """Order-1 Markov chain over a random sparse transition table."""
    next_tok = rng.randint(0, vocab, (vocab, 4))
    toks = np.empty(n_tokens, np.int32)
    toks[0] = rng.randint(vocab)
    choices = rng.randint(0, 4, n_tokens)
    for i in range(1, n_tokens):
        toks[i] = next_tok[toks[i - 1], choices[i]]
    return toks


def _parser():
    p = argparse.ArgumentParser()
    p.add_argument('--batchsize', '-b', type=int, default=4,
                   help='global batch (split over dp)')
    p.add_argument('--seq-len', type=int, default=1024,
                   help='global sequence length (split over sp)')
    p.add_argument('--steps', type=int, default=200)
    p.add_argument('--vocab', type=int, default=512)
    p.add_argument('--d-model', type=int, default=256)
    p.add_argument('--n-heads', type=int, default=8)
    p.add_argument('--n-layers', type=int, default=4)
    p.add_argument('--sp-scheme', choices=['ring', 'ulysses'],
                   default='ring')
    p.add_argument('--mesh', default=None,
                   help='DPxSP, e.g. 2x4 (default: all processes on sp)')
    p.add_argument('--tokens', default=None,
                   help='token-id corpus as a 1-D int .npy file '
                        '(default: synthetic Markov text)')
    p.add_argument('--lr', type=float, default=3e-4)
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU over gloo')
    p.add_argument('--quick', action='store_true')
    p.add_argument('--dtype', choices=sorted(DTYPES), default='bfloat16',
                   help='compute dtype (masters stay float32)')
    p.add_argument('--bind-sp', action='store_true',
                   help='bind the sequence axis at sp = 1 too')
    return p


def main(argv=None, params=None, on_step=None):
    """Train; returns ``{'losses', 'step_seconds', 'tokens_per_step',
    'model', 'mesh'}``.  ``params``: a flax parameter tree to start from
    (the JAX example's ``init`` tree; default: the port's seeded init).
    ``on_step(step, loss)`` is called after every step.  The default
    group is joined (torchrun's environment, else a world of one) and
    destroyed at the end if it was made here."""
    args = _parser().parse_args(argv)
    if args.quick:
        args.steps = min(args.steps, 30)
        args.seq_len = min(args.seq_len, 256)
        args.n_layers = min(args.n_layers, 2)
    device, made = join_default_group('cpu' if args.cpu else None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if args.mesh:
        dp, sp = (int(v) for v in args.mesh.split('x'))
    else:
        dp, sp = 1, world
    if dp * sp != world:
        raise SystemExit('mesh %dx%d needs %d processes, have %d'
                         % (dp, sp, dp * sp, world))
    if args.batchsize % dp or args.seq_len % sp:
        raise SystemExit('dp must divide the batch size and sp must '
                         'divide the sequence length')
    mesh = ProcessMesh((dp, sp), ('dp', 'sp'))
    say = print if rank == 0 else (lambda *a, **k: None)
    say('mesh: dp=%d x sp=%d  scheme=%s  T=%d'
        % (dp, sp, args.sp_scheme, args.seq_len))

    model = TransformerLM(
        vocab_size=args.vocab, d_model=args.d_model,
        n_heads=args.n_heads, n_layers=args.n_layers,
        d_ff=4 * args.d_model,
        max_len=max(args.seq_len, 1024),
        dtype=DTYPES[args.dtype],
        sequence_axis='sp' if sp > 1 or args.bind_sp else None,
        sp_scheme=args.sp_scheme, device=device)
    if params is not None:
        load_flax_variables(model, {'params': params})

    rng = np.random.RandomState(0)
    if args.tokens:
        corpus = np.load(args.tokens).astype(np.int32).ravel()
        if corpus.max() >= args.vocab:
            raise SystemExit('--tokens ids exceed --vocab %d' % args.vocab)
        need = args.batchsize * (args.seq_len + 1) + 1
        if len(corpus) < need:
            raise SystemExit('--tokens corpus too short: %d < %d'
                             % (len(corpus), need))
    else:
        corpus = synthetic_tokens(
            args.batchsize * (args.seq_len + 1) * 8, args.vocab, rng)

    def sample_batch(step):
        i = (step * args.batchsize * args.seq_len) % (
            len(corpus) - args.batchsize * (args.seq_len + 1))
        window = corpus[i:i + args.batchsize * (args.seq_len + 1)]
        window = window.reshape(args.batchsize, args.seq_len + 1)
        return window[:, :-1], window[:, 1:]

    params_list = list(model.parameters())
    opt = torch.optim.AdamW(params_list, lr=args.lr, weight_decay=0.01)
    # the global loss; its backward leaves each process its share, which
    # sum_grads completes (the JAX example differentiates outside the
    # shard_map, where XLA sums the shares)
    mapped = mapped_global_loss(lm_loss(model), mesh, ('dp', 'sp'))

    losses, seconds = [], []
    t0 = time.time()
    for s in range(args.steps):
        t_step = time.perf_counter()
        x, y = sample_batch(s)
        loss = mapped(torch.from_numpy(np.ascontiguousarray(x)).to(device),
                      torch.from_numpy(np.ascontiguousarray(y)).to(device))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        sum_grads(params_list, mesh)
        opt.step()
        losses.append(float(loss.detach()))  # waits for the step
        seconds.append(time.perf_counter() - t_step)
        if on_step is not None:
            on_step(s, losses[-1])
        if s % 10 == 0 or s == args.steps - 1:
            tok_s = (args.batchsize * args.seq_len * (s + 1)
                     / (time.time() - t0))
            say('step %4d  loss %.4f  (%.0f tok/s)' % (s, losses[-1], tok_s))
    first, final = losses[0], losses[-1]
    say('loss %.4f -> %.4f (uniform=%.4f)'
        % (first, final, np.log(args.vocab)))
    if made:
        dist.destroy_process_group()
    if final >= first:
        raise SystemExit('loss did not improve')
    return {'losses': losses, 'step_seconds': seconds,
            'tokens_per_step': args.batchsize * args.seq_len,
            'model': model, 'mesh': mesh}


if __name__ == '__main__':
    main()
