"""Distributed seq2seq / NMT training (``BASELINE.json`` config 4).

The port's twin of ``examples/seq2seq/train_seq2seq.py``: the same flags
and defaults (batch 64, 3 epochs, 2 layers of 256 units, a vocabulary of
512, ``--quick``), the same synthetic "reverse-translation" pairs from
``RandomState(42)`` (or token-id TSV with ``--source``), the static
buckets of widths 8, 16 and 32 (``models.bucket_batches``), one step per
full batch of a bucket in a per-epoch ``RandomState(epoch)`` order,
multi-node Adam 1e-3 and ``StandardUpdater.update_core``:

    torchrun --nproc-per-node 2 -m \\
        chainermn_tpu_torch.examples.seq2seq.train_seq2seq [--cpu]
    python -m chainermn_tpu_torch.examples.seq2seq.train_seq2seq --quick

``--batchsize`` is global.  The JAX script scatters the pairs over its
processes and splits each global batch over the devices of one; here
every process buckets all the pairs and takes its share of each global
batch, so that every rank runs the same number of steps per bucket (a
rank with a step fewer would leave the others in their allreduce).  In
a world of one the two are the same.
"""

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch

import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import training
from chainermn_tpu_torch.models import (
    Seq2seq, bucket_batches, load_flax_variables, seq2seq_loss)


def synthetic_pairs(n, vocab, rng):
    """``n`` pairs: a source of 3..19 tokens in ``[4, vocab)`` and its
    reverse over a shifted vocabulary."""
    pairs = []
    for _ in range(n):
        length = rng.randint(3, 20)
        src = rng.randint(4, vocab, length)
        tgt = (src[::-1] % (vocab - 4)) + 4
        pairs.append((src, tgt))
    return pairs


def load_tsv(path):
    pairs = []
    with open(path) as f:
        for line in f:
            s, t = line.rstrip('\n').split('\t')
            pairs.append(([int(v) for v in s.split()],
                          [int(v) for v in t.split()]))
    return pairs


def _parser():
    parser = argparse.ArgumentParser(
        description='ChainerMN seq2seq (PyTorch)')
    parser.add_argument('--batchsize', '-b', type=int, default=64)
    parser.add_argument('--communicator', default='xla')
    parser.add_argument('--epoch', '-e', type=int, default=3)
    parser.add_argument('--unit', '-u', type=int, default=256)
    parser.add_argument('--layer', type=int, default=2)
    parser.add_argument('--vocab', type=int, default=512)
    parser.add_argument('--source', default=None,
                        help='token-id TSV (src<TAB>tgt per line)')
    parser.add_argument('--cpu', action='store_true')
    parser.add_argument('--quick', action='store_true')
    return parser


def main(argv=None, variables=None, on_step=None):
    """Train; returns a namespace with every step's ``losses`` (the
    ranks' mean), the ``tokens`` of each step (target positions that
    count, all ranks), the epochs' ``mean_loss``, the ``model`` and the
    ``comm`` (still open).  ``variables``: a flax variable tree to start
    from (default: seed 0); ``on_step(width, metrics)`` runs after each
    update."""
    args = _parser().parse_args(argv)
    comm = cmt.create_communicator(args.communicator,
                                   device='cpu' if args.cpu else None)
    n_pairs = 512 if args.quick else 8192
    if args.source:
        pairs = load_tsv(args.source)
    else:
        pairs = synthetic_pairs(n_pairs, args.vocab,
                                np.random.RandomState(42))
    buckets = bucket_batches(pairs, bucket_widths=(8, 16, 32))

    model = Seq2seq(n_layers=args.layer, n_source_vocab=args.vocab,
                    n_target_vocab=args.vocab, n_units=args.unit,
                    device=comm.device)
    if variables is not None:
        load_flax_variables(model, variables)
    optimizer = cmt.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm)
    updater = training.StandardUpdater(
        iter([]), optimizer, seq2seq_loss(model), model, comm)

    batch = args.batchsize - args.batchsize % comm.size or comm.size
    share = batch // comm.size
    run = SimpleNamespace(losses=[], tokens=[], mean_loss=[], model=model,
                          comm=comm)
    t0 = time.time()
    for epoch in range(args.epoch if not args.quick else 1):
        perm_rng = np.random.RandomState(epoch)
        total_loss, n_steps = 0.0, 0
        for width, (xs, yin, yout) in sorted(buckets.items()):
            order = perm_rng.permutation(len(xs))
            for i in range(0, len(order) - batch + 1, batch):
                sel = order[i:i + batch]
                run.tokens.append(int((yout[sel] != 0).sum()))
                sel = sel[comm.rank * share:(comm.rank + 1) * share]
                arrays = tuple(torch.from_numpy(a[sel]).to(comm.device)
                               for a in (xs, yin, yout))
                metrics = updater.update_core(arrays)
                loss = float(metrics['loss'])
                run.losses.append(loss)
                total_loss += loss
                n_steps += 1
                if on_step is not None:
                    on_step(width, metrics)
        run.mean_loss.append(total_loss / max(n_steps, 1))
        if comm.rank == 0:
            print('epoch %d  mean loss %.4f  perp %.2f  (%.1fs)'
                  % (epoch + 1, run.mean_loss[-1], np.exp(run.mean_loss[-1]),
                     time.time() - t0))
    if comm.rank == 0:
        print('final mean loss: %.4f' % run.mean_loss[-1])
    return run


if __name__ == '__main__':
    main().comm.close()
