"""Model-parallel MNIST: a two-stage MLP over ``MultiNodeChainList``.

The port's twin of ``examples/mnist/train_mnist_model_parallel.py`` (the
reference's MLP0 on rank 0 and MLP1 on rank 1): stage 0 is
``MLP(unit, unit)`` (784 -> unit), stage 1 ``MLP(unit, 10)``, plain
Adam 1e-3 (never wrapped in ``create_multi_node_optimizer``: that
would average the gradients of different stages), the same flags and
defaults (``--unit 200``, batch 100, 5 epochs, ``--quick``, accuracy on
``test[0:500]`` after each epoch):

    torchrun --nproc-per-node 2 -m \\
        chainermn_tpu_torch.examples.mnist.train_mnist_model_parallel \\
        [--cpu]
    python -m chainermn_tpu_torch.examples.mnist.train_mnist_model_parallel

In a world of one both stages run in the one process; in a world of two
or more stage k runs on rank k (``MultiNodeChainList(spmd=True)``), the
activation and its gradient cross between the ranks, and the other
ranks only take the broadcast logits.  Every rank walks the same
``SerialIterator`` order over the whole set, so every rank holds the
labels and computes the same loss; a stage's parameters get gradients
only on its rank, and Adam skips the others.  ``--cpu`` runs on gloo.
"""

import argparse
import time
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import training
from chainermn_tpu_torch.dataset import SubDataset
from chainermn_tpu_torch.datasets import mnist
from chainermn_tpu_torch.models import MLP, load_flax_variables

N_VAL = 500


def _parser():
    parser = argparse.ArgumentParser(
        description='ChainerMN MNIST model-parallel, 2 stages (PyTorch)')
    parser.add_argument('--batchsize', '-b', type=int, default=100)
    parser.add_argument('--epoch', '-e', type=int, default=5)
    parser.add_argument('--unit', '-u', type=int, default=200)
    parser.add_argument('--out', '-o', default='result_mp')
    parser.add_argument('--cpu', action='store_true',
                        help="run on the CPU (gloo; default: this "
                             "process's CUDA device)")
    parser.add_argument('--quick', action='store_true')
    return parser


def _arrays(batch, device):
    x = torch.from_numpy(np.stack([b[0] for b in batch])).to(device)
    y = torch.from_numpy(np.stack([b[1] for b in batch])).to(device)
    return x, y.long()


def main(argv=None, variables=None, max_iterations=None, on_step=None):
    """Train; returns a namespace with every step's ``losses``, the
    epochs' ``val_accuracy``, the ``model`` and its ``stages``, and the
    ``comm`` (still open: ``comm.close()`` ends the process group it
    made).  ``variables``: the two stages' flax variable trees to start
    from (default: seeds 0 and 1); ``max_iterations`` stops early;
    ``on_step(iteration, loss)`` runs after each update."""
    args = _parser().parse_args(argv)
    comm = cmt.create_communicator('xla',
                                   device='cpu' if args.cpu else None)
    if comm.rank == 0:
        print('Using %d processes for 2 model-parallel stages on %s'
              % (comm.size, comm.device))
    gens = [torch.Generator().manual_seed(i) for i in range(2)]
    stages = [MLP(n_units=args.unit, n_out=args.unit, device=comm.device,
                  generator=gens[0]),
              MLP(n_units=args.unit, n_out=10, n_in=args.unit,
                  device=comm.device, generator=gens[1])]
    if variables is not None:
        for stage, v in zip(stages, variables):
            load_flax_variables(stage, v)
    model = cmt.MultiNodeChainList(comm, spmd=True)
    model.add_link(stages[0], rank_in=None, rank_out=1, rank=0)
    model.add_link(stages[1], rank_in=0, rank_out=None, rank=1)

    train, test = mnist.get_mnist()
    if args.quick:
        train = SubDataset(train, 0, 500)
        args.epoch = 1
    val_x, val_y = _arrays(test[0:N_VAL], comm.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)

    it = training.SerialIterator(train, args.batchsize)
    iters_per_epoch = max(1, len(train) // args.batchsize)
    run = SimpleNamespace(losses=[], val_accuracy=[], model=model,
                          stages=stages, comm=comm)
    t0 = time.perf_counter()
    for epoch in range(args.epoch):
        losses = []
        for _ in range(iters_per_epoch):
            if max_iterations is not None and \
                    len(run.losses) >= max_iterations:
                return run
            x, y = _arrays(next(it), comm.device)
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(x).float(), y)
            loss.backward()
            optimizer.step()
            losses.append(loss.item())
            run.losses.append(losses[-1])
            if on_step is not None:
                on_step(len(run.losses), losses[-1])
        with torch.no_grad():
            logits = model(val_x)
        run.val_accuracy.append(float((logits.argmax(-1) == val_y)
                                      .float().mean()))
        if comm.rank == 0:
            print('epoch %d  mean loss %.4f  val accuracy %.4f  (%.1fs)'
                  % (epoch + 1, np.mean(losses), run.val_accuracy[-1],
                     time.perf_counter() - t0))
    return run


if __name__ == '__main__':
    main().comm.close()
