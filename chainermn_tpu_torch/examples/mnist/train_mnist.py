"""Data-parallel MNIST training.

The port's twin of ``examples/mnist/train_mnist.py`` (the reference
demo): the same flags and the same structure -- communicator, MLP,
multi-node Adam, scattered datasets, a trainer with the multi-node
evaluator every epoch, snapshot / log / print gated to rank 0, and a
``NanGuard`` -- with one process per device:

    torchrun --nproc-per-node 2 -m \\
        chainermn_tpu_torch.examples.mnist.train_mnist [--device cpu]
    python -m chainermn_tpu_torch.examples.mnist.train_mnist  # one GPU

``--batchsize`` is the global batch; each process takes
``batchsize // size``.  ``--device`` (default: this process's CUDA
device) takes the place of the JAX script's ``--cpu`` and ``--mesh``.
"""

import argparse

import torch

import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import serializers, training
from chainermn_tpu_torch.dataset import SubDataset
from chainermn_tpu_torch.datasets import mnist
from chainermn_tpu_torch.models import MLP, Classifier
from chainermn_tpu_torch.training import extensions
from chainermn_tpu_torch.utils import NanGuard


def _parser():
    parser = argparse.ArgumentParser(description='ChainerMN MNIST (PyTorch)')
    parser.add_argument('--batchsize', '-b', type=int, default=100,
                        help='global minibatch size')
    parser.add_argument('--communicator', type=str, default='xla',
                        help='communicator strategy name')
    parser.add_argument('--epoch', '-e', type=int, default=20)
    parser.add_argument('--unit', '-u', type=int, default=1000)
    parser.add_argument('--out', '-o', default='result')
    parser.add_argument('--resume', '-r', default='',
                        help='resume from a snapshot (.npz)')
    parser.add_argument('--device', default=None,
                        help="'cpu' (gloo) or a CUDA device (default: "
                             "this process's)")
    parser.add_argument('--quick', action='store_true',
                        help='tiny run for smoke testing')
    parser.add_argument('--policy', default=None,
                        help='mixed-precision policy (not ported yet)')
    return parser


def main(argv=None):
    """Train; returns the trainer after its run, its communicator still
    open (``trainer.updater.comm.close()`` ends the process group it
    made)."""
    args = _parser().parse_args(argv)
    if args.policy:
        raise NotImplementedError(
            '--policy is not ported yet: the updater takes no policy '
            '(ROADMAP.md A4, A5)')
    comm = cmt.create_communicator(args.communicator, device=args.device)
    if args.batchsize % comm.size:
        raise ValueError('--batchsize %d does not divide over %d '
                         'processes' % (args.batchsize, comm.size))
    batch = args.batchsize // comm.size
    if comm.rank == 0:
        print('==========================================')
        print('Num processes: {}'.format(comm.size))
        print('Device: {}'.format(comm.device))
        print('Using {} communicator'.format(args.communicator))
        print('Num unit: {}'.format(args.unit))
        print('Global mini-batch size: {}'.format(args.batchsize))
        print('Num epoch: {}'.format(args.epoch))
        print('==========================================')

    model = MLP(n_units=args.unit, n_out=10, device=comm.device)
    clf = Classifier(model)
    optimizer = cmt.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm)

    train, test = mnist.get_mnist()
    train = cmt.scatter_dataset(train, comm)
    test = cmt.scatter_dataset(test, comm)
    if args.quick:
        train = SubDataset(train, 0, min(500, len(train)))
        args.epoch = min(args.epoch, 2)

    train_iter = training.SerialIterator(train, batch)
    test_iter = training.SerialIterator(test, batch, repeat=False,
                                        shuffle=False)
    updater = training.StandardUpdater(train_iter, optimizer, clf,
                                       model, comm)
    trainer = training.Trainer(updater, (args.epoch, 'epoch'),
                               out=args.out)
    evaluator = cmt.create_multi_node_evaluator(
        training.Evaluator(test_iter, clf.eval_metrics, comm), comm)
    trainer.extend(evaluator, trigger=(1, 'epoch'))
    if comm.rank == 0:
        trainer.extend(extensions.snapshot(), trigger=(1, 'epoch'))
        trainer.extend(extensions.LogReport())
        trainer.extend(extensions.PrintReport(
            ['epoch', 'loss', 'accuracy', 'validation/main/loss',
             'validation/main/accuracy', 'elapsed_time']),
            trigger=(1, 'epoch'))
    if args.resume:
        serializers.resume_updater(args.resume, updater, comm)
    trainer.extend(NanGuard(), trigger=(1, 'iteration'))
    trainer.run()
    if comm.rank == 0:
        print('final observation:', dict(trainer.observation))
    return trainer


if __name__ == '__main__':
    main().updater.comm.close()
