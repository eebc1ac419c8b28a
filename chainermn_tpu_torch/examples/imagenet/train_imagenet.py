"""Data-parallel ImageNet training.

The port's twin of ``examples/imagenet/train_imagenet.py``: the same
flags and the same flow -- communicator, the arch registry,
``PreprocessedDataset`` scattered over the processes, a
``MultiprocessIterator``, the large-batch learning-rate schedule on
multi-node momentum SGD, ``StatefulClassifier``, the multi-node evaluator
every epoch, snapshot / log / print on rank 0 -- with one process per
device:

    torchrun --nproc_per_node=N \\
        chainermn_tpu_torch/examples/imagenet/train_imagenet.py \\
        --communicator hierarchical
    python chainermn_tpu_torch/examples/imagenet/train_imagenet.py --cpu \\
        --quick --dtype float32     # one process, gloo

``--batchsize`` and ``--val_batchsize`` are global; each process takes
its share.  ``--pipeline native`` augments a whole batch at a time on the
native C++ thread pool (``BatchAugmentPipeline`` over this process's
shard of the raw images, read by a ``PipelineIterator``) instead of
``PreprocessedDataset`` item by item behind a ``MultiprocessIterator``.
``--cpu`` runs on the CPU over gloo (the JAX script's 8 host devices
become however many processes torchrun starts); ``--mesh IxJ`` sets the
communicator's ``mesh_shape``.  ``--arch`` takes every architecture of
``models.get_arch``, each at
its own input size (224; 227 for alex and nin; with ``--quick`` 64, and
96 for alex and nin, as the JAX script sizes them); the dropout of
VGG-16, Alex, NIN and GoogLeNet draws from the updater's generator,
seeded per rank and iteration.  Without ``CHAINERMN_TPU_IMAGENET``
the data is the synthetic stand-in of the JAX script (1280 / 128 images,
512 with ``--quick``).
"""

import argparse
import os
import sys

import numpy as np
import torch

if __package__ in (None, ''):   # run as a script: the repo on the path
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), '..', '..', '..'))

import chainermn_tpu_torch as cmt  # noqa: E402
from chainermn_tpu_torch import ops, serializers, training  # noqa: E402
from chainermn_tpu_torch.datasets import imagenet  # noqa: E402
from chainermn_tpu_torch.models import (  # noqa: E402
    StatefulClassifier, get_arch, load_flax_variables, to_flax_variables)
from chainermn_tpu_torch.training import extensions  # noqa: E402
from chainermn_tpu_torch.utils import distributed_sgd_schedule  # noqa


def _parser():
    parser = argparse.ArgumentParser(
        description='ChainerMN ImageNet (PyTorch)')
    parser.add_argument('--arch', '-a', default='resnet50',
                        help='alex|googlenet|googlenetbn|nin|resnet50|'
                             'resnet50_s2d|resnet101|resnet152|vgg16')
    parser.add_argument('--batchsize', '-B', type=int, default=256,
                        help='global batch size')
    parser.add_argument('--epoch', '-E', type=int, default=10)
    parser.add_argument('--communicator', default='xla')
    parser.add_argument('--loaderjob', '-j', type=int, default=4)
    parser.add_argument('--device-prefetch', type=int, default=2,
                        help='batches collated into pinned memory and '
                             'copied ahead of the running step (0 '
                             'disables)')
    parser.add_argument('--pipeline', choices=['thread', 'native'],
                        default='thread',
                        help='input pipeline: per-item prefetch thread '
                             'or native C++ batch augmentation')
    parser.add_argument('--mean', '-m', default=None,
                        help='mean image npy (computed if absent)')
    parser.add_argument('--out', '-o', default='result')
    parser.add_argument('--resume', '-r', default='')
    parser.add_argument('--initmodel', default='')
    parser.add_argument('--val_batchsize', '-b', type=int, default=64)
    parser.add_argument('--lr', type=float, default=0.01,
                        help='base learning rate at --base-batch '
                             '(linearly scaled to the global batch)')
    parser.add_argument('--base-batch', type=int, default=32,
                        help='batch size the base lr was tuned at')
    parser.add_argument('--cpu', action='store_true')
    parser.add_argument('--mesh', default=None)
    parser.add_argument('--quick', action='store_true')
    parser.add_argument('--allreduce-dtype', default=None,
                        help='cast gradients to this dtype for the '
                             'collective (e.g. bfloat16)')
    parser.add_argument('--double-buffering', action='store_true',
                        help="apply the previous step's reduced "
                             'gradients (a staleness-1 trajectory)')
    parser.add_argument('--dtype', default='bfloat16',
                        choices=['bfloat16', 'float32'])
    return parser


def main(argv=None):
    """Train; returns the trainer after its run, its communicator and
    prefetch threads still up (:func:`close` ends them)."""
    args = _parser().parse_args(argv)
    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(v) for v in args.mesh.split('x'))
    comm = cmt.create_communicator(args.communicator,
                                   device='cpu' if args.cpu else None,
                                   mesh_shape=mesh_shape)
    if args.batchsize % comm.size:
        raise ValueError('--batchsize %d does not divide over %d processes'
                         % (args.batchsize, comm.size))
    batch = args.batchsize // comm.size

    # a tiny synthetic set and small images for smoke runs; alex and nin
    # have VALID-padded stems that collapse below ~68 px (the models
    # raise), so their smoke size is larger.  VGG's and Alex's Dense
    # widths follow the size, so the model is built at it.
    size = {}
    if args.quick:
        size['insize'] = 96 if args.arch in ('alex', 'nin') else 64
    model = get_arch(args.arch, dtype=getattr(torch, args.dtype),
                     device=comm.device, **size)
    insize = model.insize

    if comm.rank == 0:
        print('==========================================')
        print('Num processes: {} (mesh {}x{})'.format(
            comm.size, comm.inter_size, comm.intra_size))
        print('Device: {}'.format(comm.device))
        print('Using {} communicator'.format(args.communicator))
        print('Using {} arch ({} insize {})'.format(
            args.arch, args.dtype, insize))
        print('Global batch-size: {}'.format(args.batchsize))
        print('Num epoch: {}'.format(args.epoch))
        print('==========================================')

    n_train = 512 if args.quick else 1280
    raw_train, raw_val = imagenet.get_imagenet(n_train, 128,
                                               size=insize + 32)
    if args.mean and os.path.exists(args.mean):
        mean = np.load(args.mean)
    else:
        mean = imagenet.compute_mean(raw_train, limit=64)

    val = imagenet.PreprocessedDataset(raw_val, mean, insize, random=False)
    val = cmt.scatter_dataset(val, comm)
    if args.pipeline == 'native':
        # batch-level augmentation on the native C++ thread pool
        raw_shard = cmt.scatter_dataset(raw_train, comm)
        pipe = imagenet.BatchAugmentPipeline(raw_shard, insize, mean=mean)
        train_iter = training.PipelineIterator(pipe, batch)
    else:
        train = imagenet.PreprocessedDataset(raw_train, mean, insize)
        train = cmt.scatter_dataset(train, comm)
        train_iter = training.MultiprocessIterator(
            train, batch, n_prefetch=args.loaderjob)

    if args.initmodel:   # the parameters; BatchNorm statistics stay
        variables = to_flax_variables(model)
        variables['params'] = serializers.load_npz(args.initmodel,
                                                   variables['params'])
        load_flax_variables(model, variables)
    clf = StatefulClassifier(model)

    # the large-batch recipe: the rate scales linearly with the global
    # batch and warms up over the first epochs; len(raw_train) is right
    # for the real lists and for the synthetic stand-in alike
    steps_per_epoch = max(1, len(raw_train) // args.batchsize)
    lr = distributed_sgd_schedule(
        global_batch=args.batchsize, steps_per_epoch=steps_per_epoch,
        base_lr=args.lr, base_batch=args.base_batch,
        warmup_epochs=min(5, args.epoch), total_epochs=max(args.epoch, 1))
    optimizer = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), lr, momentum=0.9), comm,
        allreduce_dtype=(getattr(torch, args.allreduce_dtype)
                         if args.allreduce_dtype else None),
        double_buffering=args.double_buffering)

    val_iter = training.SerialIterator(
        val, max(1, args.val_batchsize // comm.size), repeat=False,
        shuffle=False)
    updater = training.StandardUpdater(
        train_iter, optimizer, clf.loss, model, comm,
        device_prefetch=args.device_prefetch)
    n_epoch = 1 if args.quick else args.epoch
    # async_metrics: the metrics stay on the device each iteration (no
    # per-step host sync); the extensions read them at their triggers
    trainer = training.Trainer(updater, (n_epoch, 'epoch'), out=args.out,
                               async_metrics=True)

    evaluator = cmt.create_multi_node_evaluator(
        training.Evaluator(val_iter, clf.eval_metrics, comm), comm)
    trainer.extend(evaluator, trigger=(1, 'epoch'))

    if comm.rank == 0:
        trainer.extend(extensions.snapshot(), trigger=(1, 'epoch'))
        trainer.extend(extensions.LogReport())
        trainer.extend(extensions.PrintReport(
            ['epoch', 'iteration', 'loss', 'accuracy',
             'validation/main/loss', 'validation/main/accuracy',
             'elapsed_time']), trigger=(1, 'epoch'))

    if args.resume:
        serializers.resume_updater(args.resume, updater, comm)

    trainer.run()
    if comm.rank == 0:
        print('final observation:',
              {k: float(v) for k, v in trainer.observation.items()})
    return trainer


def close(trainer):
    """Stop the prefetch threads and end the process group the
    communicator made."""
    finalize = getattr(trainer.updater.iterator, 'finalize', None)
    if finalize is not None:   # a bare PipelineIterator runs no thread
        finalize()
    trainer.updater.comm.close()


if __name__ == '__main__':
    close(main())
