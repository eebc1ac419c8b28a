"""MNIST trained through the pipeline.

The port's twin of ``examples/mnist/train_mnist_pipeline.py`` (the
successor of the reference's 2-stage pipelined MNIST,
``train_mnist_model_parallel.py``): GPipe-style (or 1F1B,
``--schedule``) over a ``(data, stage)`` mesh of processes, one process
a stage, micro-batches streaming through the schedule's tick loop
(:class:`chainermn_tpu_torch.training.PipelineUpdater`).

Stage homogeneity: activations stay ``(micro_b, width)`` end to end;
the last stage's first 10 lanes are the class logits.  Each stage is one
dense layer; hidden stages apply a ReLU and the last stays linear,
branching on the stage index of the bound mesh (the JAX example's
``lax.axis_index('stage')``).  It runs matmuls and the plain
cross-entropy, no kernel of the port's.

    torchrun --standalone --nproc-per-node 2 \\
        -m chainermn_tpu_torch.examples.mnist.train_mnist_pipeline \\
        --cpu --stages 2 --epoch 1                  # gloo
    python -m chainermn_tpu_torch.examples.mnist.train_mnist_pipeline \\
        --stages 1 --epoch 1                        # one card
"""

import argparse

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from chainermn_tpu_torch.communicators.base import join_default_group
from chainermn_tpu_torch.datasets import mnist
from chainermn_tpu_torch.parallel.meshplan import resolve_axis
from chainermn_tpu_torch.parallel.pipeline import stack_stage_params
from chainermn_tpu_torch.training import (
    PipelineUpdater, SerialIterator, pipeline_mesh)


def _parser():
    p = argparse.ArgumentParser(
        description='ChainerMN on PyTorch: pipeline MNIST')
    p.add_argument('--batchsize', '-b', type=int, default=128)
    p.add_argument('--epoch', '-e', type=int, default=3)
    p.add_argument('--stages', type=int, default=2,
                   help='pipeline depth (processes must divide evenly)')
    p.add_argument('--micro', type=int, default=4,
                   help='micro-batches per step')
    p.add_argument('--width', type=int, default=784,
                   help='homogeneous activation width')
    p.add_argument('--remat', action='store_true',
                   help='rematerialize stages in backward (less memory)')
    p.add_argument('--schedule', choices=['gpipe', '1f1b'],
                   default='gpipe',
                   help='1f1b bounds in-flight activations at '
                        '2*stages regardless of --micro')
    p.add_argument('--cpu', action='store_true',
                   help='run on the CPU over gloo')
    return p


def parts(width, n_stages):
    """``(stage_fn, loss_on_last, params_stacked)`` of the example: the
    JAX example's functions and its ``RandomState(0)`` weights."""
    last_stage = n_stages - 1

    def stage_fn(p, x):
        h = x @ p['w'] + p['b']
        if resolve_axis('stage').index == last_stage:
            return h
        return torch.relu(h)

    def loss_on_last(outs, y_micro):
        logits = outs.reshape(-1, width)[:, :10]
        y = y_micro.reshape(-1).long()
        loss = F.cross_entropy(logits, y)
        acc = (logits.argmax(-1) == y).to(torch.float32).mean()
        return loss, {'accuracy': acc}

    rng = np.random.RandomState(0)
    params = [{'w': (rng.randn(width, width).astype(np.float32)
                     * np.sqrt(2.0 / width)).astype(np.float32),
               'b': np.zeros((width,), np.float32)}
              for _ in range(n_stages)]
    return stage_fn, loss_on_last, stack_stage_params(params)


def main(argv=None, max_updates=None):
    """Train and validate; returns ``{'updater', 'losses', 'accuracies',
    'validation'}``.  ``max_updates`` stops after that many updates
    (and skips the validation pass).  The default group is joined and
    destroyed at the end if it was made here."""
    args = _parser().parse_args(argv)
    device, made = join_default_group('cpu' if args.cpu else None)
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    width = args.width
    stage_fn, loss_on_last, stacked = parts(width, args.stages)
    mesh = pipeline_mesh(args.stages, device=device)
    say('mesh: data=%d x stage=%d' % (mesh.shape['data'],
                                      mesh.shape['stage']))
    train, test = mnist.get_mnist()
    train_iter = SerialIterator(train, args.batchsize)
    updater = PipelineUpdater(
        train_iter, lambda ps: torch.optim.Adam(ps, lr=1e-3), stage_fn,
        loss_on_last, stacked, mesh, n_micro=args.micro, remat=args.remat,
        schedule=args.schedule, device=device)

    steps_per_epoch = max(1, len(train) // args.batchsize)
    all_losses, all_accs, out = [], [], {}
    for epoch in range(args.epoch):
        losses, accs = [], []
        for _ in range(steps_per_epoch):
            m = updater.update()
            losses.append(m['loss'])
            accs.append(m['accuracy'])
            if max_updates is not None and len(all_losses) + len(
                    losses) >= max_updates:
                break
        all_losses += losses
        all_accs += accs
        say('epoch %d  loss %.4f  acc %.4f'
            % (epoch + 1, float(np.mean(losses)), float(np.mean(accs))))
        if max_updates is not None and len(all_losses) >= max_updates:
            break
    if max_updates is None:
        # validation on the last stage's logits (the batch must tile the
        # data shards x micro-batches)
        tile = mesh.shape['data'] * args.micro
        n_val = min(1024, len(test)) // tile * tile
        arrays = updater.shard_batch([test[i] for i in range(n_val)])
        m = updater.evaluate(arrays)   # forward only: no update on test
        say('validation: loss %.4f acc %.4f' % (m['loss'], m['accuracy']))
        out['validation'] = m
    if made:
        dist.destroy_process_group()
    out.update(updater=updater, losses=all_losses, accuracies=all_accs)
    return out


if __name__ == '__main__':
    main()
