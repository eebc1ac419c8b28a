"""The twins of ``examples/lm/train_lm_pipeline.py`` and
``examples/mnist/train_mnist_pipeline.py`` against the JAX examples.

- two gloo processes: the LM twin at ``--cpu --quick --stages 2`` from
  the JAX example's init tree, its first three losses against the JAX
  example's loop run here (the same ``pipeline_parts`` split, AdamW,
  windows; f32, rtol 1e-5); and the MNIST twin's first three updates
  under ``gpipe``, ``gpipe --remat`` and ``1f1b``, then ``evaluate`` on
  test rows, against the JAX example's stage function, loss and
  ``PipelineUpdater`` (losses and validation metrics, rtol 1e-5);
- four gloo processes: the LM twin with ``--tp 2`` (each stage a
  Megatron ``tp_transformer_block`` through the conjugate pair, the JAX
  example's ``_tp_parts`` weights) against the JAX example's tp loop;
- the LM twin under ``torchrun`` on two processes, as a user runs it.
"""

import functools
import importlib.util
import os
import re
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models.transformer import pipeline_parts
from chainermn_tpu.parallel.pipeline import stack_stage_params
from chainermn_tpu.training import SerialIterator as JaxSerialIterator
from chainermn_tpu.training.pipeline_updater import (
    PipelineUpdater as JaxPipelineUpdater, pipeline_mesh as jpipeline_mesh)
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
QUICK = Namespace(batchsize=8, seq_len=128, vocab=512, d_model=128,
                  n_heads=4, layers_per_stage=1, micro=4, lr=3e-4, tp=1)
STEPS = 3
MNIST_UPDATES = 3
MNIST_RUNS = (('gpipe', False), ('gpipe', True), ('1f1b', False))
N_VAL = 64


@functools.lru_cache(maxsize=None)
def _jax_example():
    """The JAX example module (its ``_tp_parts``; ``train_lm`` beside
    it on the path)."""
    path = REPO / 'examples' / 'lm'
    sys.path.insert(0, str(path))
    try:
        spec = importlib.util.spec_from_file_location(
            'jax_train_lm_pipeline', path / 'train_lm_pipeline.py')
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(path))
    return module


def _lm_model():
    a = QUICK
    return JaxLM(vocab_size=a.vocab, d_model=a.d_model, n_heads=a.n_heads,
                 n_layers=2 * a.layers_per_stage, d_ff=4 * a.d_model,
                 max_len=a.seq_len, dtype=jnp.float32)


@functools.lru_cache(maxsize=None)
def _lm_params():
    return jax.device_get(_lm_model().init(
        jax.random.PRNGKey(0), jnp.zeros((1, QUICK.seq_len), jnp.int32))
        ['params'])


@functools.lru_cache(maxsize=None)
def _jax_lm_losses(tp):
    """The JAX example's loop (``main`` after its argument parsing) at
    ``--quick --stages 2 [--tp 2]`` for ``STEPS`` steps."""
    example = _jax_example()
    args = Namespace(**vars(QUICK))
    args.tp = tp
    mesh = jpipeline_mesh(2, devices=jax.devices()[:4], n_tp=tp)
    if tp == 1:
        sf, pro, ll, st, ex = pipeline_parts(_lm_model(), _lm_params(), 2)
        specs = None
    else:
        sf, pro, ll, st, ex, specs = example._tp_parts(args, 2)
    corpus = example.synthetic_tokens(
        args.batchsize * (args.seq_len + 1) * 8, args.vocab,
        np.random.RandomState(0))

    def sample_batch(step):
        span = args.batchsize * (args.seq_len + 1)
        i = (step * args.batchsize * args.seq_len) % (len(corpus) - span)
        w = corpus[i:i + span].reshape(args.batchsize, args.seq_len + 1)
        return [(w[j, :-1], w[j, 1:]) for j in range(args.batchsize)]

    upd = JaxPipelineUpdater(
        iter([]), optax.adamw(args.lr, weight_decay=0.01), sf, ll, st, mesh,
        n_micro=args.micro, prologue=pro, extra_params=ex,
        param_specs=specs)
    return np.array([float(upd.update_core(upd.shard_batch(
        sample_batch(s)))['loss']) for s in range(STEPS)])


_BODY = r'''
from chainermn_tpu_torch.datasets import mnist
from chainermn_tpu_torch.examples.lm import train_lm_pipeline
from chainermn_tpu_torch.examples.mnist import train_mnist_pipeline

steps = argv[1]
if n == 2:
    out = train_lm_pipeline.main(
        ['--cpu', '--quick', '--stages', '2', '--steps', steps],
        params=load_tree(argv[0], 'params/'))
    res['lm'] = np.array(out['losses'])
    res['lm_local'] = np.array(sum(p.numel() for p in
                                   out['updater']._stage_list))
    _, test = mnist.get_mnist()
    rows = [test[i] for i in range(int(argv[3]))]
    for sched, remat in eval(argv[2]):
        flags = ['--cpu', '--stages', '2', '--schedule', sched]
        if remat:
            flags.append('--remat')
        out = train_mnist_pipeline.main(flags, max_updates=int(argv[4]))
        key = 'mnist/%s%d' % (sched, remat)
        res[key + '/loss'] = np.array(out['losses'])
        res[key + '/acc'] = np.array(out['accuracies'])
        upd = out['updater']
        m = upd.evaluate(upd.shard_batch(rows))
        res[key + '/val'] = np.array([m['loss'], m['accuracy']])
else:
    out = train_lm_pipeline.main(
        ['--cpu', '--quick', '--stages', '2', '--tp', '2', '--steps', steps])
    res['lm_tp'] = np.array(out['losses'])
'''


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    out = {}
    for n in (2, 4):
        tmp = tmp_path_factory.mktemp('twins%d' % n)
        save_tree(tmp / 'in.npz', {'params': _lm_params()})
        out[n] = spawn(tmp, _BODY, n, [tmp / 'in.npz', STEPS,
                                       repr(MNIST_RUNS), N_VAL,
                                       MNIST_UPDATES], deadline=300)
    return out


def test_lm_twin_first_losses_match_the_jax_example(ranks):
    want = _jax_lm_losses(1)
    for res in ranks[2]:
        np.testing.assert_allclose(res['lm'], want, rtol=1e-5)
    # each process holds one stage of the two: half the body
    body = sum(v.size for k, v in flat_tree(_lm_params()).items()
               if k.startswith('block_'))
    assert int(ranks[2][0]['lm_local']) * 2 == body


def test_lm_twin_tp_first_losses_match_the_jax_example(ranks):
    want = _jax_lm_losses(2)
    for res in ranks[4]:
        np.testing.assert_allclose(res['lm_tp'], want, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_mnist(schedule, remat):
    """The JAX example's functions and updater (``main`` of
    ``examples/mnist/train_mnist_pipeline.py`` at ``--stages 2``) for
    ``MNIST_UPDATES`` updates, then ``evaluate`` on the first test
    rows."""
    from chainermn_tpu.datasets import mnist
    width, last_stage = 784, 1

    def stage_fn(p, x):
        h = x @ p['w'] + p['b']
        me = jax.lax.axis_index('stage')
        return jnp.where(me == last_stage, h, jnp.maximum(h, 0.0))

    def loss_on_last(outs, y_micro):
        logits = outs.reshape(-1, width)[:, :10]
        y = y_micro.reshape(-1)
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, y).mean()
        acc = jnp.mean((jnp.argmax(logits, -1) == y).astype(jnp.float32))
        return loss, {'accuracy': acc}

    rng = np.random.RandomState(0)
    params = [
        {'w': jnp.asarray(
            rng.randn(width, width).astype(np.float32)
            * np.sqrt(2.0 / width)),
         'b': jnp.zeros((width,), jnp.float32)}
        for _ in range(2)]
    train, test = mnist.get_mnist()
    updater = JaxPipelineUpdater(
        JaxSerialIterator(train, 128), optax.adam(1e-3), stage_fn,
        loss_on_last, stack_stage_params(params),
        jpipeline_mesh(2, devices=jax.devices()[:2]), n_micro=4,
        remat=remat, schedule=schedule)
    ms = [updater.update() for _ in range(MNIST_UPDATES)]
    m = updater.evaluate(updater.shard_batch(
        [test[i] for i in range(N_VAL)]))
    return (np.array([x['loss'] for x in ms]),
            np.array([x['accuracy'] for x in ms]),
            np.array([m['loss'], m['accuracy']]))


@pytest.mark.parametrize('schedule,remat', MNIST_RUNS)
def test_mnist_twin_first_updates_match_the_jax_example(ranks, schedule,
                                                        remat):
    loss, acc, val = _jax_mnist(schedule, remat)
    key = 'mnist/%s%d' % (schedule, remat)
    for res in ranks[2]:
        np.testing.assert_allclose(res[key + '/loss'], loss, rtol=1e-5)
        np.testing.assert_allclose(res[key + '/acc'], acc, rtol=1e-5)
        np.testing.assert_allclose(res[key + '/val'], val, rtol=1e-5)


def test_lm_twin_runs_under_torchrun(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    cmd = [sys.executable, '-m', 'torch.distributed.run', '--standalone',
           '--nproc-per-node', '2', '-m',
           'chainermn_tpu_torch.examples.lm.train_lm_pipeline', '--cpu',
           '--quick', '--stages', '2', '--steps', '4']
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "mesh: {'data': 1, 'stage': 2}  (2 layers, 1 per stage)" \
        in out.stdout
    first, last = (float(v) for v in re.search(
        r'loss ([0-9.]+) -> ([0-9.]+) \(uniform', out.stdout).groups())
    assert last < first
    assert re.search(r'body params: [0-9.]+M total, [0-9.]+M per device '
                     r'\(1/2\.0\)', out.stdout)
