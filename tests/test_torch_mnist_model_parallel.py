"""The model-parallel MNIST twin against the JAX twin.

``examples/mnist/train_mnist_model_parallel.py``'s step (two ``MLP``
stages on two devices through the JAX ``MultiNodeChainList``,
``optax.adam(1e-3)``, the mean cross-entropy, ``SerialIterator`` over
the quick set at batch 100) gives the first 5 losses; the port's twin
(``chainermn_tpu_torch.examples.mnist.train_mnist_model_parallel``)
starts from the same flax weights, in a world of one, on 2 gloo ranks
(stage k on rank k) and on 3 (rank 2 has no stage and only takes the
broadcast logits), and must give them at rtol 1e-4, every rank the same
loss, each stage's parameters stepped on its own rank only.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu import training as jtraining
from chainermn_tpu.dataset import SubDataset
from chainermn_tpu.datasets import mnist as jmnist
from chainermn_tpu.models import MLP as JaxMLP

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
UNIT = 200
STEPS = 5
WORLDS = (1, 2, 3)

_RANK_SCRIPT = r'''
import pickle
import sys
import numpy as np
import torch
import torch.distributed as dist
from chainermn_tpu_torch.examples.mnist import train_mnist_model_parallel

torch.set_num_threads(1)
store, rank, world, inp, out = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4], sys.argv[5])
dist.init_process_group('gloo', store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
with open(inp, 'rb') as f:
    variables = pickle.load(f)
before = [[p.detach().clone() for p in s.parameters()] for s in
          train_mnist_model_parallel.main(
              ['--cpu', '--quick'], variables=variables,
              max_iterations=0).stages]
run = train_mnist_model_parallel.main(['--cpu', '--quick'],
                                      variables=variables,
                                      max_iterations=%d)
moved = [any(not torch.equal(a, b) for a, b in zip(s.parameters(), ps))
         for s, ps in zip(run.stages, before)]
with open(out, 'wb') as f:
    pickle.dump({'losses': run.losses, 'moved': moved}, f)
dist.destroy_process_group()
''' % STEPS


@pytest.fixture(scope='module')
def jax_run():
    """The JAX twin's step, as its script builds it, for STEPS
    iterations of the quick set."""
    comm = chainermn_tpu.create_communicator(
        'xla', mesh_shape=(1, 2), devices=jax.devices()[:2])
    stage0 = JaxMLP(n_units=UNIT, n_out=UNIT)
    stage1 = JaxMLP(n_units=UNIT, n_out=10)
    p0 = stage0.init(jax.random.PRNGKey(0), jnp.zeros((1, 784)))
    p1 = stage1.init(jax.random.PRNGKey(1), jnp.zeros((1, UNIT)))
    model = chainermn_tpu.MultiNodeChainList(comm, place=True)
    model.add_link(lambda p, x: stage0.apply(p, x), rank_in=None,
                   rank_out=1, rank=0)
    model.add_link(lambda p, h: stage1.apply(p, h), rank_in=0,
                   rank_out=None, rank=1)
    train, _ = jmnist.get_mnist()
    train = SubDataset(train, 0, 500)
    optimizer = optax.adam(1e-3)
    params = [p0, p1]
    opt_state = optimizer.init(params)

    @jax.jit
    def train_step(params, opt_state, x, y):
        def loss_fn(ps):
            return optax.softmax_cross_entropy_with_integer_labels(
                model(ps, x), y).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    it = jtraining.SerialIterator(train, 100)
    variables = jax.tree_util.tree_map(np.asarray, params)
    losses = []
    for _ in range(STEPS):
        batch = it.next()
        x = np.stack([b[0] for b in batch])
        y = np.stack([b[1] for b in batch])
        params, opt_state, loss = train_step(params, opt_state, x, y)
        losses.append(float(loss))
    return variables, losses


@pytest.fixture(scope='module')
def port_runs(tmp_path_factory, jax_run):
    tmp = tmp_path_factory.mktemp('mnist_mp')
    variables, _ = jax_run
    inp = tmp / 'variables.pkl'
    with open(inp, 'wb') as f:
        pickle.dump(variables, f)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    for world in WORLDS:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, '-c', _RANK_SCRIPT,
                 str(tmp / ('store%d' % world)), str(r), str(world),
                 str(inp), str(tmp / ('w%d_r%d.pkl' % (world, r)))],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            assert p.returncode == 0, out.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    out = {}
    for world in WORLDS:
        out[world] = []
        for r in range(world):
            with open(tmp / ('w%d_r%d.pkl' % (world, r)), 'rb') as f:
                out[world].append(pickle.load(f))
    return out


@pytest.mark.parametrize('world', WORLDS)
def test_first_losses_match_the_jax_twin(jax_run, port_runs, world):
    _, want = jax_run
    for rank, res in enumerate(port_runs[world]):
        assert len(res['losses']) == STEPS
        np.testing.assert_allclose(res['losses'], want, rtol=1e-4)
        if world == 1:
            assert res['moved'] == [True, True]
        else:   # stage k steps on rank k only
            assert res['moved'] == [rank == 0, rank == 1]


def test_quick_run_learns(tmp_path):
    """A whole ``--quick`` epoch in one process: the loss falls and the
    validation accuracy is a fraction."""
    from chainermn_tpu_torch.examples.mnist import (
        train_mnist_model_parallel)
    run = train_mnist_model_parallel.main(
        ['--cpu', '--quick', '--unit', '50', '--out', str(tmp_path)])
    try:
        assert len(run.losses) == 5 and len(run.val_accuracy) == 1
        assert run.losses[-1] < run.losses[0]
        assert 0.0 <= run.val_accuracy[0] <= 1.0
    finally:
        run.comm.close()
