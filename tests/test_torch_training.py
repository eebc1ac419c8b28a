"""The port's training slice against the JAX package.

Communicators on gloo (a world of one, and two spawned ranks), the
import rule of the port, and the whole slice -- ``StandardUpdater`` +
``Trainer`` with the multi-node ``FusedMomentumSGD`` on a narrow
``ResNet(fused_norm=True)`` -- against the JAX ``StandardUpdater`` on a
one-device mesh with the JAX kernels in Pallas interpret mode, from the
same weights and batches.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import ops as jops
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import StatefulClassifier as JaxClassifier
from chainermn_tpu.models.resnet50 import ResNet as JaxResNet
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import models, ops, training

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------
# communicators

@pytest.mark.parametrize('name', ['xla', 'flat', 'naive', 'dummy'])
def test_world_of_one_allreduce_grad_and_broadcast(name):
    comm = cmt.create_communicator(name, device='cpu')
    assert (comm.size, comm.rank) == (1, 0)
    rng = np.random.RandomState(0)
    vals = [rng.randn(3, 4).astype(np.float32),
            rng.randn(5).astype(np.float32)]
    grads = [torch.from_numpy(v.copy()) for v in vals]
    out = comm.allreduce_grad(grads)
    assert out is grads
    for g, v in zip(grads, vals):  # the mean over one rank
        np.testing.assert_array_equal(g.numpy(), v)
    params = [torch.from_numpy(v.copy()) for v in vals]
    comm.broadcast_data(params)
    for p, v in zip(params, vals):
        np.testing.assert_array_equal(p.numpy(), v)


def test_reduce_dtype_narrows_and_restores():
    comm = cmt.create_communicator('xla', device='cpu',
                                   reduce_dtype=torch.bfloat16)
    v = np.random.RandomState(1).randn(64).astype(np.float32)
    g = torch.from_numpy(v.copy())
    comm.allreduce_grad([g])
    assert g.dtype == torch.float32
    want = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(g.numpy(), want)
    assert not np.array_equal(g.numpy(), v)  # really narrowed


def test_allreduce_ops_and_structures():
    comm = cmt.create_communicator('xla', device='cpu')
    out = comm.allreduce({'loss': torch.tensor(2.5), 'acc': 0.5}, 'mean')
    assert float(out['loss']) == 2.5 and float(out['acc']) == 0.5
    for op in ('sum', 'max', 'min'):
        t = torch.arange(4.0)
        np.testing.assert_array_equal(comm.allreduce(t, op).numpy(),
                                      t.numpy())
    with pytest.raises(ValueError):
        comm.allreduce(torch.zeros(1), 'prod')


ALL_NAMES = ['xla', 'hierarchical', 'two_dimensional', 'flat', 'naive',
             'single_node', 'non_cuda_aware', 'dummy', 'bucketed']


def test_unported_names_raise():
    for name in ALL_NAMES:  # all nine strategies are ported
        comm = cmt.create_communicator(name, device='cpu')
        assert (comm.inter_size, comm.intra_size) == (1, 1)
    with pytest.raises(ValueError):
        cmt.create_communicator('nope', device='cpu')


_RANK_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt

torch.set_num_threads(1)
store_path, rank, out_path, name = sys.argv[1], int(sys.argv[2]), \
    sys.argv[3], sys.argv[4]
dist.init_process_group('gloo', store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
comm = cmt.create_communicator(name, device='cpu')
rng = np.random.RandomState(100 + rank)
grads = [torch.from_numpy(rng.randn(3, 5).astype(np.float32)),
         torch.from_numpy(rng.randn(7).astype(np.float32))]
comm.allreduce_grad(grads)
params = [torch.full((4,), float(rank + 1))]
comm.broadcast_data(params)
stats = comm.allreduce(torch.tensor([float(rank)]), 'mean')
np.savez(out_path, g0=grads[0].numpy(), g1=grads[1].numpy(),
         p=params[0].numpy(), stats=stats.numpy(), size=comm.size,
         rank=comm.rank)
dist.destroy_process_group()
'''


@pytest.mark.parametrize('name', ALL_NAMES)
def test_two_rank_gloo_mean_and_broadcast(tmp_path, name):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK_SCRIPT, str(tmp_path / 'store'),
         str(r), str(tmp_path / ('r%d.npz' % r)), name], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out.decode()
    per_rank = [np.random.RandomState(100 + r) for r in range(2)]
    want = [[rng.randn(3, 5).astype(np.float32),
             rng.randn(7).astype(np.float32)] for rng in per_rank]
    mean0 = (want[0][0] + want[1][0]) / 2
    mean1 = (want[0][1] + want[1][1]) / 2
    for r in range(2):
        got = np.load(tmp_path / ('r%d.npz' % r))
        assert int(got['size']) == 2 and int(got['rank']) == r
        if name == 'dummy':  # packing only: each rank keeps its own
            mean0, mean1 = want[r]
        np.testing.assert_allclose(got['g0'], mean0, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got['g1'], mean1, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(got['p'], np.ones(4, np.float32))
        np.testing.assert_array_equal(got['stats'], [0.5])


def test_no_cuda_and_no_device_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present; the default is valid')
    with pytest.raises(RuntimeError, match='CUDA'):
        cmt.create_communicator()
    with pytest.raises(RuntimeError, match='CUDA'):
        models.ResNet50()


def test_multi_node_optimizer_double_buffering_not_ported():
    """Ported now: under double buffering the fill step leaves the
    parameter and ``FusedMomentumSGD``'s velocity as they were, and the
    next step applies the fill step's gradient."""
    comm = cmt.create_communicator('xla', device='cpu')
    w = torch.zeros(2, requires_grad=True)
    inner = ops.FusedMomentumSGD([w], 0.1)
    opt = cmt.create_multi_node_optimizer(inner, comm, double_buffering=True)
    opt.step()                                  # the broadcast
    for g, want in ((1.0, 0.0), (2.0, -0.1)):
        w.grad = torch.full((2,), g)
        opt.step()
        np.testing.assert_allclose(w.detach().numpy(), [want] * 2,
                                   rtol=1e-6)
        assert (w in inner.state) == (want != 0.0)


# ---------------------------------------------------------------------
# the import rule

_FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'chainermn_tpu')


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split('.')[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split('.')[0], node.lineno


def test_port_never_imports_jax_or_the_jax_package():
    files = sorted((REPO / 'chainermn_tpu_torch').rglob('*.py'))
    files.append(REPO / 'chip_smoke.py')
    assert len(files) > 10
    for module in ('parallel/meshplan.py', 'parallel/tensor.py',
                   'parallel/sequence.py', 'parallel/zero.py',
                   'examples/lm/train_lm.py', 'parallel/pipeline.py',
                   'training/pipeline_updater.py',
                   'examples/lm/train_lm_pipeline.py',
                   'examples/mnist/train_mnist_pipeline.py'):
        assert REPO / 'chainermn_tpu_torch' / module in files
    bad = ['%s:%d imports %s' % (f.relative_to(REPO), line, root)
           for f in files for root, line in _imported_roots(f)
           if root in _FORBIDDEN]
    assert not bad, bad


# ---------------------------------------------------------------------
# the whole slice against the JAX package

@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    assert jcommon.pallas_mode() == 'interpret'


def _dataset(n=4, size=32, classes=10):
    rng = np.random.RandomState(7)
    return [(rng.randn(size, size, 3).astype(np.float32),
             np.int32(rng.randint(classes))) for _ in range(n)]


def test_training_slice_matches_jax(interpret, tmp_path):
    steps, lr, mu = 3, 0.1, 0.9
    data = _dataset()
    jmodel = JaxResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                       dtype=jnp.float32, fused_norm=True)
    variables = jax.device_get(jmodel.init(
        {'params': jax.random.PRNGKey(3)}, jnp.zeros((1, 32, 32, 3)),
        train=False))
    # JAX: one-device mesh (conftest gives JAX 8 virtual devices)
    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jopt = chainermn_tpu.create_multi_node_optimizer(
        jops.fused_momentum_sgd(lr, mu), jcomm)
    jup = jtraining.StandardUpdater(
        jtraining.SerialIterator(data, 4, shuffle=False), jopt,
        JaxClassifier(jmodel).loss, variables['params'], jcomm,
        model_state={'batch_stats': variables['batch_stats']})
    # the port, from the same weights and batches
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                          dtype=torch.float32, fused_norm=True,
                          device='cpu')
    models.load_flax_variables(model, variables)
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), lr, mu), comm)
    up = training.StandardUpdater(
        training.SerialIterator(data, 4, shuffle=False), opt,
        models.StatefulClassifier(model).loss, model, comm)
    trainer = training.Trainer(up, (steps, 'iteration'), out=str(tmp_path))
    seen = []

    def compare(tr):
        jm = jup.update()
        seen.append((tr.observation['loss'], jm['loss']))
        np.testing.assert_allclose(tr.observation['loss'], jm['loss'],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tr.observation['accuracy'],
                                   jm['accuracy'])
        got = models.to_flax_variables(model)
        want = {'params': jax.device_get(jup.params),
                'batch_stats': jax.device_get(
                    jup.model_state['batch_stats'])}
        for coll in ('params', 'batch_stats'):
            g = jax.tree_util.tree_leaves_with_path(got[coll])
            w = dict(jax.tree_util.tree_leaves_with_path(want[coll]))
            assert len(g) == len(w)
            for path, leaf in g:
                np.testing.assert_allclose(
                    leaf, np.asarray(w[path]), rtol=1e-4, atol=1e-4,
                    err_msg='%s %s step %d' % (coll, path, len(seen)))

    trainer.extend(compare, trigger=(1, 'iteration'))
    trainer.run()
    assert up.iteration == steps and len(seen) == steps
    # step 0 broadcasts instead of stepping: same batch, same loss
    assert seen[0][0] == seen[1][0]
    assert seen[2][0] != seen[1][0]
