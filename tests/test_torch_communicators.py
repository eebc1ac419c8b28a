"""The port's nine communicator strategies against the JAX package's.

Four gloo processes run every strategy on the (inter, intra) meshes
(1, 4), (2, 2) and (4, 1), in f32 and with ``reduce_dtype=bfloat16``,
twice each (the reference's lazy-init check); parameter *k* holds
``rank + k`` (the fixture of ``tests/test_communicator.py``).  Each
rank's result is held against the JAX communicator of the same name and
mesh shape on 4 of the 8 forced host devices, and against the analytic
mean ``(size - 1) / 2 + k``.  The topology, the sub-groups, the
non-CUDA-aware staging dtype and the bucket plan are checked against the
JAX package's too.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu.communicators.bucketed_communicator import (
    BucketedCommunicator as JaxBucketed)
from chainermn_tpu.communicators.mesh_utility import AXES
from chainermn_tpu.communicators.non_cuda_aware_communicator import (
    NonCudaAwareCommunicator as JaxNonCudaAware)
from chainermn_tpu.models.resnet50 import ResNet50 as JaxResNet50
from chainermn_tpu_torch.communicators import (
    memory_utility, mesh_utility)
from chainermn_tpu_torch.communicators.bucketed_communicator import (
    BucketedCommunicator)
from chainermn_tpu_torch.communicators.non_cuda_aware_communicator import (
    NonCudaAwareCommunicator)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SIZE = 4
SHAPES = [(3, 2), (4, 5), (6, 7)]
MESH_SHAPES = [(1, 4), (2, 2), (4, 1)]
NAMES = ['xla', 'hierarchical', 'two_dimensional', 'flat', 'naive',
         'single_node', 'non_cuda_aware', 'dummy', 'bucketed']
DTYPES = ['float32', 'bfloat16']   # bfloat16: reduce_dtype
BF16_RTOL = 2e-2   # tests/test_communicator.py's bf16 tolerance

_RANK_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt

torch.set_num_threads(1)
store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
names, meshes = sys.argv[4].split(','), eval(sys.argv[5])
shapes = eval(sys.argv[6])
dist.init_process_group('gloo', store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
res = {}
for name in names:
    for mesh in meshes:
        for dt in ('float32', 'bfloat16'):
            key = '%s/%dx%d/%s' % (name, mesh[0], mesh[1], dt)
            try:
                comm = cmt.create_communicator(
                    name, device='cpu', mesh_shape=mesh,
                    reduce_dtype=None if dt == 'float32' else torch.bfloat16)
            except ValueError:
                res[key + '/raises'] = np.int8(1)
                continue
            res[key + '/topology'] = np.array(
                [comm.inter_size, comm.intra_size, comm.inter_rank(),
                 comm.intra_rank(), comm.axis_rank()])
            for run in range(2):
                grads = [torch.full(sh, float(rank + k))
                         for k, sh in enumerate(shapes)]
                comm.allreduce_grad(grads)
                for k, g in enumerate(grads):
                    assert g.dtype == torch.float32
                    res['%s/%d/p%d' % (key, run, k)] = g.numpy()
np.savez(out, **res)
dist.destroy_process_group()
'''


def _spawn(tmp_path, script, argv, n):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', script, str(tmp_path / 'store'), str(r),
         str(tmp_path / ('r%d.npz' % r))] + argv, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(n)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()
    return [dict(np.load(tmp_path / ('r%d.npz' % r))) for r in range(n)]


@pytest.fixture(scope='module')
def torch_results(tmp_path_factory):
    """Every rank's results of every (strategy, mesh, dtype), from one
    run of four gloo processes."""
    return _spawn(tmp_path_factory.mktemp('comm'), _RANK_SCRIPT,
                  [','.join(NAMES), repr(MESH_SHAPES), repr(SHAPES)], SIZE)


def _jax_allreduce(name, mesh_shape, dtype):
    """Per-device ``allreduce_grad`` results of the JAX communicator on
    4 of the 8 host devices (stacked by device rank), or None when its
    construction raises ``ValueError``."""
    try:
        comm = chainermn_tpu.create_communicator(
            name, devices=jax.devices()[:SIZE], mesh_shape=mesh_shape,
            reduce_dtype=None if dtype == 'float32' else 'bfloat16')
    except ValueError:
        return None

    def f():
        r = comm.axis_rank().astype(jnp.float32)
        grads = {'p%d' % k: jnp.full(sh, r + k)
                 for k, sh in enumerate(SHAPES)}
        out = comm.allreduce_grad(grads)
        return jax.tree_util.tree_map(lambda x: x[None], out)

    fn = jax.jit(jax.shard_map(f, mesh=comm.mesh, in_specs=(),
                               out_specs=P(AXES), check_vma=False))
    out = fn()
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


@pytest.mark.parametrize('dtype', DTYPES)
@pytest.mark.parametrize('mesh_shape', MESH_SHAPES)
@pytest.mark.parametrize('name', NAMES)
def test_allreduce_grad_matches_jax(torch_results, name, mesh_shape, dtype):
    key = '%s/%dx%d/%s' % (name, mesh_shape[0], mesh_shape[1], dtype)
    want = _jax_allreduce(name, mesh_shape, dtype)
    if want is None:   # single_node on more than one node
        assert name == 'single_node' and mesh_shape[0] > 1
        assert all(key + '/raises' in res for res in torch_results)
        return
    rtol = 1e-5 if dtype == 'float32' else BF16_RTOL
    for rank, res in enumerate(torch_results):
        inter, intra, inter_rank, intra_rank, axis_rank = \
            res[key + '/topology']
        assert (inter, intra) == mesh_shape
        assert (inter_rank, intra_rank) == (rank // intra, rank % intra)
        assert axis_rank == rank
        for run in range(2):
            for k, sh in enumerate(SHAPES):
                got = res['%s/%d/p%d' % (key, run, k)]
                assert got.shape == sh
                np.testing.assert_allclose(got, want['p%d' % k][rank],
                                           rtol=rtol)
                # the analytic mean; dummy reduces nothing
                expect = rank + k if name == 'dummy' else \
                    (SIZE - 1) / 2.0 + k
                np.testing.assert_allclose(got, np.full(sh, expect),
                                           rtol=rtol)


def test_single_node_raises_on_two_nodes():
    with pytest.raises(ValueError, match='inter_size == 1'):
        chainermn_tpu.create_communicator(
            'single_node', devices=jax.devices()[:SIZE], mesh_shape=(2, 2))
    # the port checks the same rule on its own mesh: one process cannot
    # make a (2, 2) mesh, so its shape check comes first
    with pytest.raises(ValueError, match='does not cover'):
        cmt.create_communicator('single_node', device='cpu',
                                mesh_shape=(2, 2))


@pytest.mark.parametrize('mesh_shape', [(1, 4), (2, 2), (4, 1), (-1, 2),
                                        (2, -1), None])
def test_mesh_shape_and_groups_match_jax_layout(monkeypatch, mesh_shape):
    """The (inter, intra) shape and the ranks of each sub-group: a row of
    the JAX mesh is an intra group, a column an inter group."""
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '2')
    shape = mesh_utility.resolve_mesh_shape(SIZE, mesh_shape)
    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:SIZE],
        mesh_shape=(2, 2) if mesh_shape is None else mesh_shape)
    assert shape == (jcomm.inter_size, jcomm.intra_size)
    ids = np.vectorize(lambda d: d.id)(jcomm.mesh.devices)
    ids = ids - ids.min()
    rows, cols = mesh_utility.group_ranks(*shape)
    assert rows == ids.tolist() and cols == ids.T.tolist()


@pytest.mark.parametrize('mesh_shape', [(3, 1), (2, 3), (0, 4), (5, -1)])
def test_mesh_shape_that_does_not_cover_raises(mesh_shape):
    with pytest.raises(ValueError, match='does not cover'):
        mesh_utility.resolve_mesh_shape(SIZE, mesh_shape)


def test_detect_topology_from_torchrun_env(monkeypatch):
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '4')
    assert mesh_utility.detect_topology(8) == (2, 4)
    monkeypatch.setenv('LOCAL_WORLD_SIZE', '3')   # does not tile
    assert mesh_utility.detect_topology(8) == (1, 8)
    monkeypatch.delenv('LOCAL_WORLD_SIZE')
    assert mesh_utility.detect_topology(8) == (1, 8)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_non_cuda_aware_stage_dtype_is_jax_rule(dtype):
    jdt = {torch.float64: np.float64, torch.float32: jnp.float32,
           torch.bfloat16: jnp.bfloat16}[dtype]
    # JAX's rule (non_cuda_aware_communicator.py:30-41): narrow to
    # inter_dtype when wider, never widen
    narrow = jnp.dtype(jdt).itemsize > jnp.dtype(
        JaxNonCudaAware.inter_dtype).itemsize
    want = JaxNonCudaAware.inter_dtype if narrow else jdt
    got = NonCudaAwareCommunicator.stage_dtype(dtype)
    assert jnp.dtype(want).name == str(got).replace('torch.', '')


def test_non_cuda_aware_world_of_one_f64():
    comm = cmt.create_communicator('non_cuda_aware', device='cpu')
    g = torch.linspace(0, 1, 7, dtype=torch.float64)
    want = g.clone()
    comm.allreduce_grad([g])
    assert g.dtype == torch.float64   # staged in f32, restored
    np.testing.assert_array_equal(g.numpy(),
                                  want.float().double().numpy())


def _resnet50_leaves():
    shapes = jax.eval_shape(
        lambda: JaxResNet50(num_classes=1000).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)),
            train=False))['params']
    return jax.tree_util.tree_leaves(shapes)


@pytest.mark.parametrize('bucket_mb', [25.0, 0.001])
@pytest.mark.parametrize('mixed', [False, True])
def test_plan_buckets_matches_jax_on_resnet50(bucket_mb, mixed):
    leaves = _resnet50_leaves()
    assert len(leaves) == 161
    if mixed:   # bf16 kernels beside f32 norm parameters
        leaves = [jax.ShapeDtypeStruct(
            leaf.shape, jnp.bfloat16 if len(leaf.shape) > 1 else jnp.float32)
            for leaf in leaves]
    jcomm = JaxBucketed(devices=jax.devices()[:1], mesh_shape=(1, 1),
                        bucket_mb=bucket_mb)
    want = jcomm.plan_buckets(leaves)
    tensors = [torch.empty(leaf.shape, device='meta',
                           dtype=getattr(torch, jnp.dtype(leaf.dtype).name))
               for leaf in leaves]
    comm = BucketedCommunicator(device='cpu', bucket_mb=bucket_mb)
    got = comm.plan_buckets(tensors)
    assert got == want
    assert sorted(i for b in got for i in b) == list(range(len(leaves)))
    if bucket_mb == 25.0:
        assert 4 <= len(got) <= 6   # ~102 MB of f32 in 25 MB buckets
    with pytest.raises(ValueError):
        BucketedCommunicator(device='cpu', bucket_mb=0)


def test_plan_by_dtype_orders_groups_by_dtype_name():
    ts = [torch.zeros(2), torch.zeros(3, dtype=torch.bfloat16),
          torch.zeros(4), torch.zeros(1, dtype=torch.bfloat16)]
    assert memory_utility.plan_by_dtype(ts) == [[1, 3], [0, 2]]
    buf, n = memory_utility.pad_to_multiple(torch.arange(5.0), 4)
    assert n == 5 and buf.tolist() == [0, 1, 2, 3, 4, 0, 0, 0]


@pytest.mark.parametrize('name', NAMES)
def test_world_of_one_mixed_dtypes_keep_their_dtypes(name):
    """bf16 and f32 gradients are never packed together (except by
    ``flat``, which promotes and restores)."""
    comm = cmt.create_communicator(name, device='cpu')
    a = torch.full((4, 4), 3.0, dtype=torch.bfloat16)
    b = torch.full((3,), 1000.25)
    comm.allreduce_grad([a, b])
    assert a.dtype == torch.bfloat16 and b.dtype == torch.float32
    assert (a == 3.0).all() and (b == 1000.25).all()
