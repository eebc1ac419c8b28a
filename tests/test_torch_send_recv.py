"""The port's ``CommunicatorBase.send_recv`` against the JAX package's.

Four gloo processes on the (inter, intra) = (2, 2) mesh run every
strategy's ``send_recv`` over a ring, a partial permutation and a
permutation with a self pair, along both mesh axes at once (global
ranks), along ``'intra'`` and along ``'inter'``.  Process *r* sends
``10 r + arange(6)`` shaped ``(2, 3)``.  Each rank's received tensor is
held, exactly, against what the JAX ``send_recv`` (``lax.ppermute``)
gives its device on the same mesh of 4 of the 8 forced host devices,
with the same inputs and ``perm``: the peer mapping along each axis, the
self-pair copy and the zeros of a rank no pair sends to.
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

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
SIZE = 4
MESH = (2, 2)
NAMES = ['xla', 'hierarchical', 'two_dimensional', 'flat', 'naive',
         'single_node', 'non_cuda_aware', 'dummy', 'bucketed']
# (axis, line length) -> {case: perm of indices along that line}
AXES = {'both': 4, 'intra': 2, 'inter': 2}
PERMS = {
    4: {'ring': [(i, (i + 1) % 4) for i in range(4)],
        'partial': [(0, 2), (3, 1)],
        'self_pair': [(1, 1), (0, 3), (3, 0)]},
    2: {'ring': [(0, 1), (1, 0)],
        'partial': [(1, 0)],
        'self_pair': [(0, 0)]},
}
CASES = [(axis, case) for axis in AXES for case in PERMS[AXES[axis]]]

_RANK_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch.communicators import mesh_utility

torch.set_num_threads(1)
store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
names, mesh, cases = sys.argv[4].split(','), eval(sys.argv[5]), \
    eval(sys.argv[6])
dist.init_process_group('gloo', store=dist.FileStore(store, 4), rank=rank,
                        world_size=4)
x = 10.0 * rank + torch.arange(6, dtype=torch.float32).reshape(2, 3)
res = {}
for name in names:
    try:
        comm = cmt.create_communicator(name, device='cpu', mesh_shape=mesh)
    except ValueError:
        res[name + '/raises'] = np.int8(1)
        continue
    for axis, case, perm in cases:
        ax = mesh_utility.AXES if axis == 'both' else axis
        y = comm.send_recv(x, perm, axis=ax)
        assert y.shape == x.shape and y.dtype == x.dtype
        res['%s/%s/%s' % (name, axis, case)] = y.numpy()
np.savez(out, **res)
dist.destroy_process_group()
'''


@pytest.fixture(scope='module')
def torch_results(tmp_path_factory):
    """Every rank's received tensors of every (strategy, axis, perm),
    from one run of four gloo processes."""
    tmp = tmp_path_factory.mktemp('send_recv')
    cases = [(a, c, PERMS[AXES[a]][c]) for a, c in CASES]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK_SCRIPT, str(tmp / 'store'), str(r),
         str(tmp / ('r%d.npz' % r)), ','.join(NAMES), repr(MESH),
         repr(cases)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(SIZE)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out.decode()
    return [dict(np.load(tmp / ('r%d.npz' % r))) for r in range(SIZE)]


def _jax_send_recv(axis, perm):
    """Per-device ``send_recv`` results of the JAX communicator on the
    (2, 2) mesh of 4 host devices, by global rank (row-major over
    (inter, intra))."""
    comm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:SIZE], mesh_shape=MESH)
    ax = ('inter', 'intra') if axis == 'both' else axis

    def step(x):
        return comm.send_recv(x, perm, axis=ax)

    fn = jax.jit(jax.shard_map(
        step, mesh=comm.mesh, in_specs=P('inter', 'intra'),
        out_specs=P('inter', 'intra'), check_vma=False))
    contrib = (10.0 * jnp.arange(SIZE, dtype=jnp.float32)[:, None, None]
               + jnp.arange(6, dtype=jnp.float32).reshape(1, 2, 3))
    out = fn(contrib.reshape(MESH + (2, 3)))
    return np.asarray(out).reshape(SIZE, 2, 3)


@pytest.mark.parametrize('axis,case', CASES,
                         ids=['%s-%s' % c for c in CASES])
def test_send_recv_matches_jax(torch_results, axis, case):
    want = _jax_send_recv(axis, PERMS[AXES[axis]][case])
    ran = 0
    for name in NAMES:
        if name + '/raises' in torch_results[0]:
            assert name == 'single_node'
            continue
        for rank in range(SIZE):
            got = torch_results[rank]['%s/%s/%s' % (name, axis, case)]
            np.testing.assert_array_equal(got, want[rank],
                                          err_msg='%s rank %d'
                                          % (name, rank))
        ran += 1
    assert ran == len(NAMES) - 1
    # the case exercises what it is named for: a rank no pair sends to
    # receives zeros, a self pair its own input
    if case == 'partial':
        assert not want.any(axis=(1, 2)).all()
