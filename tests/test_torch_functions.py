"""The port's ``functions.send`` / ``recv`` / ``pseudo_connect`` against
the JAX functions of the same names: ``send`` and ``recv`` on a (2, 2)
mesh of 4 gloo processes against ``lax.ppermute`` on 4 virtual CPU
devices (global ranks, one axis at a time, a whole permutation, the
gradient arriving on the sender only), ``pseudo_connect`` in one
process in f16, f32 and f64.
"""

import os
import pickle
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
from chainermn_tpu import functions as jfunctions
from chainermn_tpu.communicators.mesh_utility import AXES
from chainermn_tpu_torch import functions
from chainermn_tpu_torch.functions.point_to_point_communication import (
    global_pairs)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
MESH = (2, 2)

# (name, how the JAX and torch sides call it) -- each case ships the
# rank's own value ``x = full(shape, rank)``
CASES = {
    'send_global': dict(fn='send', kw=dict(rank=3, src=1)),
    'send_intra': dict(fn='send', kw=dict(rank=1, src=0, axis='intra')),
    'send_inter': dict(fn='send', kw=dict(rank=0, src=1, axis='inter')),
    'send_perm': dict(fn='send',
                      kw=dict(perm=[(0, 1), (1, 2), (2, 3), (3, 0)])),
    'recv_global': dict(fn='recv', kw=dict(rank=2, dst=0)),
    'recv_intra': dict(fn='recv', kw=dict(rank=1, dst=0, axis='intra')),
}

_RANK_SCRIPT = r'''
import pickle
import sys
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import functions

torch.set_num_threads(1)
store, rank, world, cases, out = (sys.argv[1], int(sys.argv[2]),
                                  int(sys.argv[3]), sys.argv[4], sys.argv[5])
dist.init_process_group('gloo', store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
comm = cmt.create_communicator('xla', device='cpu', mesh_shape=(2, 2))
with open(cases, 'rb') as f:
    cases = pickle.load(f)
res = {}
for name, case in cases.items():
    x = torch.full((3,), float(rank))
    if case['fn'] == 'send':
        res[name] = functions.send(x, comm, **case['kw']).numpy()
    else:
        res[name] = functions.recv(comm, x=x, **case['kw']).numpy()
# the gradient of send(src=1 -> 3): only what rank 3 got counts, twice
x = torch.ones(2, requires_grad=True)
y = functions.send(x, comm, rank=3, src=1)
(y * float(rank == 3)).sum().mul(2.0).backward()
res['send_grad'] = x.grad.numpy()
# recv's gradient flows back the same way
x = torch.ones(2, requires_grad=True)
y = functions.recv(comm, rank=2, dst=0, x=x)
(y * float(rank == 0)).sum().mul(3.0).backward()
res['recv_grad'] = x.grad.numpy()
with open(out, 'wb') as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


def _jax_comm():
    return chainermn_tpu.create_communicator(
        'xla', mesh_shape=MESH, devices=jax.devices()[:WORLD])


def _jax_case(comm, case):
    def f():
        x = jnp.full((3,), comm.axis_rank(), jnp.float32)
        kw = dict(case['kw'])
        if 'axis' not in kw:
            kw['axis'] = AXES
        if case['fn'] == 'send':
            return jfunctions.send(x, comm, **kw)
        return jfunctions.recv(comm, x=x, **kw)

    y = jax.jit(jax.shard_map(f, mesh=comm.mesh, in_specs=(),
                              out_specs=P(AXES), check_vma=False))()
    return np.asarray(y).reshape(WORLD, 3)


def _jax_grad(comm, fn, pair, weight):
    src, dst = pair

    def f():
        def local(x):
            if fn == 'send':
                y = jfunctions.send(x, comm, rank=dst, src=src)
            else:
                y = jfunctions.recv(comm, rank=src, dst=dst, x=x)
            mask = (comm.axis_rank() == dst).astype(jnp.float32)
            return jnp.sum(y * mask) * weight

        return jax.grad(local)(jnp.ones((2,), jnp.float32))

    g = jax.jit(jax.shard_map(f, mesh=comm.mesh, in_specs=(),
                              out_specs=P(AXES), check_vma=False))()
    return np.asarray(g).reshape(WORLD, 2)


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('functions')
    with open(tmp / 'cases.pkl', 'wb') as f:
        pickle.dump(CASES, f)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK_SCRIPT, str(tmp / 'store'), str(r),
         str(WORLD), str(tmp / 'cases.pkl'), str(tmp / ('r%d.pkl' % r))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            assert p.returncode == 0, out.decode()
    finally:
        for p in procs:
            p.kill()
    out = []
    for r in range(WORLD):
        with open(tmp / ('r%d.pkl' % r), 'rb') as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize('name', sorted(CASES))
def test_send_recv_route_as_jax(ranks, name):
    want = _jax_case(_jax_comm(), CASES[name])
    got = np.stack([r[name] for r in ranks])
    np.testing.assert_array_equal(got, want)


def test_send_routes_global_ranks(ranks):
    """Global ranks on the (2, 2) mesh: 1 -> 3 crosses the rows."""
    got = np.stack([r['send_global'][0] for r in ranks])
    np.testing.assert_array_equal(got, [0.0, 0.0, 0.0, 1.0])


def test_send_gradient_arrives_on_the_sender_only(ranks):
    want = _jax_grad(_jax_comm(), 'send', (1, 3), 2.0)
    got = np.stack([r['send_grad'] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    expected = np.zeros((WORLD, 2))
    expected[1] = 2.0
    np.testing.assert_array_equal(got, expected)


def test_recv_mirrors_send(ranks):
    want = _jax_grad(_jax_comm(), 'recv', (2, 0), 3.0)
    got = np.stack([r['recv_grad'] for r in ranks])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(
        np.stack([r['recv_global'][0] for r in ranks]), [2.0, 0, 0, 0])


def test_global_pairs_validate():
    class Comm:
        inter_size, intra_size, size, rank = 2, 2, 4, 0

    assert global_pairs([(0, 1)], Comm(), 'intra') == [(0, 1), (2, 3)]
    assert global_pairs([(1, 0)], Comm(), 'inter') == [(2, 0), (3, 1)]
    with pytest.raises(ValueError):
        global_pairs([(0, 1), (2, 1)], Comm())
    with pytest.raises(ValueError):
        global_pairs([(0, 2)], Comm(), 'intra')
    with pytest.raises(ValueError):
        functions.send(torch.ones(1), rank=0)
    with pytest.raises(ValueError):
        functions.recv(rank=0, dst=0)


def test_send_to_self_in_a_world_of_one():
    """Without a process group a self-edge is a copy, and its gradient
    passes straight back."""
    x = torch.arange(4.0, requires_grad=True)
    y = functions.send(x, rank=0, src=0)
    np.testing.assert_array_equal(y.detach().numpy(), np.arange(4.0))
    (y * 3.0).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full(4, 3.0))


_TORCH = {jnp.float16: torch.float16, jnp.float32: torch.float32,
          jnp.float64: torch.float64}


@pytest.mark.parametrize('dtype', [jnp.float16, jnp.float32, jnp.float64])
def test_pseudo_connect_identity_and_grads(dtype):
    """Identity on the actuals, passthrough gradients, zeros for the
    delegate, as the JAX function gives them."""
    with jax.enable_x64(dtype == jnp.float64):
        delegate = jnp.ones((3,), dtype)
        a = jnp.arange(4.0, dtype=dtype)
        b = jnp.arange(6.0, dtype=dtype).reshape(2, 3)

        def loss(delegate, a, b):
            oa, ob = jfunctions.pseudo_connect(delegate, a, b)
            return jnp.sum(oa.astype(jnp.float32) ** 2) + jnp.sum(
                ob.astype(jnp.float32))

        jgrads = jax.grad(loss, argnums=(0, 1, 2))(delegate, a, b)
        jout = jfunctions.pseudo_connect(delegate, a, b)
    td = _TORCH[dtype]
    tdel = torch.ones(3, dtype=td, requires_grad=True)
    ta = torch.arange(4.0, dtype=td).requires_grad_()
    tb = torch.arange(6.0, dtype=td).reshape(2, 3).requires_grad_()
    oa, ob = functions.pseudo_connect(tdel, ta, tb)
    assert oa.dtype == td and ob.dtype == td
    for got, want in zip((oa, ob), jout):
        np.testing.assert_array_equal(got.detach().numpy(),
                                      np.asarray(want))
    (oa.float() ** 2).sum().add(ob.float().sum()).backward()
    for got, want in zip((tdel.grad, ta.grad, tb.grad), jgrads):
        assert got.dtype == td
        np.testing.assert_allclose(got.numpy().astype(np.float64),
                                   np.asarray(want).astype(np.float64),
                                   rtol=1e-3)
    np.testing.assert_array_equal(tdel.grad.numpy(), np.zeros(3))


def test_pseudo_connect_runs_the_delegates_backward():
    """The delegate's own backward runs (with a zero gradient) although
    the loss does not depend on it: what keeps a rank's sends in its
    backward."""
    seen = []
    w = torch.ones(3, requires_grad=True)
    d = w * 2.0
    d.register_hook(lambda g: seen.append(g.clone()))
    a = torch.arange(3.0, requires_grad=True)
    out = functions.pseudo_connect([d, {'k': d}], a)
    out.sum().backward()
    assert len(seen) == 1 and float(seen[0].abs().sum()) == 0.0
    np.testing.assert_array_equal(w.grad.numpy(), np.zeros(3))
    np.testing.assert_array_equal(a.grad.numpy(), np.ones(3))


def test_pseudo_connect_none_delegate():
    a = torch.ones(2)
    assert functions.pseudo_connect(None, a) is a
    b = torch.zeros(1)
    assert functions.pseudo_connect(None, a, b) == (a, b)
