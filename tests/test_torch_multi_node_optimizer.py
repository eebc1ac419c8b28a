"""The multi-node optimizer wrapper with a parameter that gets no
gradient on a step, against the JAX package.

``jax.grad`` gives every leaf a gradient -- zeros for a leaf the loss
does not use -- so the reference's optimizers keep stepping such a leaf
(momentum moves it on, Adam's moments decay).  In PyTorch its ``grad``
is ``None``; the wrapper gives it a zero gradient before the allreduce,
so the port steps it alike, and every rank reduces the same buffers.

Leaves ``a`` and ``b`` start at ``ones(3)``; step 1's loss is ``a.sum()
+ 2 b.sum()``, step 2's is ``a.sum()`` (``b`` unused).  ``FusedMomentumSGD``
is held against ``fused_momentum_sgd`` (the JAX kernels in the
``fallback`` and ``interpret`` modes) at the optimizer tests' rtol 1e-6;
``torch.optim.Adam`` against ``optax.adam`` at rtol 1e-5, atol 1e-4 (two
implementations of the same f32 formula, the square root and the
division rounding apart).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu_torch as cmt
from chainermn_tpu import ops as jops
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
LR, MU = 0.1, 0.9
SGD_TOL = dict(rtol=1e-6, atol=1e-6)
ADAM_TOL = dict(rtol=1e-5, atol=1e-4)
# d(loss)/d(a), d(loss)/d(b) of the two steps: b is unused in step 2
GRADS = [(1.0, 2.0), (1.0, 0.0)]


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


def _port(make_optimizer):
    """The two steps through the port's entry points, after the
    broadcast call; returns a and b after each step."""
    comm = cmt.create_communicator('xla', device='cpu')
    try:
        a = torch.nn.Parameter(torch.ones(3))
        b = torch.nn.Parameter(torch.ones(3))
        opt = cmt.create_multi_node_optimizer(make_optimizer([a, b]), comm)
        opt.step()                    # the broadcast, no step
        out = []
        for step in range(2):
            opt.zero_grad(set_to_none=True)
            loss = a.sum() + (2 * b.sum() if step == 0 else 0)
            loss.backward()
            assert (b.grad is None) == (step == 1)
            opt.step()
            out.append((a.detach().clone().numpy(),
                        b.detach().clone().numpy()))
        return out
    finally:
        comm.close()


def _reference(tx):
    """The same two steps through an optax transformation, with the
    zero gradient ``jax.grad`` gives the unused leaf."""
    params = {'a': jnp.ones(3), 'b': jnp.ones(3)}
    state = tx.init(params)
    out = []
    for ga, gb in GRADS:
        grads = {'a': jnp.full(3, ga), 'b': jnp.full(3, gb)}
        upd, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, upd)
        out.append((np.asarray(params['a']), np.asarray(params['b'])))
    return out


def test_unused_leaf_keeps_moving_under_momentum_sgd(mode):
    got = _port(lambda ps: ops.FusedMomentumSGD(ps, LR, MU))
    want = _reference(jops.fused_momentum_sgd(LR, MU))
    for (ga, gb), (wa, wb) in zip(got, want):
        np.testing.assert_allclose(ga, wa, **SGD_TOL)
        np.testing.assert_allclose(gb, wb, **SGD_TOL)
    # v = 2, then 0.9 * 2: b = 1 - 0.2 - 0.18 (it froze at 0.8 before)
    np.testing.assert_allclose(got[1][1], np.full(3, 0.62), **SGD_TOL)


def test_unused_leaf_keeps_moving_under_adam():
    got = _port(lambda ps: torch.optim.Adam(ps, lr=LR))
    want = _reference(optax.adam(LR))
    for (ga, gb), (wa, wb) in zip(got, want):
        np.testing.assert_allclose(ga, wa, **ADAM_TOL)
        np.testing.assert_allclose(gb, wb, **ADAM_TOL)
    # Adam's moments decay and still step b (it froze at 0.900 before)
    np.testing.assert_allclose(got[1][1], np.full(3, 0.8333), atol=1e-3)


def test_zero_gradient_takes_the_params_layout():
    comm = cmt.create_communicator('xla', device='cpu')
    try:
        w = torch.nn.Parameter(torch.ones(4, 3, 2, 2).to(
            memory_format=torch.channels_last))
        opt = cmt.create_multi_node_optimizer(
            ops.FusedMomentumSGD([w], LR, MU), comm)
        opt.step()
        opt.step()                    # w has no gradient: a zero one
        assert w.grad is not None and not w.grad.any()
        assert w.grad.stride() == w.stride()
        assert torch.equal(w.detach(), torch.ones(4, 3, 2, 2))
    finally:
        comm.close()


_RANK_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import ops

torch.set_num_threads(1)
store_path, rank, out_path, name, kind = sys.argv[1], int(sys.argv[2]), \
    sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group('gloo', store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
comm = cmt.create_communicator(name, device='cpu')
a = torch.nn.Parameter(torch.ones(3))
b = torch.nn.Parameter(torch.ones(3))
c = torch.nn.Parameter(torch.ones(2))   # unused on both ranks
actual = (ops.FusedMomentumSGD([a, b, c], 0.1, 0.9) if kind == 'sgd'
          else torch.optim.Adam([a, b, c], lr=0.1))
opt = cmt.create_multi_node_optimizer(actual, comm)
opt.step()
for step in range(2):
    opt.zero_grad(set_to_none=True)
    # b is unused on rank 1 only
    loss = a.sum() * (rank + 1) + (2 * b.sum() if rank == 0 else 0)
    loss.backward()
    opt.step()
np.savez(out_path, a=a.detach().numpy(), b=b.detach().numpy(),
         c=c.detach().numpy())
dist.destroy_process_group()
'''


@pytest.mark.parametrize('name,kind', [('xla', 'sgd'), ('flat', 'adam')])
def test_two_rank_gloo_with_a_leaf_unused_on_one_rank(tmp_path, name, kind):
    """Ranks whose sets of unused leaves differ reduce the same buffers:
    both finish, with equal parameters (mean gradients a 1.5, b 1)."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK_SCRIPT, str(tmp_path / 'store'),
         str(r), str(tmp_path / ('r%d.npz' % r)), name, kind], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)   # a hang fails here
            assert p.returncode == 0, out.decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    got = [np.load(tmp_path / ('r%d.npz' % r)) for r in range(2)]
    for key in ('a', 'b', 'c'):
        np.testing.assert_array_equal(got[0][key], got[1][key])
    if kind == 'sgd':
        # two steps of momentum SGD on the mean gradients
        for key, g in (('a', 1.5), ('b', 1.0)):
            np.testing.assert_allclose(got[0][key],
                                       np.full(3, 1 - 0.1 * g * (1 + 1.9)),
                                       rtol=1e-6)
    np.testing.assert_array_equal(got[0]['c'], np.ones(2, np.float32))
