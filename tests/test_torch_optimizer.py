"""The port's fused momentum SGD (plain version on the CPU) against the
JAX package's ``ops.momentum_sgd`` and ``ops.fused_momentum_sgd``, in the
``fallback`` and ``interpret`` modes, over 3 steps.

f32 at rtol 1e-6: the update is the same two products and two sums in
the same order on both sides, so only the last bit may differ.  The
absolute floor, 1e-6, is a few ulps of the O(1) operands: where ``p +
delta`` nearly cancels, one ulp of ``p`` is a large relative error of
the small result (XLA may contract ``mu * v + g`` into an FMA in
interpret mode).
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops

torch.set_num_threads(2)

LR, MU, STEPS = 0.05, 0.9, 3
TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = [(3, 5, 5, 7), (129,), (16, 10)]


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


def _trees(seed=0):
    rng = np.random.RandomState(seed)
    params = [rng.randn(*s).astype(np.float32) for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) for s in SHAPES]
             for _ in range(STEPS)]
    return params, grads


def test_momentum_sgd_matches_jax(mode):
    params, grads = _trees()
    jp = [jnp.asarray(p) for p in params]
    jv = [jnp.zeros_like(p) for p in jp]
    tp = [torch.from_numpy(p.copy()) for p in params]
    tv = [torch.zeros_like(p) for p in tp]
    for step in range(STEPS):
        jp, jv = jops.momentum_sgd(jp, [jnp.asarray(g) for g in grads[step]],
                                   jv, LR, MU)
        out_p, out_v = ops.momentum_sgd(
            tp, [torch.from_numpy(g) for g in grads[step]], tv, LR, MU)
        assert out_p is tp and out_v is tv   # in place
        for a, b in zip(tp + tv, list(jp) + list(jv)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_fused_optimizer_matches_jax(mode):
    params, grads = _trees(1)
    tx = jops.fused_momentum_sgd(LR, MU)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    opt = ops.FusedMomentumSGD(tp, LR, MU)
    for step in range(STEPS):
        upd, state = tx.update([jnp.asarray(g) for g in grads[step]],
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, g in zip(tp, grads[step]):
            p.grad = torch.from_numpy(g)
        opt.step()
        for p, want in zip(tp, jp):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want),
                                       **TOL)
        for p, want in zip(tp, state['velocity']):
            np.testing.assert_allclose(opt.state[p]['velocity'].numpy(),
                                       np.asarray(want), **TOL)


def test_velocity_stays_f32_under_bf16_grads(mode):
    rng = np.random.RandomState(2)
    p0 = rng.randn(40).astype(np.float32)
    gs = [np.asarray(jnp.asarray(rng.randn(40), jnp.bfloat16)
                     .astype(jnp.float32)) for _ in range(STEPS)]
    jp, jv = [jnp.asarray(p0)], [jnp.zeros(40, jnp.float32)]
    tp = [torch.from_numpy(p0.copy())]
    tv = [torch.zeros(40)]
    for g in gs:
        jp, jv = jops.momentum_sgd(jp, [jnp.asarray(g, jnp.bfloat16)], jv,
                                   LR, MU)
        ops.momentum_sgd(tp, [torch.tensor(g, dtype=torch.bfloat16)], tv,
                         LR, MU)
    assert tv[0].dtype == torch.float32 and jv[0].dtype == jnp.float32
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(jv[0]), **TOL)
    # the step rounds through bf16 (g's dtype) before the f32 add
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]), **TOL)


def test_optimizer_skips_params_without_grad_and_keeps_state_f32():
    a = torch.nn.Parameter(torch.ones(3, dtype=torch.bfloat16))
    b = torch.nn.Parameter(torch.ones(3))
    opt = ops.FusedMomentumSGD([a, b], 0.1)
    a.grad = torch.ones(3, dtype=torch.bfloat16)
    opt.step()
    assert b not in opt.state and torch.equal(b.detach(), torch.ones(3))
    assert opt.state[a]['velocity'].dtype == torch.float32
    assert a.dtype == torch.bfloat16
    np.testing.assert_allclose(a.detach().float().numpy(),
                               np.full(3, 0.8984375))   # bf16(1 - 0.1)


def test_sgd_kernel_wrapper_takes_cuda_tensors_only():
    p = torch.zeros(8)
    with pytest.raises(ValueError, match='CUDA'):
        ops.sgd_update(p, torch.zeros(8), torch.zeros(8), 0.1, 0.9)
    with pytest.raises(ValueError):
        ops.FusedMomentumSGD([torch.nn.Parameter(p)], lr=-1.0)


@pytest.mark.parametrize('lr', [0.0, 1e-3])
def test_jax_update_tree_layout(lr):
    # the JAX optimizer state carries 'velocity', the port's too
    tx = jops.fused_momentum_sgd(lr, MU)
    state = tx.init({'w': jnp.zeros(3)})
    assert set(state) == {'velocity'}
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.ones(3)
    opt = ops.FusedMomentumSGD([p], lr, MU)
    opt.step()
    assert set(opt.state[p]) == {'velocity'}
    np.testing.assert_allclose(
        p.detach().numpy(),
        np.asarray(optax.apply_updates(
            {'w': jnp.zeros(3)},
            tx.update({'w': jnp.ones(3)}, state)[0])['w']), **TOL)
