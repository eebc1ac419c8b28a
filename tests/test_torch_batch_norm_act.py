"""The port's fused BN+act op (plain versions on the CPU) against the
JAX package's ``ops.batch_norm_act``, run as the JAX package's own tests
run it: the ``fallback`` (jnp) and ``interpret`` (Pallas kernels in the
interpreter) modes.

Tolerances are those of ``tests/test_batch_norm_act.py``: f32 1e-5 on
the forward and 1e-4 on the gradients (the backward sums in another
order), bf16 5e-2 (one bf16 rounding of the output may land on either
side), f16 1e-2 (the same for one f16 rounding, 2**-10 relative against
bf16's 2**-7).  Statistics are f32 over the same input values in both dtypes,
so they hold to 1e-5 throughout.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu.models._norm import NormAct as JaxNormAct
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops
from chainermn_tpu_torch.models import NormAct

torch.set_num_threads(2)

TOL = {'float32': dict(rtol=1e-5, atol=1e-5),
       'bfloat16': dict(rtol=5e-2, atol=5e-2),
       'float16': dict(rtol=1e-2, atol=1e-2)}
GRAD_TOL = {'float32': dict(rtol=1e-4, atol=1e-4),
            'bfloat16': dict(rtol=5e-2, atol=5e-2),
            'float16': dict(rtol=1e-2, atol=1e-2)}
STATS_TOL = dict(rtol=1e-5, atol=1e-5)
TDTYPE = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'float16': torch.float16}


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


def _inputs(shape, dtype, seed, residual):
    """numpy inputs (rounded to ``dtype``) for both frameworks."""
    rng = np.random.RandomState(seed)
    c = shape[-1]

    def act():
        a = rng.randn(*shape).astype(np.float32) * 2.0 + 0.5
        return np.array(jnp.asarray(a, dtype).astype(jnp.float32))

    x = act()
    res = act() if residual else None
    scale = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    cot = rng.randn(*shape).astype(np.float32)   # upstream gradient
    return x, res, scale, bias, cot


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


SHAPES = [(4, 6, 6, 16), (3, 10, 10, 8)]   # 144 rows; ragged 300 rows


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('relu', [True, False])
@pytest.mark.parametrize('shape', SHAPES)
def test_forward_and_grads_match_jax(mode, dtype, residual, relu, shape):
    x, res, scale, bias, cot = _inputs(shape, dtype, 0, residual)
    jdt = jnp.dtype(dtype)

    def jloss(x, scale, bias, res):
        out, mean, var = jops.batch_norm_act(x, scale, bias, residual=res,
                                             relu=relu)
        return jnp.sum(out.astype(jnp.float32) * cot), (out, mean, var)

    jargs = (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
             None if res is None else jnp.asarray(res, jdt))
    (_, (jout, jmean, jvar)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(*jargs)

    tdt = TDTYPE[dtype]
    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    tr = (None if res is None
          else torch.tensor(res, dtype=tdt, requires_grad=True))
    out, mean, var = ops.batch_norm_act(tx, ts, tb, residual=tr, relu=relu)
    assert out.dtype == tdt and mean.dtype == torch.float32
    (out.float() * torch.from_numpy(cot)).sum().backward()

    np.testing.assert_allclose(out.float().detach().numpy(), _f32(jout),
                               **TOL[dtype])
    np.testing.assert_allclose(mean.detach().numpy(), _f32(jmean),
                               **STATS_TOL)
    np.testing.assert_allclose(var.detach().numpy(), _f32(jvar),
                               **STATS_TOL)
    grads = (tx.grad, ts.grad, tb.grad, None if tr is None else tr.grad)
    for name, g, jg in zip(('x', 'scale', 'bias', 'residual'), grads,
                           jgrads):
        if jg is None:
            assert g is None and name == 'residual'
            continue
        np.testing.assert_allclose(g.float().numpy(), _f32(jg),
                                   err_msg='grad ' + name,
                                   **GRAD_TOL[dtype])


def test_reference_and_op_agree_with_jax_reference(mode):
    x, res, scale, bias, _ = _inputs((2, 5, 5, 8), 'float32', 1, True)
    out, mean, var = ops.batch_norm_act_reference(
        torch.from_numpy(x), torch.from_numpy(scale),
        torch.from_numpy(bias), residual=torch.from_numpy(res))
    jout, jmean, jvar = jops.batch_norm_act_reference(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
        residual=jnp.asarray(res))
    for a, b in ((out, jout), (mean, jmean), (var, jvar)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL['float32'])


def test_relu_mask_from_output_sign(mode):
    # the backward gates on the OUTPUT's sign; a shifted bias makes
    # both branches non-trivial
    rng = np.random.RandomState(11)
    x = rng.randn(8, 16).astype(np.float32)
    bias = np.full((16,), 0.3, np.float32)
    jg = jax.grad(lambda x: jops.batch_norm_act(
        x, jnp.ones((16,)), jnp.asarray(bias))[0].sum())(jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    ops.batch_norm_act(tx, torch.ones(16), torch.from_numpy(bias))[0] \
        .sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg),
                               **TOL['float32'])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
@pytest.mark.parametrize('residual', [False, True])
def test_inference_matches_jax(dtype, residual):
    x, res, scale, bias, _ = _inputs((4, 4, 8), dtype, 2, residual)
    rmean = np.linspace(-0.5, 0.5, 8).astype(np.float32)
    rvar = np.linspace(0.5, 2.0, 8).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jops.batch_norm_act_inference(
        jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(rmean), jnp.asarray(rvar),
        residual=None if res is None else jnp.asarray(res, jdt))
    tdt = TDTYPE[dtype]
    got = ops.batch_norm_act_inference(
        torch.tensor(x, dtype=tdt), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(rmean),
        torch.from_numpy(rvar),
        residual=None if res is None else torch.tensor(res, dtype=tdt))
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), _f32(want), **TOL[dtype])


@pytest.mark.parametrize('fused', [True, False])
def test_norm_act_running_average_matches_jax(mode, fused):
    rng = np.random.RandomState(13)
    x = rng.randn(8, 6, 8).astype(np.float32) * 3.0 + 1.0
    init = {'params': {'scale': rng.rand(8).astype(np.float32) + 0.5,
                       'bias': rng.randn(8).astype(np.float32)},
            'batch_stats': {'mean': rng.randn(8).astype(np.float32),
                            'var': rng.rand(8).astype(np.float32) + 0.5}}
    jmod = (JaxNormAct(use_running_average=False, momentum=0.9) if fused
            else fnn.BatchNorm(use_running_average=False, momentum=0.9))
    jout, upd = jmod.apply(init, jnp.asarray(x), mutable=['batch_stats'])
    if not fused:
        jout = jax.nn.relu(jout)
    mod = NormAct(8, fused=fused)
    with torch.no_grad():
        for k, v in init['params'].items():
            getattr(mod, k).copy_(torch.from_numpy(v))
        for k, v in init['batch_stats'].items():
            getattr(mod, k).copy_(torch.from_numpy(v))
    out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               **TOL['float32'])
    for k in ('mean', 'var'):
        np.testing.assert_allclose(getattr(mod, k).numpy(),
                                   np.ravel(upd['batch_stats'][k]),
                                   err_msg=k, **TOL['float32'])
    # eval mode reads the running statistics
    mod.eval()
    jeval = jmod.clone(use_running_average=True).apply(
        {'params': init['params'], 'batch_stats': upd['batch_stats']},
        jnp.asarray(x))
    if not fused:
        jeval = jax.nn.relu(jeval)
    np.testing.assert_allclose(mod(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jeval), **TOL['float32'])


def test_kernel_wrappers_take_cuda_tensors_only():
    x = torch.zeros(4, 8)
    v = torch.zeros(8)
    with pytest.raises(ValueError, match='CUDA'):
        ops.bn_stats(x, 1e-5)
    with pytest.raises(ValueError, match='CUDA'):
        ops.bn_apply(x, None, v, v, v, v, True)
    before = ops.launch_counts()
    ops.batch_norm_act(x, torch.ones(8), v)   # CPU: the plain version
    assert ops.launch_counts() == before


def test_non_contiguous_input_raises():
    x = torch.zeros(4, 8).t()   # (8, 4) with C not contiguous
    with pytest.raises(ValueError, match='contiguous'):
        ops.batch_norm_act(x, torch.ones(4), torch.zeros(4))
