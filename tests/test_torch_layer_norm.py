"""The port's LayerNorm (plain version on the CPU) and its backward
against the JAX package's ``ops.layer_norm`` and ``jax.grad`` of it, run
as the JAX package's own tests run it: the ``fallback`` (jnp) and
``interpret`` (the Pallas kernel in the interpreter) modes.

Tolerances: f32 rtol/atol 1e-5 (f32 statistics summed in another
order; 1e-4 for the gradients, which sum over every row), bf16 5e-2
(one bf16 rounding of the output may land on either side).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops

torch.set_num_threads(2)

TOL = {'float32': dict(rtol=1e-5, atol=1e-5),
       'bfloat16': dict(rtol=5e-2, atol=5e-2)}
TDTYPE = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


def _rounded(a, dtype):
    """numpy f32 values exactly representable in ``dtype``."""
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


def _inputs(shape, dtype, g_dtype, seed):
    rng = np.random.RandomState(seed)
    d = shape[-1]
    x = _rounded(rng.randn(*shape).astype(np.float32) * 3.0 + 1.0, dtype)
    g = _rounded(rng.randn(d).astype(np.float32) * 0.5 + 1.0, g_dtype)
    b = _rounded(rng.randn(d).astype(np.float32), g_dtype)
    return x, g, b


# (N, D) rows: ragged row counts (no padding to 8 in the port), the
# decode row count and one row (the prefill's final norm)
SHAPES = [(5, 32), (1, 64), (3, 7, 48), (32, 128)]


@pytest.mark.parametrize('dtype,g_dtype', [('float32', 'float32'),
                                           ('bfloat16', 'float32'),
                                           ('bfloat16', 'bfloat16')])
@pytest.mark.parametrize('shape', SHAPES)
def test_layer_norm_matches_jax(mode, shape, dtype, g_dtype):
    x, g, b = _inputs(shape, dtype, g_dtype, 0)
    want = jops.layer_norm(jnp.asarray(x, dtype), jnp.asarray(g, g_dtype),
                           jnp.asarray(b, g_dtype))
    got = ops.layer_norm(torch.tensor(x, dtype=TDTYPE[dtype]),
                         torch.tensor(g, dtype=TDTYPE[g_dtype]),
                         torch.tensor(b, dtype=TDTYPE[g_dtype]))
    assert got.dtype == TDTYPE[dtype] and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


def test_reference_matches_jax_reference():
    x, g, b = _inputs((6, 40), 'float32', 'float32', 1)
    want = jops.layer_norm_reference(jnp.asarray(x), jnp.asarray(g),
                                     jnp.asarray(b))
    got = ops.layer_norm_reference(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])


def test_eps_is_the_jax_packages():
    # a near-constant row: the variance is below 1e-5, so eps decides
    x = np.full((2, 16), 3.0, np.float32)
    x[:, 0] += 1e-3
    g, b = np.ones(16, np.float32), np.zeros(16, np.float32)
    want = jops.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    got = ops.layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                         torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    eps5 = torch.nn.functional.layer_norm(torch.from_numpy(x), (16,),
                                          eps=1e-5)
    assert not np.allclose(eps5.numpy(), np.asarray(want), atol=1e-2)


GRAD_TOL = {'float32': dict(rtol=1e-4, atol=1e-4),
            'bfloat16': dict(rtol=5e-2, atol=5e-2)}


# the transformer's two cases: an f32 stream, and a bf16 stream under
# f32 gamma / beta (dx in x.dtype, dgamma and dbeta in gamma.dtype)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('shape', SHAPES)
def test_gradients_match_jax(mode, shape, dtype):
    x, g, b = _inputs(shape, dtype, 'float32', 2)
    w = np.random.RandomState(3).randn(*shape).astype(np.float32)

    def jloss(jx, jg, jb):
        return jnp.sum(jops.layer_norm(jx, jg, jb).astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x, dtype), jnp.asarray(g), jnp.asarray(b))
    leaves = [torch.tensor(x, dtype=TDTYPE[dtype], requires_grad=True),
              torch.tensor(g, requires_grad=True),
              torch.tensor(b, requires_grad=True)]
    (ops.layer_norm(*leaves).float() * torch.from_numpy(w)).sum().backward()
    for name, leaf, jgrad in zip(('dx', 'dgamma', 'dbeta'), leaves, want):
        assert leaf.grad.dtype == leaf.dtype, name
        assert leaf.grad.shape == leaf.shape, name
        # dgamma and dbeta are f32 sums over the same rows on both sides
        np.testing.assert_allclose(
            leaf.grad.float().numpy(),
            np.asarray(jgrad.astype(jnp.float32)), err_msg=name,
            **GRAD_TOL[dtype if name == 'dx' else 'float32'])


def test_gradients_match_torch_layer_norm():
    x, g, b = _inputs((3, 7, 48), 'float32', 'float32', 4)
    w = torch.from_numpy(np.random.RandomState(5).randn(3, 7, 48)
                         .astype(np.float32))
    grads = []
    for fn in (lambda a, c, d: ops.layer_norm(a, c, d),
               lambda a, c, d: torch.nn.functional.layer_norm(
                   a, (48,), c, d, 1e-6)):
        leaves = [torch.tensor(v, requires_grad=True) for v in (x, g, b)]
        grads.append(torch.autograd.grad((fn(*leaves) * w).sum(), leaves))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, **GRAD_TOL['float32'])


def test_kernel_wrapper_takes_cuda_tensors_only():
    with pytest.raises(ValueError, match='CUDA'):
        ops.ln_forward(torch.zeros(4, 8), torch.ones(8), torch.zeros(8))
    before = ops.launch_counts()
    ops.layer_norm(torch.zeros(4, 8), torch.ones(8), torch.zeros(8))
    assert ops.launch_counts() == before     # CPU: the plain version


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(cuda):
    gen = torch.Generator().manual_seed(0)
    f32, bf16 = torch.float32, torch.bfloat16
    # the last case is the training path's: bf16 rows, f32 parameters
    for n, dtype, g_dtype, tol in ((100, f32, f32, 2e-5),
                                   (32, bf16, bf16, 2e-2),
                                   (300, bf16, f32, 2e-2)):
        x = torch.randn((n, 512), generator=gen).to(dtype)
        g = torch.randn(512, generator=gen).to(g_dtype)
        b = torch.randn(512, generator=gen).to(g_dtype)
        want = ops.layer_norm_reference(x, g, b)
        got = ops.layer_norm(x.cuda(), g.cuda(), b.cuda()).cpu()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card with '
                    '`python -m pytest -m cuda tests/test_torch_*.py`')
