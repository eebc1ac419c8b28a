"""The port's fused softmax cross-entropy (plain version on the CPU)
against the JAX package's ``ops.softmax_cross_entropy`` and its internal
``_ce_fwd`` (for ``lse``), run as the JAX package's own tests run them:
the ``fallback`` (jnp) and ``interpret`` (the Pallas kernel in the
interpreter) modes.

Tolerances: f32 rtol/atol 1e-5 (the same max / sum-of-exponentials, sums
in another order), bf16 5e-2 (the gradient is rounded to bf16 once, on
either side of a boundary).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops

# the modules (each package re-exports a function of the same name)
jce = importlib.import_module('chainermn_tpu.ops.cross_entropy')
ce = importlib.import_module('chainermn_tpu_torch.ops.cross_entropy')

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


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card with '
                    '`python -m pytest -m cuda tests/test_torch_*.py`')


def _inputs(b, v, dtype, seed):
    """Logits exactly representable in ``dtype`` and in-range labels."""
    rng = np.random.RandomState(seed)
    logits = np.array(jnp.asarray(rng.randn(b, v).astype(np.float32) * 3.0,
                                  dtype).astype(jnp.float32))
    labels = rng.randint(0, v, b).astype(np.int32)
    return logits, labels


# B = 5 and 13 are ragged against the JAX kernel's blocks of 8 rows (its
# wrapper pads; the port takes any B)
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b', [5, 8, 13])
def test_loss_and_lse_match_jax(mode, b, dtype):
    logits, labels = _inputs(b, 50, dtype, b)
    jl, jy = jnp.asarray(logits, dtype), jnp.asarray(labels)
    want = jops.softmax_cross_entropy(jl, jy)
    _, (_, _, jlse) = jce._ce_fwd(jl, jy)
    tl = torch.tensor(logits, dtype=TDTYPE[dtype])
    ty = torch.from_numpy(labels)
    got = ops.softmax_cross_entropy(tl, ty)
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **TOL['float32'])
    loss, lse = ce._ce_forward_plain(tl, ty)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse),
                               **TOL['float32'])
    np.testing.assert_allclose(loss.numpy(), got.numpy(), rtol=0, atol=0)
    np.testing.assert_allclose(
        ops.softmax_cross_entropy_reference(tl, ty).numpy(),
        np.asarray(jops.softmax_cross_entropy_reference(jl, jy)),
        **TOL['float32'])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('b', [5, 8, 13])
def test_dlogits_match_jax_grad(mode, b, dtype):
    logits, labels = _inputs(b, 50, dtype, 20 + b)
    weights = np.random.RandomState(b).randn(b).astype(np.float32)
    jy, jw = jnp.asarray(labels), jnp.asarray(weights)
    want = jax.grad(lambda x: jnp.sum(
        jops.softmax_cross_entropy(x, jy) * jw))(jnp.asarray(logits, dtype))
    tl = torch.tensor(logits, dtype=TDTYPE[dtype], requires_grad=True)
    (ops.softmax_cross_entropy(tl, torch.from_numpy(labels))
     * torch.from_numpy(weights)).sum().backward()
    assert tl.grad.dtype == TDTYPE[dtype] and tl.grad.shape == (b, 50)
    np.testing.assert_allclose(
        tl.grad.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **TOL[dtype])


def test_minus_one_labels_pick_nothing(monkeypatch):
    """A label outside [0, V) picks nothing: ``loss = lse``, as the JAX
    kernel's one-hot sum gives (interpret mode; the jnp fallback's
    ``take_along_axis`` wraps a -1 around instead), and the row's
    gradient is the plain softmax times ``g``, as ``jax.nn.one_hot``
    gives in both modes."""
    monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    logits, labels = _inputs(8, 33, 'float32', 3)
    labels[[1, 4]] = -1
    labels[6] = 33
    jl, jy = jnp.asarray(logits), jnp.asarray(labels)
    want = jops.softmax_cross_entropy(jl, jy)
    _, (_, _, jlse) = jce._ce_fwd(jl, jy)
    tl = torch.tensor(logits, requires_grad=True)
    ty = torch.from_numpy(labels)
    got = ops.softmax_cross_entropy(tl, ty)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **TOL['float32'])
    for row in (1, 4, 6):
        assert float(got[row].detach()) == pytest.approx(float(jlse[row]),
                                                         rel=1e-6)
    weights = np.random.RandomState(4).randn(8).astype(np.float32)
    jgrad = jax.grad(lambda x: jnp.sum(
        jops.softmax_cross_entropy(x, jy) * jnp.asarray(weights)))(jl)
    (got * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(jgrad),
                               **TOL['float32'])
    np.testing.assert_allclose(
        tl.grad[1].numpy(),
        weights[1] * torch.softmax(tl.detach()[1], 0).numpy(),
        **TOL['float32'])


def test_labels_of_any_integer_type():
    logits, labels = _inputs(6, 20, 'float32', 5)
    tl = torch.from_numpy(logits)
    want = ops.softmax_cross_entropy(tl, torch.from_numpy(labels))
    for dtype in (torch.int64, torch.int16, torch.uint8):
        got = ops.softmax_cross_entropy(tl,
                                        torch.from_numpy(labels).to(dtype))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0)


def test_shapes_are_checked():
    with pytest.raises(ValueError, match=r'\(B, V\)'):
        ops.softmax_cross_entropy(torch.zeros(2, 3, 4),
                                  torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match=r'\(B,\)'):
        ops.softmax_cross_entropy(torch.zeros(2, 4),
                                  torch.zeros(3, dtype=torch.int32))


def test_kernel_wrapper_takes_cuda_tensors_only():
    logits, labels = _inputs(4, 8, 'float32', 6)
    with pytest.raises(ValueError, match='CUDA'):
        ops.ce_forward(torch.from_numpy(logits), torch.from_numpy(labels))
    before = ops.launch_counts()
    ops.softmax_cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels))
    assert ops.launch_counts() == before     # CPU: the plain version
    assert 'cross_entropy' in before


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card(cuda):
    for (b, v), dtype in (((13, 1000), 'bfloat16'), ((64, 32000), 'float32')):
        logits, labels = _inputs(b, v, dtype, 7)
        labels[0] = -1
        tl = torch.tensor(logits, dtype=TDTYPE[dtype])
        ty = torch.from_numpy(labels)
        want, wlse = ce._ce_forward_plain(tl, ty)
        got, lse = ops.ce_forward(tl.cuda(), ty.cuda())
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(lse.cpu(), wlse, rtol=1e-5, atol=1e-5)
    assert ce.ce_forward.launches > 0
