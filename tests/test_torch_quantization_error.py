"""``precision.quantization_error`` against the JAX function on the same
trees (flax layouts, per-channel int8)."""

import jax
import numpy as np
import pytest
import torch

from chainermn_tpu import models as jmodels
from chainermn_tpu import precision as jprecision
from chainermn_tpu_torch import precision

torch.set_num_threads(2)


def _lm_tree():
    import jax.numpy as jnp
    jm = jmodels.TransformerLM(vocab_size=64, d_model=32, n_heads=4,
                               n_layers=2, d_ff=64, max_len=64,
                               dtype=jnp.float32)
    return jax.tree_util.tree_map(np.asarray, jax.device_get(jax.jit(
        jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
        ['params']))


def _trees():
    rs = np.random.RandomState(0)
    yield 'mixed', {'w': rs.randn(128, 64).astype(np.float32),
                    'conv': {'kernel': rs.randn(3, 3, 8, 16).astype(
                        np.float32) * 10.0},
                    'b': np.zeros((64,), np.float32),
                    'n': np.arange(4, dtype=np.int32)}
    yield 'lm', _lm_tree()
    yield 'nothing_quantized', {'b': np.ones((4,), np.float32)}


@pytest.mark.parametrize('name,tree', list(_trees()),
                         ids=lambda v: v if isinstance(v, str) else '')
def test_quantization_error_equals_jax(name, tree):
    got = precision.quantization_error(tree, precision.quantize_int8(tree))
    want = jprecision.quantization_error(tree, jprecision.quantize_int8(tree))
    if name == 'nothing_quantized':
        assert got == want == 0.0
        return
    assert 0 < got < 0.05
    assert got == pytest.approx(want, rel=1e-5)


def test_quantization_error_reads_tensors_and_the_worst_leaf():
    """Tensor leaves too; the result is the worst leaf's error (a leaf
    whose channels each hold one outlier and values half a step wide
    quantizes worse than a Gaussian one)."""
    rs = np.random.RandomState(1)
    bad = (0.2 + 0.01 * rs.randn(64, 32)).astype(np.float32)
    bad[0] = 50.8
    leaves = {'good': rs.randn(64, 32).astype(np.float32), 'bad': bad}
    alone = {k: precision.quantization_error(
        {k: v}, precision.quantize_int8({k: v})) for k, v in leaves.items()}
    assert alone['bad'] > alone['good']
    tree = {k: torch.from_numpy(v) for k, v in leaves.items()}
    err = precision.quantization_error(tree, precision.quantize_int8(tree))
    assert err == alone['bad']
    assert err == pytest.approx(jprecision.quantization_error(
        leaves, jprecision.quantize_int8(leaves)), rel=1e-5)
