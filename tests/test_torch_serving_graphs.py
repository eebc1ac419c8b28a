"""One CUDA graph per bucket, on the card: the ``InferenceEngine``
captures every bucket of an MLP and of a small ResNet with the fused norm
(whose inference BatchNorm launches ``bn_apply`` inside the graph), each
replay is bit-equal to an eager forward of the same engine, a hot swap
copies into the captured storage without a new capture, and a replay
counts no launch.  This file imports no JAX, so that it collects on a
machine without it; on the CPU its tests skip.
"""

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import models, ops, precision
from chainermn_tpu_torch.serving import InferenceEngine
from chainermn_tpu_torch.serving.engine import module_state


@pytest.fixture
def cuda():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card with '
                    '`python -m pytest -m cuda tests/test_torch_*.py`')


def _x(n, shape, seed):
    return np.random.RandomState(seed).rand(n, *shape).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('policy', ['bf16', 'int8'])
def test_mlp_graph_per_bucket_replays_bit_equal_to_eager(cuda, policy):
    tm = models.MLP(n_units=64, n_in=48)
    pol = (precision.Policy.bf16() if policy == 'bf16'
           else precision.Int8Policy.bf16())
    eng = InferenceEngine.for_model(tm, None, np.zeros((48,), np.float32),
                                    max_batch=8, policy=pol)
    aot = eng.warmup()
    assert sorted(aot) == [1, 2, 4, 8] and all(aot.values())
    assert eng.compile_count == 4
    for bucket in eng.edges:
        x = _x(bucket, (48,), bucket)
        assert torch.equal(eng.infer(x), eng.eager(x))
    eng.swap_params(module_state(tm))
    assert eng.compile_count == 4


@pytest.mark.cuda
def test_resnet_graphs_launch_bn_apply_and_replays_count_nothing(cuda):
    tm = models.ResNet(stage_sizes=[1, 1], width=8, num_classes=10,
                       fused_norm=True).eval()
    eng = InferenceEngine.for_model(tm, None,
                                    np.zeros((32, 32, 3), np.float32),
                                    max_batch=4,
                                    policy=precision.Policy.bf16())
    eng.warmup()
    n_norms = sum(isinstance(m, models.NormAct) for m in tm.modules())
    assert eng.graph_launches == {b: {'bn_apply': n_norms}
                                  for b in (1, 2, 4)}
    before = ops.bn_apply.launches
    for bucket in eng.edges:
        x = _x(bucket, (32, 32, 3), bucket)
        got = eng.infer(x)
        assert ops.bn_apply.launches == before
        assert torch.equal(got, eng.eager(x))
        before = ops.bn_apply.launches
