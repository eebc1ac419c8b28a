"""The port's VGG-16, Alex and NIN against the JAX package's models,
from the same flax weights (``tests/zoo_parity.py`` holds the set-up):
at a small input size and 10 classes, the eval-mode logits (f32, rtol
1e-5 of the largest logit; bf16 5e-2), every gradient of the
cross-entropy (rtol 1e-4, both models in float64) and the exact flax
round trip; at 1000 classes and the canonical size, the parameter count
of every zoo model equals the flax tree's.  Also ``get_arch``, and
dropout: it keeps ``1 - rate``, scales by ``1 / (1 - rate)``, draws the
same mask from the same seed, and the updater seeds it per rank and
iteration.
"""

import jax
import numpy as np
import pytest
import torch

import zoo_parity
from chainermn_tpu_torch import models, training

torch.set_num_threads(2)

# (architecture, small input size, batch)
ARCHS = [('vgg16', 32, 2), ('alex', 96, 2), ('nin', 96, 2)]
CANONICAL = {'vgg16': 224, 'alex': 227, 'nin': 227, 'googlenet': 224,
             'googlenetbn': 224}
# VGG-16's 138 M parameters at 1000 classes, for the record
VGG16_PARAMS = 138357544


@pytest.mark.parametrize('name,insize,batch', ARCHS)
def test_eval_logits_and_gradients_match_jax(name, insize, batch):
    zoo_parity.check_eval(name, insize, batch)


def test_bf16_eval_logits_match_jax():
    jmodel, v, x, _, model = zoo_parity.setup('vgg16', 32, 2,
                                              dtype='bfloat16')
    model.eval()
    want = np.asarray(jax.jit(lambda: jmodel.apply(v, x, train=False))())
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **zoo_parity.tol(want, 5e-2))


@pytest.mark.parametrize('name', sorted(CANONICAL))
def test_parameter_count_matches_flax(name):
    n = zoo_parity.check_count(name, CANONICAL[name])
    if name == 'vgg16':
        assert n == VGG16_PARAMS


def test_get_arch_raises_only_for_s2d():
    # resnet50_s2d is ported: only an unknown name raises
    with torch.device('meta'):
        assert models.get_arch('resnet50_s2d', device='meta').insize == 224
    with pytest.raises(ValueError):
        models.get_arch('resnet18', device='cpu')
    for name in CANONICAL:
        with torch.device('meta'):
            assert models.get_arch(name, device='meta').insize == \
                CANONICAL[name]
    for name in ('alex', 'nin'):
        with pytest.raises(ValueError, match='68x68'):
            models.get_arch(name, num_classes=10, device='cpu',
                            insize=96)(torch.zeros(1, 64, 64, 3))


def test_dropout_rate_scale_and_seed():
    drop = models.Dropout(0.3)
    x = torch.ones(200000)
    drop.generator = torch.Generator().manual_seed(7)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / 0.7, rtol=1e-6)
    drop.generator = torch.Generator().manual_seed(7)
    assert torch.equal(drop(x), y)
    drop.generator = torch.Generator().manual_seed(8)
    assert not torch.equal(drop(x), y)
    drop.eval()
    assert drop(x) is x


class _Comm:
    size = 1

    def __init__(self, rank):
        self.rank = rank

    def allreduce(self, x, op='mean'):
        return x


def _masks(seed, rank=0):
    """The dropout masks of 3 updates of a one-layer net."""
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(64))
            self.drop = models.Dropout(0.5)

        def forward(self, x):
            return self.drop(x * self.w)

    net = Net()
    seen = []

    def loss_fn(x):
        y = net(x)
        seen.append(y.detach() != 0)
        return y.sum(), {}

    opt = torch.optim.SGD(net.parameters(), lr=0.0)
    up = training.StandardUpdater(iter([]), opt, loss_fn, net, _Comm(rank),
                                  rng=seed)
    assert net.drop.generator is up.dropout_generator
    for _ in range(3):
        up.update_core((torch.ones(64),))
    return seen


def test_updater_seeds_dropout_per_rank_and_iteration():
    """The updater owns the generator its model's dropout layers draw
    from and reseeds it from (seed, iteration, rank) before each step:
    the same seed gives the same masks; another seed, another iteration
    or another rank gives others."""
    a, b = _masks(0), _masks(0)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], _masks(1)[0])
    assert not torch.equal(a[0], _masks(0, rank=1)[0])
