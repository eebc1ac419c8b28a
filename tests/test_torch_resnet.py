"""The port's ResNet against the JAX package's, from the same flax
weights (carried over by ``load_flax_variables``) and the same batch.

A narrow ``ResNet(stage_sizes=[1, 1], width=8, num_classes=10)`` at
batch 4: train-mode logits, the new ``batch_stats``, the loss and every
parameter gradient, then eval-mode logits.  32 px runs flax's asymmetric
``SAME`` padding on every strided layer (stem (2, 3), max pool and
stride-2 3x3 (0, 1)); 33 px runs the symmetric odd-size case.

Tolerance f32 1e-4: the convolutions sum in another order than XLA's,
and the error passes through every layer.  bf16 5e-2: the activations
round to bf16 at other places in the two frameworks.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from chainermn_tpu.models.resnet50 import ResNet as JaxResNet
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import models
from chainermn_tpu_torch.models.resnet50 import same_pads

torch.set_num_threads(2)

TOL = {'float32': dict(rtol=1e-4, atol=1e-4),
       'bfloat16': dict(rtol=5e-2, atol=5e-2)}
TDTYPE = {'float32': torch.float32, 'bfloat16': torch.bfloat16}
KW = dict(stage_sizes=[1, 1], width=8, num_classes=10)


def _variables(jmodel, size, seed):
    """flax init, with random BatchNorm affines and running statistics
    so that every branch (incl. the zero-init BatchNorm_2) carries
    signal."""
    v = jax.device_get(jmodel.init({'params': jax.random.PRNGKey(seed)},
                                   jnp.zeros((1, size, size, 3)),
                                   train=False))
    rng = np.random.RandomState(seed)

    def perturb(tree):
        out = {}
        for k, x in tree.items():
            if isinstance(x, dict):
                out[k] = perturb(x)
            elif k == 'scale':
                out[k] = (1.0 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
            elif k in ('bias', 'mean'):
                out[k] = (0.1 * rng.randn(*x.shape)).astype(np.float32)
            elif k == 'var':
                out[k] = (1.0 + 0.2 * rng.rand(*x.shape)).astype(np.float32)
            else:
                out[k] = np.array(x)
        return out

    return {'params': perturb(v['params']),
            'batch_stats': perturb(v['batch_stats'])}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v, np.float32)


def _assert_trees(got, want, tol, what):
    got, want = dict(_flat(got)), dict(_flat(want))
    assert sorted(got) == sorted(want), what
    for k in want:
        np.testing.assert_allclose(np.ravel(got[k]), np.ravel(want[k]),
                                   err_msg='%s %s' % (what, k), **tol)


CASES = [
    # fused, size, dtype, JAX kernel mode
    (False, 32, 'float32', 'fallback'),
    (True, 32, 'float32', 'fallback'),
    (True, 32, 'float32', 'interpret'),
    (False, 33, 'float32', 'fallback'),
    (True, 33, 'float32', 'fallback'),
    (True, 32, 'bfloat16', 'fallback'),
]


@pytest.mark.parametrize('fused,size,dtype,mode', CASES)
def test_resnet_matches_jax(monkeypatch, fused, size, dtype, mode):
    if mode == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == mode
    jmodel = JaxResNet(dtype=jnp.dtype(dtype), fused_norm=fused, **KW)
    variables = _variables(jmodel, size, seed=size)
    rng = np.random.RandomState(1)
    x = rng.randn(4, size, size, 3).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)

    def jloss(params):
        logits, upd = jmodel.apply(
            {'params': params, 'batch_stats': variables['batch_stats']},
            jnp.asarray(x), train=True, mutable=['batch_stats'])
        loss = optax.softmax_cross_entropy_with_integer_labels(
            logits, jnp.asarray(y)).mean()
        return loss, (logits, upd['batch_stats'])

    (jl, (jlogits, jstats)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(variables['params'])
    jeval = jax.jit(lambda v: jmodel.apply(v, jnp.asarray(x), train=False))(
        variables)

    model = models.ResNet(dtype=TDTYPE[dtype], fused_norm=fused,
                          device='cpu', **KW)
    models.load_flax_variables(model, variables)
    clf = models.StatefulClassifier(model)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    logits = model(xt)
    loss, _ = clf.loss(xt, yt)   # a second forward: stats move twice
    tol = TOL[dtype]
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               **tol)
    np.testing.assert_allclose(loss.item(), float(jl), **tol)
    loss.backward()
    grads = {k: p.grad.clone() for k, p in model.named_parameters()}
    # the stats after ONE train forward: reload and run it once
    models.load_flax_variables(model, variables)
    model.train()
    model(xt)
    _assert_trees(models.to_flax_variables(model)['batch_stats'],
                  jax.device_get(jstats), tol, 'batch_stats')
    grad_model = copy.deepcopy(model)
    with torch.no_grad():
        for k, p in grad_model.named_parameters():
            p.copy_(grads[k])
    _assert_trees(models.to_flax_variables(grad_model)['params'],
                  jax.device_get(jgrads), tol, 'grad')
    # eval mode reads the running statistics
    models.load_flax_variables(model, variables)
    got = models.StatefulClassifier(model).eval_metrics(xt, yt)
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(xt).numpy(), np.asarray(jeval),
                                   **tol)
    want_ce = optax.softmax_cross_entropy_with_integer_labels(
        jeval, jnp.asarray(y))
    np.testing.assert_allclose(got['loss'].numpy(), np.asarray(want_ce),
                               **tol)


def test_weight_carrier_round_trips():
    jmodel = JaxResNet(dtype=jnp.float32, **KW)
    variables = _variables(jmodel, 32, seed=5)
    model = models.ResNet(dtype=torch.float32, device='cpu', **KW)
    models.load_flax_variables(model, variables)
    _assert_trees(models.to_flax_variables(model), variables,
                  dict(rtol=0, atol=0), 'round trip')
    conv = model.Bottleneck_0.Conv_1.weight
    assert conv.is_contiguous(memory_format=torch.channels_last)
    bad = copy.deepcopy(variables)
    del bad['params']['fc']
    with pytest.raises(KeyError, match='fc'):
        models.load_flax_variables(model, bad)


def test_port_init_matches_flax_layout_and_zero_init():
    jmodel = JaxResNet(dtype=jnp.float32, **KW)
    want = jax.device_get(jmodel.init({'params': jax.random.PRNGKey(0)},
                                      jnp.zeros((1, 32, 32, 3)),
                                      train=False))
    model = models.ResNet(dtype=torch.float32, device='cpu',
                          generator=torch.Generator().manual_seed(0), **KW)
    got = models.to_flax_variables(model)
    gf, wf = dict(_flat(got)), dict(_flat(want))
    assert sorted(gf) == sorted(wf)
    for k in wf:
        assert gf[k].shape == wf[k].shape, k
        if k.endswith('BatchNorm_2/scale'):
            assert not gf[k].any()       # zero-init, as in the JAX model
        if k.endswith('kernel'):         # lecun normal: var ~ 1 / fan_in
            fan_in = np.prod(gf[k].shape[:-1])
            assert 0.3 < gf[k].var() * fan_in < 3.0, k


@pytest.mark.parametrize('size,kernel,stride,want', [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 1, (1, 1)),
    (33, 7, 2, (3, 3)), (9, 3, 2, (1, 1)), (8, 1, 2, (0, 0))])
def test_same_pads_match_xla(size, kernel, stride, want):
    assert same_pads(size, kernel, stride) == want
    pads = jax.lax.padtype_to_pads((size,), (kernel,), (stride,), 'SAME')
    assert tuple(pads[0]) == want


def test_unported_variants_raise():
    with pytest.raises(NotImplementedError, match='space_to_depth'):
        models.ResNet50(stem='space_to_depth', device='cpu')
    with pytest.raises(NotImplementedError):
        models.ResNet101()
    with pytest.raises(NotImplementedError):
        models.ResNet152()
