"""Shared set-up of the conv-zoo parity tests (``test_torch_zoo.py``,
``test_torch_zoo_googlenet.py``, ``test_torch_zoo_googlenetbn.py``):
flax weights with every bias and BatchNorm affine and statistic
perturbed so that each branch carries signal, the same batch, the
port's model loaded from them, and the checks of logits and gradients
against the JAX model.

Gradients are compared with both models in float64: in f32 a max pool
may route a near-tie's gradient to another element, so the f32
gradients of the deep relu stacks sit up to 1% (XLA's, NIN) or 0.2%
(the port's, GoogLeNet) off their own f64 values, and GoogLeNet-BN's
train-mode logits 3e-5 (both frameworks) off theirs.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
import torch.nn.functional as F

from chainermn_tpu import models as jmodels
from chainermn_tpu_torch import models

TDTYPE = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def _perturb(tree, rng):
    out = {}
    for k, x in tree.items():
        if isinstance(x, dict):
            out[k] = _perturb(x, rng)
        elif k == 'scale':
            out[k] = (1.0 + 0.2 * rng.randn(*x.shape)).astype(np.float32)
        elif k in ('bias', 'mean'):
            out[k] = (0.1 * rng.randn(*x.shape)).astype(np.float32)
        elif k == 'var':
            out[k] = (1.0 + 0.2 * rng.rand(*x.shape)).astype(np.float32)
        else:
            out[k] = np.array(x)
    return out


@functools.lru_cache(maxsize=None)
def _jax_setup(name, insize, batch, dtype):
    jmodel = jmodels.get_arch(name, num_classes=10,
                              dtype=getattr(jnp, dtype))
    v = jax.device_get(jax.jit(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0)},
        jnp.zeros((1, insize, insize, 3)), train=False))())
    v = _perturb(v, np.random.RandomState(1))
    rng = np.random.RandomState(2)
    x = rng.randn(batch, insize, insize, 3).astype(np.float32)
    y = rng.randint(0, 10, batch).astype(np.int32)
    return jmodel, v, x, y


def setup(name, insize, batch, dtype='float32', **kw):
    """``(jax model, flax variables, x, y, port model)`` at 10 classes
    (the JAX side made once per process; the port's model anew)."""
    jmodel, v, x, y = _jax_setup(name, insize, batch, dtype)
    model = models.get_arch(name, num_classes=10, dtype=TDTYPE[dtype],
                            insize=insize, device='cpu', **kw)
    models.load_flax_variables(model, v)
    return jmodel, v, x, y, model


def port64(name, insize, v, **kw):
    """The port's model in float64, from the flax weights."""
    model = models.get_arch(name, num_classes=10, dtype=torch.float64,
                            insize=insize, device='cpu', **kw).double()
    models.load_flax_variables(model, v)
    return model


def tol(want, rtol):
    """``rtol`` of the largest element, as an absolute bound too."""
    return dict(rtol=rtol, atol=rtol * float(np.abs(want).max()))


def jax64(name, insize, batch, train):
    """The JAX model in float64 (the heads flax pins to f32 stay f32) on
    :func:`setup`'s weights and batch: ``(logits, batch_stats or None,
    grads of the cross-entropy)``, made once per process."""
    return _jax64(name, insize, batch, train)


@functools.lru_cache(maxsize=None)
def _jax64(name, insize, batch, train):
    _, v, x, y = _jax_setup(name, insize, batch, 'float32')
    with jax.enable_x64(True):
        jmodel = jmodels.get_arch(name, num_classes=10, dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v)

        def loss(params):
            out = jmodel.apply(dict(v64, params=params),
                               x.astype(np.float64), train=train,
                               mutable=['batch_stats'] if train else False)
            logits, state = out if train else (out, None)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), (logits, state)

        (_, (logits, state)), grads = jax.jit(jax.value_and_grad(
            loss, has_aux=True))(v64['params'])
        return jax.device_get((logits, state, grads))


def backward64(model, x, y):
    """The cross-entropy's backward through the port's f64 model;
    returns its logits."""
    logits = model(torch.from_numpy(x).double())
    F.cross_entropy(logits, torch.from_numpy(y).long()).backward()
    return logits.detach().numpy()


def check_grads(model, jgrads, rtol=1e-4):
    """Every flax leaf's gradient against the port parameter's (a
    parameter without a gradient counts as zeros)."""
    params = dict(model.named_parameters())
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(jgrads):
        keys = [p.key for p in path]
        name = '.'.join(keys[:-1] + (['weight'] if keys[-1] == 'kernel'
                                     else [keys[-1]]))
        g = params[name].grad
        g = (torch.zeros_like(params[name]) if g is None else g)
        g = g.double().numpy()
        if keys[-1] == 'kernel':
            g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g.T
        want = np.asarray(leaf)
        np.testing.assert_allclose(g, want, **tol(want, rtol),
                                   err_msg='/'.join(keys))
        n += 1
    assert n == len(params)


def check_eval(name, insize, batch):
    """Eval-mode logits in f32 (rtol 1e-5 of the largest) against the
    JAX model in f32, and every gradient (rtol 1e-4) in f64; the flax
    round trip of the loaded model is exact."""
    jmodel, v, x, y, model = setup(name, insize, batch)
    model.eval()
    want = np.asarray(jax.jit(lambda: jmodel.apply(v, x, train=False))())
    got = model(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, **tol(want, 1e-5))
    back = dict(jax.tree_util.tree_leaves_with_path(
        models.to_flax_variables(model)))
    flat = dict(jax.tree_util.tree_leaves_with_path(v))
    assert set(back) == set(flat)
    for path, leaf in flat.items():
        np.testing.assert_array_equal(back[path], leaf)
    logits64, _, jgrads = jax64(name, insize, batch, False)
    model = port64(name, insize, v).eval()
    got64 = backward64(model, x, y)
    np.testing.assert_allclose(got64, logits64, **tol(logits64, 1e-5))
    check_grads(model, jgrads)


def flax_paths(module):
    """The flax tree paths the module's parameters and buffers map to."""
    out = set()
    for collection, named in (('params', module.named_parameters()),
                              ('batch_stats', module.named_buffers())):
        for key, _ in named:
            parts = key.split('.')
            if parts[-1] == 'weight':
                parts[-1] = 'kernel'
            out.add("['%s']" % "']['".join([collection] + parts))
    return out


def check_count(name, insize):
    """At 1000 classes and ``insize``, the same leaves and the same
    parameter count as the flax tree, exactly (the port's model on the
    meta device)."""
    jmodel = jmodels.get_arch(name)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {'params': jax.random.PRNGKey(0)},
        jnp.zeros((1, insize, insize, 3)), train=False))
    want = sum(int(np.prod(s.shape))
               for s in jax.tree_util.tree_leaves(shapes['params']))
    with torch.device('meta'):
        model = models.get_arch(name, device='meta')
    assert model.insize == insize
    assert sum(p.numel() for p in model.parameters()) == want
    assert flax_paths(model) == {
        jax.tree_util.keystr(p)
        for p, _ in jax.tree_util.tree_leaves_with_path(shapes)}
    return want
