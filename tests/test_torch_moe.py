"""The port's expert parallelism against the JAX package's.

In this process: ``sort_dispatch`` and ``dense_dispatch_reference``
bit-equal to the JAX functions on the same numpy inputs, with drops
forced (and their gradients through dispatch and combine), and the
router's top-k on ties (the lower expert index wins, as ``lax.top_k``
breaks them).  One spawn of four gloo processes on
``MeshPlan.create(ep=4)``: ``MoELayer`` with k = 1 and 2 (outputs,
``aux_loss``, ``dropped_fraction`` and every gradient) against the JAX
layer under ``shard_map`` on 4 host devices at rtol 1e-4 / atol 1e-5,
and ``moe_transformer_block`` (the construction of JAX
``test_moe_transformer_block_matches_dense``, 8 experts, 2 a process)
with its loss and every gradient against the JAX block.  The JAX loss
is ``psum(sum y**2) + c * pmean(aux)``; each process seeds its share
(``sum y**2 + c * aux / ep``) and sums the replicated leaves' gradients
over the expert axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu.parallel import moe as jmoe
from chainermn_tpu.parallel import MoELayer as JaxMoELayer
from chainermn_tpu_torch.parallel import moe
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

EP, D, FF, T_LOCAL, AUX = 4, 8, 16, 16, 0.01
BLOCK = dict(b=8, t=8, h=2, dh=8, d=16, ff=32, experts=8)


# ------------------------------------------------------------- dispatch
@pytest.mark.parametrize('tokens,n_experts,capacity', [
    (64, 4, 9),       # the JAX test's: forces drops
    (64, 4, 16),      # exactly fits on average, drops where skewed
    (33, 8, 2),       # heavy drops, ragged token count
    (16, 4, 64),      # nothing drops
])
def test_dispatch_is_bit_equal_to_jax(tokens, n_experts, capacity):
    rng = np.random.RandomState(11)
    x = rng.randn(tokens, 8).astype(np.float32)
    idx = rng.randint(0, n_experts, tokens)
    out = rng.randn(n_experts, capacity, 8).astype(np.float32)
    for port_fn, jax_fn in ((moe.sort_dispatch, jmoe.sort_dispatch),
                            (moe.dense_dispatch_reference,
                             jmoe.dense_dispatch_reference)):
        ein, comb, keep = port_fn(torch.from_numpy(x),
                                  torch.from_numpy(idx), n_experts, capacity)
        jein, jcomb, jkeep = jax_fn(jnp.asarray(x), jnp.asarray(idx),
                                    n_experts, capacity)
        np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
        np.testing.assert_array_equal(ein.numpy(), np.asarray(jein))
        np.testing.assert_array_equal(comb(torch.from_numpy(out)).numpy(),
                                      np.asarray(jcomb(jnp.asarray(out))))
    # the two port forms agree with each other, and drops happened where
    # the capacity is short
    s = moe.sort_dispatch(torch.from_numpy(x), torch.from_numpy(idx),
                          n_experts, capacity)
    d = moe.dense_dispatch_reference(torch.from_numpy(x),
                                     torch.from_numpy(idx), n_experts,
                                     capacity)
    np.testing.assert_array_equal(s[0].numpy(), d[0].numpy())
    if capacity * n_experts < tokens:
        assert not bool(s[2].all())


def test_dispatch_gradients_match_jax():
    rng = np.random.RandomState(11)
    tokens, n_experts, capacity = 64, 4, 9
    x = rng.randn(tokens, 8).astype(np.float32)
    idx = rng.randint(0, n_experts, tokens)

    def jax_grad(dispatch):
        def f(xx):
            ein, comb, _ = dispatch(xx, jnp.asarray(idx), n_experts,
                                    capacity)
            return jnp.sum(comb(jnp.tanh(ein)) ** 2)
        return np.asarray(jax.grad(f)(jnp.asarray(x)))

    for port_fn, jax_fn in ((moe.sort_dispatch, jmoe.sort_dispatch),
                            (moe.dense_dispatch_reference,
                             jmoe.dense_dispatch_reference)):
        xt = torch.from_numpy(x.copy()).requires_grad_()
        ein, comb, _ = port_fn(xt, torch.from_numpy(idx), n_experts,
                               capacity)
        (comb(torch.tanh(ein)) ** 2).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), jax_grad(jax_fn),
                                   rtol=1e-6, atol=1e-6)
        # a dropped token gets no gradient
        assert (xt.grad.abs().sum(1) == 0).any()


@pytest.mark.parametrize('k', [1, 2, 3])
def test_route_breaks_ties_as_lax_top_k(k):
    # equal logits within each row: the top k must be the lowest indices
    x = np.zeros((4, 3), np.float32)
    x[1] = [1.0, 1.0, 0.0]
    x[2] = [0.0, 2.0, 2.0]
    router = np.array([[1.0, 1.0, 0.5, 1.0, 0.0],
                       [0.0, 0.0, 0.0, 0.0, 1.0],
                       [0.5, 0.5, 0.5, 0.5, 0.5]], np.float32)
    params = {'router': torch.from_numpy(router)}
    probs, idx, gate = moe._route(params, torch.from_numpy(x), k)
    jprobs, jidx, jgate = jmoe._route({'router': jnp.asarray(router)},
                                      jnp.asarray(x), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), rtol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6)


def test_layer_refuses_k_zero_and_uneven_experts():
    with pytest.raises(ValueError, match='k must be'):
        moe.MoELayer(k=0)
    with pytest.raises(ValueError, match='experts must divide'):
        moe.MoELayer().init_params(0, 4, 8, n_experts_total=6, n_devices=4)
    tree = moe.MoELayer().init_params(3, 4, 8, n_experts_total=8,
                                      n_devices=4)
    assert {k: v.shape for k, v in tree.items()} == {
        'router': (4, 8), 'w_in': (8, 4, 8), 'w_out': (8, 8, 4)}


# ------------------------------------------------- the spawned layer
_BODY = r'''
from chainermn_tpu_torch import models
from chainermn_tpu_torch.parallel import (MeshPlan, MoELayer,
                                          moe_transformer_block, sum_grads)

f = np.load(argv[0])
plan = MeshPlan.create(ep=4, device='cpu')
assert tuple(plan.mesh.shape.values()) == (1, 4), plan.mesh.shape
ep, me, aux_c = 4, plan.mesh.axis_index('expert'), float(argv[1])
res['describe'] = np.array(repr(plan.describe()))


def local(tree):
    specs = plan.expert_param_specs(tree)
    return {k: torch.nn.Parameter(torch.from_numpy(np.array(v)))
            for k, v in models.shard_variables(tree, specs,
                                               plan.mesh).items()}


def rows(x):
    n = x.shape[0] // ep
    return torch.from_numpy(np.array(x[me * n:(me + 1) * n])
                            ).requires_grad_()


for k in (1, 2):
    params = local(load_tree(argv[0], 'layer/'))
    x = rows(f['x'])
    layer = MoELayer(axis='expert', capacity_factor=1.0, k=k)
    with plan.bind():
        y, aux = layer(params, x)
        ((y ** 2).sum() + aux_c * aux['aux_loss'] / ep).backward()
    sum_grads([params['router']], plan.mesh, axes=('expert',))
    res['k%d/y' % k] = y.detach().numpy()
    res['k%d/aux' % k] = aux['aux_loss'].detach().numpy()
    res['k%d/dropped' % k] = aux['dropped_fraction'].numpy()
    res['k%d/gx' % k] = x.grad.numpy()
    for name, p in params.items():
        res['k%d/g/%s' % (k, name)] = p.grad.numpy()

tree = load_tree(argv[0], 'block/')
moe_params = local(tree.pop('moe'))
params = {k: torch.nn.Parameter(torch.from_numpy(np.array(v)))
          for k, v in tree.items()}
params['moe'] = moe_params
x = rows(f['xb'])
layer = MoELayer(axis='expert', capacity_factor=8.0)
with plan.bind():
    y, aux = moe_transformer_block(x, params, layer, n_heads=int(argv[2]))
    loss = (y ** 2).sum() + aux_c * aux['aux_loss'] / ep
    loss.backward()
replicated = [p for k, p in params.items() if k != 'moe'] + [
    moe_params['router']]
sum_grads(replicated, plan.mesh, axes=('expert',))
res['block/loss'] = loss.detach().numpy()
res['block/gx'] = x.grad.numpy()
for name, p in params.items():
    if name != 'moe':
        res['block/g/' + name] = p.grad.numpy()
for name, p in moe_params.items():
    res['block/g/moe/' + name] = p.grad.numpy()
'''


def _jmesh():
    return Mesh(np.array(jax.devices()[:EP]), ('expert',))


def _layer_inputs():
    layer = JaxMoELayer(axis='expert')
    params = jax.device_get(layer.init_params(
        jax.random.PRNGKey(1), D, FF, n_experts_total=EP, n_devices=EP))
    rng = np.random.RandomState(7)
    x = rng.randn(EP * T_LOCAL, D).astype(np.float32)
    return params, x


def _block_inputs():
    c = BLOCK
    rng = np.random.RandomState(3)
    layer = JaxMoELayer(axis='expert', capacity_factor=8.0)
    params = {
        'ln1_scale': np.ones((c['d'],), np.float32),
        'ln1_bias': np.zeros((c['d'],), np.float32),
        'wqkv': (rng.randn(c['d'], 3, c['h'], c['dh']) * 0.2).astype(
            np.float32),
        'wo': (rng.randn(c['h'] * c['dh'], c['d']) * 0.2).astype(np.float32),
        'bo': (rng.randn(c['d']) * 0.1).astype(np.float32),
        'ln2_scale': np.ones((c['d'],), np.float32),
        'ln2_bias': np.zeros((c['d'],), np.float32),
        'moe': jax.device_get(layer.init_params(
            jax.random.PRNGKey(0), c['d'], c['ff'],
            n_experts_total=c['experts'], n_devices=EP)),
    }
    x = (rng.randn(c['b'], c['t'], c['d']) * 0.5).astype(np.float32)
    return params, x


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('moe')
    lparams, x = _layer_inputs()
    bparams, xb = _block_inputs()
    save_tree(tmp / 'in.npz', {'layer': lparams, 'block': bparams}, x=x,
              xb=xb)
    return spawn(tmp, _BODY, EP, [tmp / 'in.npz', AUX, BLOCK['h']])


_MOE_SPECS = {'router': P(), 'w_in': P('expert'), 'w_out': P('expert')}


def _jax_layer(k):
    params, x = _layer_inputs()
    layer = JaxMoELayer(axis='expert', capacity_factor=1.0, k=k)

    def fwd(p, xx):
        y, aux = layer(p, xx)
        return y, aux['aux_loss'][None], aux['dropped_fraction'][None]

    def loss(p, xx):
        def f(p, xx):
            y, aux = layer(p, xx)
            return (jax.lax.psum(jnp.sum(y ** 2), 'expert')
                    + AUX * jax.lax.pmean(aux['aux_loss'], 'expert'))
        return jax.shard_map(f, mesh=_jmesh(), in_specs=(
            _MOE_SPECS, P('expert')), out_specs=P(), check_vma=False)(p, xx)

    y, aux, dropped = jax.jit(jax.shard_map(
        fwd, mesh=_jmesh(), in_specs=(_MOE_SPECS, P('expert')),
        out_specs=(P('expert'), P('expert'), P('expert')),
        check_vma=False))(params, jnp.asarray(x))
    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    return (np.asarray(y), np.asarray(aux), np.asarray(dropped),
            jax.device_get(gp), np.asarray(gx))


def _shard(a, r):
    n = a.shape[0] // EP
    return a[r * n:(r + 1) * n]


@pytest.mark.parametrize('k', [1, 2])
def test_moe_layer_matches_jax_shard_map(ranks, k):
    y, aux, dropped, gp, gx = _jax_layer(k)
    tol = dict(rtol=1e-4, atol=1e-5)
    assert dropped.max() > 0        # capacity factor 1 drops somewhere
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res['k%d/y' % k], _shard(y, r), **tol)
        # the aux loss and dropped fraction are per-device values
        np.testing.assert_allclose(res['k%d/aux' % k], aux.reshape(-1)[r],
                                   **tol)
        np.testing.assert_allclose(res['k%d/dropped' % k],
                                   dropped.reshape(-1)[r], **tol)
        np.testing.assert_allclose(res['k%d/gx' % k], _shard(gx, r), **tol)
        np.testing.assert_allclose(res['k%d/g/router' % k], gp['router'],
                                   **tol)
        for name in ('w_in', 'w_out'):
            np.testing.assert_allclose(res['k%d/g/%s' % (k, name)],
                                       _shard(gp[name], r), **tol,
                                       err_msg=name)


def _jax_block():
    from chainermn_tpu.parallel import moe_transformer_block as jblock
    params, x = _block_inputs()
    layer = JaxMoELayer(axis='expert', capacity_factor=8.0)
    specs = {k: P() for k in params if k != 'moe'}
    specs['moe'] = _MOE_SPECS

    def loss(xx, p):
        def f(xx, p):
            y, aux = jblock(xx, p, layer, n_heads=BLOCK['h'])
            return (jax.lax.psum(jnp.sum(y ** 2), 'expert')
                    + AUX * jax.lax.pmean(aux['aux_loss'], 'expert'))
        return jax.shard_map(f, mesh=_jmesh(), in_specs=(P('expert'), specs),
                             out_specs=P(), check_vma=False)(xx, p)

    val = jax.jit(loss)(jnp.asarray(x), params)
    gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x), params)
    return float(val), np.asarray(gx), jax.device_get(gp)


def test_moe_transformer_block_gradients_match_jax(ranks):
    val, gx, gp = _jax_block()
    tol = dict(rtol=1e-4, atol=1e-5)
    total = sum(float(res['block/loss']) for res in ranks)
    assert abs(total - val) <= 1e-4 * abs(val)
    want = flat_tree(gp)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res['block/gx'], _shard(gx, r), **tol)
        for name, g in want.items():
            if name in ('moe/w_in', 'moe/w_out'):
                g = _shard(g, r)
            np.testing.assert_allclose(res['block/g/' + name], g, **tol,
                                       err_msg=name)
