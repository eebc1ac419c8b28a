"""The port's TransformerLM training slice as a whole against the JAX
package: ``create_communicator('xla')`` -> ``TransformerLM`` ->
``create_multi_node_optimizer(torch.optim.Adam(lr=1e-3))`` ->
``StandardUpdater(lm_loss(model))`` -> ``Trainer`` on the CPU (plain
versions of the kernels), beside the JAX ``StandardUpdater`` with
``create_multi_node_optimizer(optax.adam(1e-3))`` on a one-device mesh
with the JAX kernels in Pallas interpret mode, from the same flax
weights and the same batch.

Tolerances: the loss at every step rtol 1e-4; every parameter leaf at
the end rtol/atol 1e-4, except the key slice of each ``qkv/bias``.  A
constant added to every score of a row leaves the softmax as it was, so
that slice's gradient is zero in exact arithmetic and each framework
sees only its own rounding noise there; Adam scales any gradient,
however small, to a step of about ``lr``, so after ``n`` updates the two
packages' key biases may differ by up to ``2 * lr * n`` while everything
else agrees.  That slice is held to this bound, stated apart.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import models as jmodels
from chainermn_tpu import training as jtraining
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import models, ops, training

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=16)
LR = 1e-3


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    assert jcommon.pallas_mode() == 'interpret'


def _batch(n=4, t=12):
    rng = np.random.RandomState(7)
    toks = rng.randint(0, CFG['vocab_size'], (n, t)).astype(np.int32)
    tgts = rng.randint(0, CFG['vocab_size'], (n, t)).astype(np.int32)
    return [(toks[i], tgts[i]) for i in range(n)]


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + '/')
        else:
            yield prefix + k, np.asarray(v)


def test_lm_training_slice_matches_jax(interpret, tmp_path):
    steps = 4                                  # 1 broadcast + 3 Adam updates
    data = _batch()
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    # JAX: one-device mesh (conftest gives JAX 8 virtual devices)
    jcomm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    jopt = chainermn_tpu.create_multi_node_optimizer(optax.adam(LR), jcomm)
    jup = jtraining.StandardUpdater(
        jtraining.SerialIterator(data, 4, shuffle=False), jopt,
        jmodels.lm_loss(lambda p, t: jm.apply({'params': p}, t)), params,
        jcomm, has_aux=True)
    # the port, from the same weights and the same batch
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    models.load_flax_variables(model, {'params': params})
    opt = cmt.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=LR), comm)
    up = training.StandardUpdater(
        training.SerialIterator(data, 4, shuffle=False), opt,
        models.lm_loss(model), model, comm)
    trainer = training.Trainer(up, (steps, 'iteration'), out=str(tmp_path))
    seen = []

    def compare(tr):
        jmetrics = jup.update()
        seen.append(tr.observation['loss'])
        assert sorted(tr.observation) == ['loss', 'perp']
        np.testing.assert_allclose(tr.observation['loss'], jmetrics['loss'],
                                   rtol=1e-4)
        np.testing.assert_allclose(tr.observation['perp'], jmetrics['perp'],
                                   rtol=1e-3)

    trainer.extend(compare, trigger=(1, 'iteration'))
    before = ops.launch_counts()
    trainer.run()
    assert ops.launch_counts() == before           # CPU: plain versions
    assert up.iteration == steps and len(seen) == steps
    # the first call broadcasts instead of stepping: same batch, same loss
    assert seen[0] == seen[1]
    assert seen[3] < seen[2] < seen[1]

    got = dict(_flat(models.to_flax_variables(model)['params']))
    want = dict(_flat(jax.device_get(jup.params)))
    start = dict(_flat(params))
    assert sorted(got) == sorted(want)
    updates = steps - 1
    for name in want:
        g, w = got[name], want[name]
        # every leaf moved: Adam steps about lr per update
        assert np.abs(w - start[name]).max() > 0.5 * LR, name
        if name.endswith('qkv/bias'):
            # (3, H, d_head): the key slice's own bound, stated above
            assert np.abs(g[1] - w[1]).max() <= 2 * LR * updates, name
            g, w = np.delete(g, 1, axis=0), np.delete(w, 1, axis=0)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=name)


def test_a_model_without_buffers_syncs_no_state():
    """The transformer has no buffers: the updater's ``model_state`` sync
    issues no collective for it."""
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    assert not list(model.buffers())
    opt = cmt.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=LR), comm)
    up = training.StandardUpdater(
        training.SerialIterator(_batch(), 4, shuffle=False), opt,
        models.lm_loss(model), model, comm)
    calls = []
    plain = comm.allreduce
    comm.allreduce = lambda x, op='mean': calls.append(x) or plain(x, op)
    up.update()
    # the metrics' average (a dict, reduced as a list inside) and nothing
    # before it
    assert len(calls) == 2 and sorted(calls[0]) == ['loss', 'perp']
    assert len(calls[1]) == 2


@pytest.mark.parametrize('name', ['policy', 'accum_steps', 'remat', 'zero',
                                  'device_prefetch'])
def test_unported_updater_options_still_raise(name):
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    with pytest.raises(NotImplementedError, match=name):
        training.StandardUpdater(iter([]), opt, models.lm_loss(model), model,
                                 comm, **{name: 2})
