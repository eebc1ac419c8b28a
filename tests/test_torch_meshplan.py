"""The port's ``MeshPlan`` against the JAX package's.

The degradation table of ``MeshPlan.create`` (every process count 1..8
and tp 1..8, shape-only), ``describe`` and ``local_shape``; then one
spawn of four gloo processes: a ``(2, 2)`` plan's communicator (data
replicas counted, gradients reduced over the data axis only, the first
broadcast leaving model shards alone, metrics over every process), and
the counterpart of ``tests/test_meshplan.py``'s trajectory test -- a
dp x tp = 2 x 2 ``TransformerLM(tp_axis='model')`` through
``StandardUpdater(plan.communicator())`` against the dp = 4 oracle on
``create_communicator('xla')`` and against the JAX plan's updater on 4
host devices (losses rtol 1e-5, parameters rtol 1e-4 / atol 1e-5, the
JAX test's), with the tensor-parallel snapshot saved gathered under the
JAX keys and resumed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu import training as jtraining
from chainermn_tpu.communicators import mesh_utility as jmesh_utility
from chainermn_tpu.models import (TransformerLM as JaxLM, lm_loss as jlm_loss,
                                  tp_param_specs as jtp_param_specs)
from chainermn_tpu.parallel.meshplan import MeshPlan as JaxMeshPlan
from chainermn_tpu_torch.communicators import mesh_utility
from chainermn_tpu_torch.parallel import MeshPlan
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
STEPS = 3


@pytest.mark.parametrize('n', range(1, 9))
def test_create_degrades_as_jax(n):
    for tp in range(1, 9):
        got = MeshPlan.create(tp=tp, size=n)
        want = JaxMeshPlan.create(tp=tp, devices=jax.devices()[:n])
        assert tuple(got.mesh.shape.values()) == tuple(
            want.mesh.shape.values()), (n, tp)
        assert got.axis_names == want.axis_names
        assert (got.size, got.data_size, got.model_size) == (
            want.size, want.data_size, want.model_size)
        assert got.describe() == want.describe()
        assert mesh_utility.divisor_leq(n, tp) == \
            jmesh_utility.divisor_leq(n, tp)


def test_create_validation_and_unported_axes():
    with pytest.raises(ValueError) as got:
        MeshPlan.create(tp=0, size=4)
    with pytest.raises(ValueError) as want:
        JaxMeshPlan.create(tp=0)
    assert str(got.value) == str(want.value)
    for kw in (dict(ep=2), dict(slices=1)):
        with pytest.raises(NotImplementedError, match='item 8'):
            MeshPlan.create(tp=2, size=4, **kw)
    # the pipe axis is ported: a 3-D plan (tests/test_torch_mesh_pipeline.py)
    assert MeshPlan.create(tp=2, size=4, pp=2).axis_names == (
        'data', 'model', 'pipe')
    plan = MeshPlan.create(tp=2, size=8, rank=5)
    assert plan.mesh.coords == (2, 1)
    assert (plan.pipe_size, plan.expert_size, plan.slice_size) == (1, 1, 1)
    jplan = JaxMeshPlan.create(tp=2)
    for shape, spec in (((8, 6), ('model', None)), ((4, 8), (None, 'data')),
                        ((8, 4), (('data', 'model'), None))):
        jspec = jax.sharding.PartitionSpec(*spec)
        assert plan.local_shape(shape, spec) == jplan.local_shape(shape,
                                                                  jspec)
    with pytest.raises(ValueError, match='does not divide'):
        plan.local_shape((3, 4), ('model',))
    # a shape-only plan binds its names, and a collective needs groups
    with plan.bind():
        from chainermn_tpu_torch.parallel import resolve_axis
        with pytest.raises(RuntimeError, match='without process groups'):
            resolve_axis('model')
    with pytest.raises(ValueError, match='bound by no mesh'):
        resolve_axis('model')


_BODY = r'''
from chainermn_tpu_torch import models, serializers, training
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch.parallel import MeshPlan

params = load_tree(argv[0], 'params/')
batch = np.load(argv[0])['batch']
tmp, cfg, steps = argv[1], eval(argv[2]), int(argv[3])
plan = MeshPlan.create(tp=2, device='cpu')
comm = plan.communicator()
res['topology'] = np.array([comm.size, comm.rank, comm.model_rank(),
                            comm.world_size, comm.world_rank,
                            comm.inter_size, comm.intra_size])
g = [torch.tensor([comm.model_rank() + 10.0 * comm.rank])]
comm.allreduce_grad(g)
res['allreduce_grad'] = g[0].numpy()
b = [torch.tensor([comm.model_rank() + 10.0 * comm.rank])]
comm.broadcast_data(b)
res['broadcast'] = b[0].numpy()
res['metric'] = comm.allreduce(torch.tensor(float(comm.world_rank))).numpy()
examples = [(batch[i, 0], batch[i, 1]) for i in range(len(batch))]


def tp_updater():
    with plan.bind():
        model = models.TransformerLM(dtype=torch.float32, device='cpu',
                                     tp_axis='model', **cfg)
    models.load_flax_variables(model, {'params': params})
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), comm)
    per = len(examples) // comm.size
    mine = examples[comm.rank * per:(comm.rank + 1) * per]
    return training.StandardUpdater(
        training.SerialIterator(mine, per, shuffle=False), opt,
        models.lm_loss(model), model, comm)


up = tp_updater()
res['tp_losses'] = np.array([up.update()['loss'] for _ in range(steps)])
state = serializers.updater_state(up)
for k, v in flat_tree(state['params']).items():
    res['tp_params/' + k] = v.copy()     # leaves may alias the params
if rank == 0:
    serializers.save_npz(tmp + '/tp.npz', state)
dist.barrier()
fresh = tp_updater()
serializers.resume_updater(tmp + '/tp.npz', fresh)
res['resumed_loss'] = np.array([fresh.update()['loss'], up.update()['loss']])
for k, v in flat_tree(fresh.params).items():
    res['resumed/' + k] = v
for k, v in flat_tree(up.params).items():
    res['straight/' + k] = v

dcomm = cmt.create_communicator('xla', device='cpu')
model = models.TransformerLM(dtype=torch.float32, device='cpu', **cfg)
models.load_flax_variables(model, {'params': params})
opt = cmt.create_multi_node_optimizer(
    torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9), dcomm)
per = len(examples) // 4
dup = training.StandardUpdater(
    training.SerialIterator(examples[rank * per:(rank + 1) * per], per,
                            shuffle=False), opt, models.lm_loss(model),
    model, dcomm)
res['dp_losses'] = np.array([dup.update()['loss'] for _ in range(steps)])
for k, v in flat_tree(dup.params).items():
    res['dp_params/' + k] = v
'''


def _lm_batch(n, seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, 64, (n, 16)).astype(np.int32)
    return np.stack([toks, np.roll(toks, -1, axis=1)], axis=1)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('meshplan')
    params = jax.device_get(JaxLM(dtype=jnp.float32, **CFG).init(
        jax.random.PRNGKey(1), jnp.zeros((1, 16), jnp.int32))['params'])
    batch = _lm_batch(8)
    save_tree(tmp / 'in.npz', {'params': params}, batch=batch)
    ranks = spawn(tmp, _BODY, 4, [tmp / 'in.npz', tmp, repr(CFG), STEPS])
    return params, batch, ranks, tmp


def test_plan_communicator_spans_the_data_axis(setup):
    _, _, ranks, _ = setup
    for r, res in enumerate(ranks):
        data, model = divmod(r, 2)
        assert list(res['topology']) == [2, data, model, 4, r, 2, 2]
        # the data mean keeps the model distinction: (0 + 10) / 2 + model
        np.testing.assert_allclose(res['allreduce_grad'], [model + 5.0])
        # replica 0's value of the same model index
        np.testing.assert_allclose(res['broadcast'], [float(model)])
        np.testing.assert_allclose(res['metric'], 1.5)   # every process


def _jax_tp_trajectory(params, batch):
    plan = JaxMeshPlan.create(tp=2, devices=jax.devices()[:4])
    comm = plan.communicator()
    model = JaxLM(dtype=jnp.float32, tp_axis=plan.model_axis, **CFG)
    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(0.1, momentum=0.9), comm)
    upd = jtraining.StandardUpdater(
        iter([]), opt, jlm_loss(lambda p, t: model.apply({'params': p}, t)),
        params, comm, has_aux=True,
        param_specs=jtp_param_specs(params, plan.model_axis), donate=False)
    data = [(batch[i, 0], batch[i, 1]) for i in range(len(batch))]
    losses = [float(upd.update_core(upd.shard_batch(data))['loss'])
              for _ in range(STEPS)]
    return losses, flat_tree(jax.device_get(upd.params))


def test_tp_trajectory_matches_data_parallel_and_jax(setup):
    params, batch, ranks, _ = setup
    jlosses, jparams = _jax_tp_trajectory(params, batch)
    for res in ranks:
        np.testing.assert_allclose(res['tp_losses'], res['dp_losses'],
                                   rtol=1e-5)
        np.testing.assert_allclose(res['tp_losses'], jlosses, rtol=1e-5)
        assert res['tp_losses'][0] == res['tp_losses'][1]   # broadcast
        for name, want in jparams.items():
            for src in ('tp_params/', 'dp_params/'):
                np.testing.assert_allclose(res[src + name], want,
                                           rtol=1e-4, atol=1e-5,
                                           err_msg=src + name)


def test_tp_snapshot_is_the_gathered_jax_tree_and_resumes(setup):
    params, _, ranks, tmp = setup
    from chainermn_tpu_torch import serializers
    by_key, _ = serializers.read_npz(str(tmp / 'tp.npz'))
    want = flat_tree(params)
    got = {k[len('params/'):]: v for k, v in by_key.items()
           if k.startswith('params/')}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name], ranks[0]['tp_params/'
                                                          + name])
    for res in ranks:
        assert res['resumed_loss'][0] == res['resumed_loss'][1]
        for name in want:
            np.testing.assert_array_equal(res['resumed/' + name],
                                          res['straight/' + name])
