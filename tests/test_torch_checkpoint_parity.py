"""The port's step directories against the JAX package's orbax path.

- One tree -- a ``TransformerLM`` of 2 layers and d 32 initialised by
  the JAX package (flax names), a bfloat16 leaf and the counters a
  snapshot carries -- saved by JAX ``save_checkpoint`` (orbax) and by the
  port's (``torch.distributed.checkpoint``), sync and async: both
  restore the same values bit for bit, raw and into a template, and the
  two sidecars have the same keys and the same shape and dtype for every
  leaf under the same names.
- The twin of ``tests/mp_chaos_worker.py``'s ``train_preempt`` on two
  gloo processes: the JAX-initialised MLP (SGD 0.1, momentum 0.9) under
  the multi-node optimizer, ``sigterm_step=@3`` on both ranks, a
  collective ``PreemptionHandler(method='orbax')`` snapshot, then a
  relaunch that resumes from the step directory and completes the
  uninterrupted run's six losses exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import models as jmodels
from chainermn_tpu import serializers as jserializers
from chainermn_tpu_torch import serializers
from torch_spawn import save_tree, spawn

torch.set_num_threads(2)

LM_CFG = dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_len=16)


def _trees():
    """The same tree for both packages: ``(jax tree, port tree)``."""
    jm = jmodels.TransformerLM(dtype=jnp.float32, **LM_CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    scale = np.random.RandomState(1).randn(5).astype(np.float32)
    jtree = {'params': params, 'scale': jnp.asarray(scale, jnp.bfloat16),
             'iteration': 3, 'epoch_detail': 0.75, 'flag': np.array(True)}
    ptree = {'params': jax.tree_util.tree_map(np.asarray, params),
             'scale': torch.from_numpy(scale).to(torch.bfloat16),
             'iteration': 3, 'epoch_detail': 0.75, 'flag': np.array(True)}
    return jtree, ptree


def _bits(tree, prefix=''):
    """``{path: (dtype name, shape, bytes)}`` of a restored tree."""
    out = {}
    for k, v in tree.items():
        key = prefix + str(k)
        if isinstance(v, dict):
            out.update(_bits(v, key + '/'))
            continue
        if isinstance(v, torch.Tensor):
            name = str(v.dtype).replace('torch.', '')
            v = (v.view(torch.int16) if v.dtype == torch.bfloat16
                 else v).numpy()
        else:
            v = np.asarray(v)
            name = str(v.dtype)
            if name == 'bfloat16':
                v = v.view(np.int16)
        out[key] = (name, v.shape, np.ascontiguousarray(v).tobytes())
    return out


@pytest.mark.parametrize('async_', [False, True])
def test_restored_values_and_sidecars_match_jax(tmp_path, async_):
    jtree, ptree = _trees()
    jserializers.save_checkpoint(str(tmp_path / 'jax'), jtree, step=3,
                                 async_=async_)
    jserializers.wait_checkpoints()
    serializers.save_checkpoint(str(tmp_path / 'port'), ptree, step=3,
                                async_=async_)
    serializers.wait_checkpoints()
    jraw = jserializers.restore_checkpoint(str(tmp_path / 'jax'), None, 3)
    praw = serializers.restore_checkpoint(str(tmp_path / 'port'), None, 3)
    want = _bits(jraw)
    assert _bits(praw) == want
    # into a template: the same values, in the template's kinds
    _, template = _trees()
    template['params'] = jax.tree_util.tree_map(np.zeros_like,
                                                template['params'])
    template['scale'] = torch.zeros(5, dtype=torch.bfloat16)
    template.update(iteration=0, epoch_detail=0.0, flag=np.array(False))
    got = serializers.restore_checkpoint(str(tmp_path / 'port'), template, 3)
    assert _bits(got) == want
    assert type(got['iteration']) is int and got['iteration'] == 3
    # the sidecars: the same keys, each leaf's shape and dtype alike
    jm = jserializers.read_orbax_manifest(str(tmp_path / 'jax'), 3)
    pm = serializers.read_orbax_manifest(str(tmp_path / 'port'), 3)
    assert set(pm) == set(jm)
    assert pm['leaves'] == jm['leaves']
    assert pm['complete'] is True and pm['format'] == jm['format']
    for key in ('world_size', 'device_count'):
        assert pm[key] == 1
    assert serializers.checkpoint_complete(str(tmp_path / 'port' / '3'))
    serializers.verify_checkpoint(str(tmp_path / 'port' / '3'), template)


_PREEMPT = r'''
import os
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import models, serializers, training
from chainermn_tpu_torch.training import recovery
from chainermn_tpu_torch.utils import chaos

params = load_tree(argv[0], 'params/')
ckdir, phase = argv[1], argv[2]
STEPS = 6
rs = np.random.RandomState(100 + rank)
batch = (torch.as_tensor(rs.randn(4, 8).astype(np.float32)),
         torch.as_tensor((rs.rand(4) * 4).astype(np.int64)))


def build():
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=16, n_out=4, n_in=8, device='cpu')
    models.load_flax_variables(model, {'params': params})
    opt = cmt.create_multi_node_optimizer(torch.optim.SGD(
        model.parameters(), lr=0.1, momentum=0.9), comm)
    return training.StandardUpdater(iter([]), opt,
                                    models.classifier_loss(model), model,
                                    comm)


def step(up):
    return float(up.update_core(batch)['loss'])


# the uninterrupted run, before any fault is installed
oracle_up = build()
res['oracle'] = np.array([step(oracle_up) for _ in range(STEPS)])
up = build()
handler = recovery.PreemptionHandler(up, out=ckdir, method='orbax')
if phase == 'first':
    chaos.install(chaos.FaultInjector('seed=1;sigterm_step=@3'))
else:
    res['resumed_at'] = recovery.auto_resume(up, ckdir)
losses = []
while up.iteration < STEPS:
    losses.append(step(up))
    if handler.maybe_checkpoint():
        res['preempted_at'] = up.iteration
        res['snapshot'] = str(handler.checkpoint_path)
        break
res['losses'] = np.array(losses)
res['final_iteration'] = up.iteration
serializers.wait_checkpoints()
'''


def test_sigterm_checkpoints_a_step_directory_and_resumes(tmp_path):
    """The twin of the JAX package's
    ``test_sigterm_midstep_checkpoints_and_auto_resumes``."""
    jm = jmodels.MLP(n_units=16, n_out=4)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 8)))['params'])
    save_tree(tmp_path / 'in.npz', {'params': params})
    ckdir = tmp_path / 'train_state'
    first = spawn(tmp_path, _PREEMPT, 2, [tmp_path / 'in.npz', ckdir,
                                          'first'])
    for r in (0, 1):
        assert int(first[r]['preempted_at']) == 4, first[r]
        assert len(first[r]['losses']) == 4
    step_dir = ckdir / 'preempt' / '4'
    assert str(first[0]['snapshot']) == str(step_dir)
    assert (step_dir / '.metadata').exists()
    with open(ckdir / 'preempted.json') as f:
        assert json.load(f)['method'] == 'orbax'
    second = spawn(tmp_path, _PREEMPT, 2, [tmp_path / 'in.npz', ckdir,
                                           'resume'])
    for r in (0, 1):
        assert int(second[r]['resumed_at']) == 4, second[r]
        assert 'preempted_at' not in second[r]
        assert int(second[r]['final_iteration']) == 6
        full = np.concatenate([first[r]['losses'], second[r]['losses']])
        assert np.array_equal(full, second[r]['oracle']), (r, full)
