"""``NanGuard(checkpoint_on_divergence=True)``'s ``divergence.json``: the
port's sidecar carries the JAX sidecar's keys (``process_index``, not
``rank``), each written by a run that diverges in this process."""

import json
import os

import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu.utils import chaos as jchaos
from chainermn_tpu.utils import failure as jfailure
from chainermn_tpu_torch import models, ops, training, utils

torch.set_num_threads(2)


def _port_sidecar(out):
    """The scenario of ``test_torch_extensions.py``'s NanGuard test: a
    healthy MLP run, then a NaN bias."""
    comm = cmt.create_communicator('naive', device='cpu')
    model = models.MLP(n_units=16, device='cpu')
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
    rng = np.random.RandomState(0)
    data = [(rng.randn(784).astype(np.float32), np.int32(i % 10))
            for i in range(8)]
    up = training.StandardUpdater(
        training.SerialIterator(data, 4, shuffle=False), opt,
        models.Classifier(model), model, comm)
    guard = utils.NanGuard(param_interval=1, checkpoint_on_divergence=True)
    trainer = training.Trainer(up, (4, 'iteration'), out=out)
    trainer.extend(guard)
    trainer.run()
    with torch.no_grad():
        up.model.Dense_1.bias[3] = float('nan')
    trainer = training.Trainer(up, (6, 'iteration'), out=out)
    trainer.extend(guard)
    with pytest.raises(utils.DivergenceError):
        trainer.run()
    with open(os.path.join(out, 'divergence', 'divergence.json')) as f:
        return json.load(f)


def _jax_sidecar(out):
    """The JAX package's sidecar (``tests/test_chaos.py``'s scenario: a
    NaN batch at step 2 of an MLP run)."""
    import jax
    import jax.numpy as jnp
    from chainermn_tpu import training as jtraining
    from chainermn_tpu.models import MLP, classifier_loss
    comm = chainermn_tpu.create_communicator('xla')
    model = MLP(n_units=8, n_out=3)
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 6), jnp.float32))['params']
    loss_fn = classifier_loss(lambda p, x: model.apply({'params': p}, x))
    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(0.1, momentum=0.9), comm)
    rs = np.random.RandomState(0)
    batch = [(rs.randn(6).astype(np.float32), int(rs.rand() * 3))
             for _ in range(comm.size * 2)]

    class _It:
        epoch, epoch_detail, is_new_epoch = 0, 0.0, False

        def __iter__(self):
            return self

        def __next__(self):
            return batch

    up = jtraining.StandardUpdater(_It(), opt, loss_fn, params, comm,
                                   has_aux=True, donate=False)
    trainer = jtraining.Trainer(up, stop_trigger=(8, 'iteration'), out=out)
    trainer.extend(jfailure.NanGuard(param_interval=0,
                                     checkpoint_on_divergence=True),
                   trigger=(1, 'iteration'))
    jchaos.install(jchaos.FaultInjector('nan_batch=@2'))
    try:
        with pytest.raises(jfailure.DivergenceError):
            trainer.run()
    finally:
        jchaos.uninstall()
    with open(os.path.join(out, 'divergence', 'divergence.json')) as f:
        return json.load(f)


def test_divergence_sidecar_keys_match_jax(tmp_path):
    port = _port_sidecar(str(tmp_path / 'port'))
    want = _jax_sidecar(str(tmp_path / 'jax'))
    assert set(port) == set(want)
    assert port['process_index'] == want['process_index'] == 0
    assert port['iteration'] == 5 and 'loss' in port['bad']
    assert os.path.exists(port['checkpoint'])
