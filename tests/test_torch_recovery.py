"""The port's preemption handler and resume walk against the JAX
package's ``training/recovery.py``.

- The MNIST MLP (SGD 0.1, momentum 0.9) and a ``TransformerLM`` of 2
  layers and d 64 (Adam 1e-3), each through ``create_multi_node_optimizer``
  and ``StandardUpdater``: 2 calls, a real SIGTERM to this process, the
  preemption snapshot at the step boundary, a fresh updater resumed by
  ``auto_resume``, 2 more calls.  The losses and the final parameters are
  bit-equal to 4 straight calls, and the losses equal the JAX package's
  same scenario at rtol 1e-5 (the LM's JAX kernels in Pallas interpret
  mode).
- ``auto_resume`` skips a truncated newest snapshot with
  ``CheckpointSkippedWarning``; ``latest_snapshot`` and ``snapshot_chain``
  pick what JAX's pick over one directory of torn, zero-byte and
  sentinel-less files; an asynchronous write's failure re-raises typed at
  ``wait``; a snapshot taken asynchronously is the state of its step,
  whatever the next steps do to the live tensors.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import models as jmodels
from chainermn_tpu import serializers as jserializers
from chainermn_tpu import training as jtraining
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu.training import recovery as jrecovery
from chainermn_tpu.utils import failure as jfailure
from chainermn_tpu_torch import models, serializers, training
from chainermn_tpu_torch.training import recovery
from chainermn_tpu_torch.utils import failure

torch.set_num_threads(2)

N_IN, N_UNITS, N_OUT, BATCH = 20, 16, 10, 8
LM_CFG = dict(vocab_size=48, d_model=64, n_heads=4, n_layers=2, d_ff=128,
              max_len=16)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    assert jcommon.pallas_mode() == 'interpret'


def _mlp_case():
    rng = np.random.RandomState(5)
    x = rng.randn(4 * BATCH, N_IN).astype(np.float32)
    y = rng.randint(0, N_OUT, 4 * BATCH).astype(np.int32)
    jm = jmodels.MLP(n_units=N_UNITS, n_out=N_OUT)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, N_IN)))['params'])

    def port():
        comm = cmt.create_communicator('xla', device='cpu')
        model = models.MLP(n_units=N_UNITS, n_out=N_OUT, n_in=N_IN,
                           device='cpu')
        models.load_flax_variables(model, {'params': params})
        opt = cmt.create_multi_node_optimizer(torch.optim.SGD(
            model.parameters(), lr=0.1, momentum=0.9), comm)
        return training.StandardUpdater(
            training.SerialIterator(list(zip(x, y)), BATCH, shuffle=False),
            opt, models.Classifier(model), model, comm)

    def jax_():
        comm = chainermn_tpu.create_communicator(
            'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
        opt = chainermn_tpu.create_multi_node_optimizer(
            optax.sgd(0.1, momentum=0.9), comm)
        return jtraining.StandardUpdater(
            jtraining.SerialIterator(list(zip(x, y)), BATCH, shuffle=False),
            opt, jmodels.Classifier(lambda p, v: jm.apply({'params': p}, v)),
            params, comm, has_aux=True, donate=False)

    return port, jax_


def _lm_case():
    rng = np.random.RandomState(7)
    toks = rng.randint(0, LM_CFG['vocab_size'], (16, 12)).astype(np.int32)
    tgts = rng.randint(0, LM_CFG['vocab_size'], (16, 12)).astype(np.int32)
    data = list(zip(toks, tgts))
    jm = jmodels.TransformerLM(dtype=jnp.float32, **LM_CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])

    def port():
        comm = cmt.create_communicator('xla', device='cpu')
        model = models.TransformerLM(dtype=torch.float32, device='cpu',
                                     **LM_CFG)
        models.load_flax_variables(model, {'params': params})
        opt = cmt.create_multi_node_optimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3), comm)
        return training.StandardUpdater(
            training.SerialIterator(data, 4, shuffle=False), opt,
            models.lm_loss(model), model, comm)

    def jax_():
        comm = chainermn_tpu.create_communicator(
            'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
        opt = chainermn_tpu.create_multi_node_optimizer(optax.adam(1e-3),
                                                        comm)
        return jtraining.StandardUpdater(
            jtraining.SerialIterator(data, 4, shuffle=False), opt,
            jmodels.lm_loss(lambda p, t: jm.apply({'params': p}, t)),
            params, comm, has_aux=True)

    return port, jax_


def _preempted_run(build, rec, out, fresh=True):
    """2 calls, SIGTERM to self, the preemption snapshot, a fresh updater
    (or, with ``fresh=False``, the same one: the JAX reference, which then
    compiles its step once) resumed from ``out``, 2 calls; returns the 4
    losses and the last updater."""
    up = build()
    handler = rec.PreemptionHandler(up, out=out)
    try:
        losses = [float(up.update()['loss']) for _ in range(2)]
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.received_signal == signal.SIGTERM
        path = handler.maybe_checkpoint()
    finally:
        handler.restore_signal_handlers()
    assert path and os.path.basename(path) == 'preempt_iter_2.npz'
    up2 = build() if fresh else up
    assert rec.auto_resume(up2, out) == 2
    losses += [float(up2.update()['loss']) for _ in range(2)]
    return losses, up2


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + '/')
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize('case', ['mlp', 'lm'])
def test_preempted_resume_is_the_straight_run(case, interpret, tmp_path):
    port, jax_ = {'mlp': _mlp_case, 'lm': _lm_case}[case]()
    straight = port()
    want = [float(straight.update()['loss']) for _ in range(4)]
    got, resumed = _preempted_run(port, recovery, str(tmp_path / 'port'))
    assert got == want                                   # bit for bit
    ref = dict(_flat(straight.params))
    params = dict(_flat(resumed.params))
    assert sorted(params) == sorted(ref)
    for name in ref:
        assert np.array_equal(params[name], ref[name]), name
    # the JAX package's own preemption and resume, the same scenario
    jgot, _ = _preempted_run(jax_, jrecovery, str(tmp_path / 'jax'),
                             fresh=False)
    np.testing.assert_allclose(got, jgot, rtol=1e-5)
    start = dict(_flat(port().params))
    assert any(not np.array_equal(params[n], start[n]) for n in start)


def _tree(i):
    return {'x': np.arange(4.0) + i, 'iteration': np.int64(i)}


def test_latest_snapshot_picks_what_jax_picks(tmp_path):
    d = str(tmp_path)
    serializers.save_npz(os.path.join(d, 'preempt_iter_2'), _tree(2))
    jserializers.save_npz(os.path.join(d, 'snapshot_iter_3'), _tree(3))
    (tmp_path / 'preempt_iter_9.npz').write_bytes(b'')
    with open(os.path.join(d, 'preempt_iter_7.npz'), 'wb') as f:
        np.savez(f, x=np.arange(4.0))               # no manifest sentinel
    (tmp_path / 'preempt_iter_5.npz').write_bytes(b'not a zip')
    serializers.save_npz(os.path.join(d, 'snapshot_iter_5'), _tree(5))
    os.truncate(os.path.join(d, 'snapshot_iter_5.npz'), 100)   # torn
    (tmp_path / 'preempted.json').write_text('{}')  # not a candidate
    assert recovery.snapshot_chain(d) == jrecovery.snapshot_chain(d)
    assert [c[2] for c in recovery.snapshot_chain(d)] == [9, 7, 5, 5, 3, 2]
    assert recovery.latest_snapshot(d) == jrecovery.latest_snapshot(d)
    assert recovery.latest_snapshot(d)[2] == 3
    assert [r[:3] for r in recovery.chain_heads(d)] == [
        r[:3] for r in jrecovery.chain_heads(d)]
    assert recovery.latest_snapshot(str(tmp_path / 'none')) == (
        None, None, None)


def test_auto_resume_skips_a_truncated_newest_snapshot(tmp_path):
    port, _ = _mlp_case()
    out = str(tmp_path)
    up = port()
    handler = recovery.PreemptionHandler(up, out=out, signals=())
    up.update()
    up.update()
    handler.checkpoint()                       # valid, iteration 2
    want = {k: v.copy() for k, v in _flat(up.params)}
    up.update()
    newest = handler.checkpoint()              # iteration 3, then torn
    os.truncate(newest, os.path.getsize(newest) // 2)
    fresh = port()
    with pytest.warns(failure.CheckpointSkippedWarning,
                      match='skipping corrupt snapshot'):
        assert recovery.auto_resume(fresh, out) == 2
    got = dict(_flat(fresh.params))
    for name in want:
        assert np.array_equal(got[name], want[name]), name
    # the JAX walk makes the same choice over the same directory
    kinds = [c[1] for c in jrecovery.snapshot_chain(out)]
    assert kinds == [c[1] for c in recovery.snapshot_chain(out)]
    with pytest.raises(jfailure.CheckpointCorruptError):
        jserializers.read_npz(newest)


def test_orbax_method_is_not_ported():
    port, _ = _mlp_case()
    with pytest.raises(NotImplementedError, match='A9'):
        recovery.PreemptionHandler(port(), method='orbax', signals=())


def test_async_write_failure_reraises_typed_at_wait(tmp_path):
    port, _ = _mlp_case()
    up = port()
    up.update()
    blocker = tmp_path / 'blocked'
    blocker.write_text('a file where the snapshot directory should be')
    handler = recovery.PreemptionHandler(up, out=str(tmp_path / 'ok'),
                                         signals=(), async_=True)
    handler.out = str(blocker / 'sub')          # makedirs fails below
    with pytest.raises(OSError):
        handler.checkpoint()
    handler.out = str(tmp_path / 'ok')
    writer = handler.writer

    def bad():
        raise failure.CheckpointCorruptError('disk said no', kind='crc')

    writer.submit(bad)
    with pytest.raises(failure.CheckpointCorruptError):
        writer.wait(timeout=30)
    assert writer.wait(timeout=30)             # cleared once raised
    path = handler.checkpoint()                # the handler still works
    assert handler.wait(timeout=30)
    assert serializers.checkpoint_complete(path)


def test_async_snapshot_is_the_state_of_its_step(tmp_path):
    """The host copy taken at the step boundary: steps after it change
    the live tensors in place, the snapshot keeps its step's values."""
    port, _ = _mlp_case()
    up = port()
    for _ in range(2):
        up.update()
    want = serializers.updater_state(up)
    want_params = {k: v.copy() for k, v in _flat(want['params'])}
    want_moments = {k: v.copy() for k, v in _flat(want['opt_state'])
                    if v.ndim}
    handler = recovery.PreemptionHandler(up, out=str(tmp_path),
                                         signals=(), async_=True)
    gate = __import__('threading').Event()
    handler.writer.submit(gate.wait)           # the writer is busy ...
    path = handler.checkpoint()                # ... so this one waits
    for _ in range(2):
        up.update()                            # in-place updates
    gate.set()
    assert handler.wait(timeout=30)
    by_key, manifest = serializers.read_npz(path)
    assert manifest['complete']
    for name, v in want_params.items():
        assert np.array_equal(by_key['params/' + name], v), name
    for name, v in want_moments.items():
        assert np.array_equal(np.asarray(by_key['opt_state/' + name]),
                              v), name
    assert int(by_key['iteration']) == 2
    # the JAX package reads the port's preemption snapshot
    jby_key, _ = jserializers.read_npz(path)
    assert sorted(jby_key) == sorted(by_key)
