"""The port's MNIST slice against the JAX package.

The data stand-ins bit for bit, ``MLP`` + ``Classifier`` (logits, loss,
accuracy, label smoothing, every gradient) from the JAX package's
weights, a broadcast call and 3 steps of the multi-node
``FusedMomentumSGD`` against ``optax.sgd(0.1, momentum=0.9)`` on the
8-device mesh, the reference's convergence gate (``tests/test_mnist.py``)
on gloo ranks spawned as processes, its two negative tests, and the
example script with a snapshot and a resume that continues bit for bit.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import training as jtraining
from chainermn_tpu.datasets import mnist as jmnist
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import Classifier as JaxClassifier
from chainermn_tpu_torch import models, ops, training
from chainermn_tpu_torch.datasets import mnist
from chainermn_tpu_torch.examples.mnist import train_mnist

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-6   # the f32 parity tolerance


# ---------------------------------------------------------------------
# data

@pytest.mark.parametrize('variant', ['classic', 'hard'])
def test_get_mnist_is_bit_equal(variant):
    for kw in ({}, {'ndim': 3}, {'withlabel': False}):
        got = mnist.get_mnist(variant=variant, **kw)
        want = jmnist.get_mnist(variant=variant, **kw)
        for g, w in zip(got, want):
            assert len(g) == len(w)
            for i in (0, 1, len(w) - 1):
                for a, b in zip(*((g[i], w[i]) if 'withlabel' not in kw
                                  else ((g[i],), (w[i],)))):
                    assert np.asarray(a).dtype == np.asarray(b).dtype
                    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match='variant'):
        mnist.get_mnist(variant='nope')


def test_get_mnist_reads_the_real_data_file(tmp_path, monkeypatch):
    rng = np.random.RandomState(3)
    path = tmp_path / 'mnist.npz'
    np.savez(path, x_train=rng.randint(0, 256, (12, 28, 28)),
             y_train=rng.randint(0, 10, 12), x_test=rng.randint(
                 0, 256, (5, 28, 28)), y_test=rng.randint(0, 10, 5))
    monkeypatch.setenv('CHAINERMN_TPU_MNIST', str(path))
    for g, w in zip(mnist.get_mnist(variant='hard'),
                    jmnist.get_mnist(variant='hard')):
        assert len(g) == len(w)
        for i in range(len(w)):
            for a, b in zip(g[i], w[i]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------
# the model

def _jax_mlp(n_units=100, dtype=None):
    jm = JaxMLP(n_units=n_units, n_out=10, dtype=dtype)
    params = jax.device_get(jm.init(jax.random.PRNGKey(0),
                                    jnp.zeros((1, 784), jnp.float32)))
    return jm, params


def _batch(n=16, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 1, 28, 28).astype(np.float32),
            rng.randint(0, 10, n).astype(np.int32))


@pytest.mark.parametrize('smoothing', [0.0, 0.1])
def test_mlp_and_classifier_match_jax(smoothing):
    jm, variables = _jax_mlp()
    model = models.MLP(n_units=100, device='cpu')
    models.load_flax_variables(model, variables)
    x, y = _batch()
    logits = model(torch.from_numpy(x))
    want = jm.apply(variables, x)
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=RTOL,
                               atol=ATOL)
    clf = models.Classifier(model, label_smoothing=smoothing)
    jloss = chainermn_tpu.models.classifier_loss(jm.apply, smoothing)

    def jfn(p):
        return jloss({'params': p}, x, y)

    (jl, jmetrics), jgrads = jax.value_and_grad(jfn, has_aux=True)(
        variables['params'])
    loss, metrics = clf(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=RTOL,
                               atol=ATOL)
    assert float(metrics['accuracy']) == float(jmetrics['accuracy'])
    got = models.to_flax_variables(
        _grads_as_module(model))['params']
    for layer in ('Dense_0', 'Dense_1', 'Dense_2'):
        for leaf in ('kernel', 'bias'):
            np.testing.assert_allclose(
                got[layer][leaf], np.asarray(jgrads[layer][leaf]),
                rtol=RTOL, atol=ATOL, err_msg='%s/%s' % (layer, leaf))
    # per-example eval metrics (no smoothing) against the JAX ones
    ev = clf.eval_metrics(torch.from_numpy(x), torch.from_numpy(y))
    jev = JaxClassifier(jm.apply).eval_metrics(variables, x, y)
    np.testing.assert_allclose(ev['loss'].numpy(), jev['loss'], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_array_equal(ev['accuracy'].numpy(), jev['accuracy'])


def _grads_as_module(model):
    """A copy of ``model`` whose parameters hold its gradients."""
    twin = models.MLP(n_units=model.Dense_0.out_features, device='cpu')
    with torch.no_grad():
        for p, q in zip(twin.parameters(), model.parameters()):
            p.copy_(q.grad)
    return twin


def test_flax_weights_round_trip():
    _, variables = _jax_mlp()
    model = models.MLP(n_units=100, device='cpu')
    models.load_flax_variables(model, variables)
    back = models.to_flax_variables(model)
    assert back['batch_stats'] == {}
    for layer, leaves in variables['params'].items():
        for leaf, value in leaves.items():
            np.testing.assert_array_equal(back['params'][layer][leaf], value)


def test_mlp_computes_in_its_dtype():
    jm, variables = _jax_mlp(dtype=jnp.bfloat16)
    model = models.MLP(n_units=100, dtype=torch.bfloat16, device='cpu')
    models.load_flax_variables(model, variables)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    x, _ = _batch()
    out = model(torch.from_numpy(x))
    assert out.dtype == torch.bfloat16
    want = np.asarray(jm.apply(variables, x), np.float32)
    # bf16 operands and outputs: a few units in the last place of 2^-8
    np.testing.assert_allclose(out.detach().float().numpy(), want,
                               rtol=2e-2, atol=2e-2)


class _AuxHeads(torch.nn.Module):
    """Returns ``(logits, (aux, None))`` in train mode, as GoogLeNet's
    auxiliary heads do."""

    def __init__(self, logits, aux):
        super().__init__()
        self.logits = torch.nn.Parameter(torch.from_numpy(logits))
        self.aux = torch.nn.Parameter(torch.from_numpy(aux))

    def forward(self, x):
        if self.training:
            return self.logits * 1.0, (self.aux * 1.0, None)
        return self.logits * 1.0


def test_stateful_classifier_weights_auxiliary_heads():
    rng = np.random.RandomState(4)
    logits = rng.randn(6, 10).astype(np.float32)
    aux = rng.randn(6, 10).astype(np.float32)
    y = rng.randint(0, 10, 6).astype(np.int32)
    clf = models.StatefulClassifier(_AuxHeads(logits, aux), aux_weight=0.3)
    loss, metrics = clf.loss(torch.zeros(6), torch.from_numpy(y))
    ce = optax.softmax_cross_entropy_with_integer_labels
    want = ce(logits, y).mean() + 0.3 * ce(aux, y).mean()
    np.testing.assert_allclose(float(loss.detach()), float(want),
                               rtol=RTOL, atol=ATOL)
    assert float(metrics['accuracy']) == float(
        np.mean(logits.argmax(-1) == y))
    ev = clf.eval_metrics(torch.zeros(6), torch.from_numpy(y))
    np.testing.assert_allclose(ev['loss'].numpy(), ce(logits, y),
                               rtol=RTOL, atol=ATOL)
    # classifier_loss takes the logits of a model returning a tuple
    plain, _ = models.classifier_loss(clf.model)(torch.zeros(6),
                                                 torch.from_numpy(y))
    np.testing.assert_allclose(float(plain.detach()),
                               float(ce(logits, y).mean()), rtol=RTOL)


def test_mlp_init_is_seeded_and_needs_a_device():
    a = models.MLP(n_units=8, device='cpu')
    b = models.MLP(n_units=8, device='cpu')
    for p, q in zip(a.parameters(), b.parameters()):
        assert torch.equal(p, q)
    assert not a.Dense_1.bias.detach().any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='CUDA'):
            models.MLP()


# ---------------------------------------------------------------------
# the trajectory: a broadcast call and 3 momentum-SGD steps

def test_momentum_sgd_trajectory_matches_optax():
    jm, variables = _jax_mlp()
    train, _ = jmnist.get_mnist(variant='hard')
    jcomm = chainermn_tpu.create_communicator('naive')   # the 8 devices
    jclf = JaxClassifier(jm.apply)
    jup = jtraining.StandardUpdater(
        jtraining.SerialIterator(train, 104, shuffle=False),
        chainermn_tpu.create_multi_node_optimizer(
            optax.sgd(0.1, momentum=0.9), jcomm),
        jclf, variables, jcomm, has_aux=True)
    comm = cmt.create_communicator('naive', device='cpu')
    model = models.MLP(n_units=100, device='cpu')
    models.load_flax_variables(model, variables)
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
    up = training.StandardUpdater(
        training.SerialIterator(mnist.get_mnist(variant='hard')[0], 104,
                                shuffle=False), opt,
        models.Classifier(model), model, comm)
    losses = []
    for step in range(4):
        got, want = up.update(), jup.update()
        losses.append(got['loss'])
        np.testing.assert_allclose(got['loss'], want['loss'], rtol=RTOL,
                                   atol=ATOL)
        assert got['accuracy'] == pytest.approx(want['accuracy'])
        params = models.to_flax_variables(model)['params']
        jparams = jax.device_get(jup.params)['params']
        for layer, leaves in params.items():
            for leaf, value in leaves.items():
                np.testing.assert_allclose(
                    value, np.asarray(jparams[layer][leaf]), rtol=RTOL,
                    atol=ATOL, err_msg='%s/%s step %d' % (layer, leaf, step))
    # the first call broadcasts instead of stepping: the same batch
    # again gives the same loss; the steps then move it
    assert losses[0] != losses[2] and len(set(losses[1:])) == 3
    assert opt.needs_broadcast is False


# ---------------------------------------------------------------------
# the convergence gate on spawned gloo ranks

_GATE = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import models, ops, training
from chainermn_tpu_torch.datasets import mnist

torch.set_num_threads(1)
store, rank, world, out, n_units, sabotage = (
    sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
    int(sys.argv[5]), sys.argv[6] == '1')
dist.init_process_group('gloo', store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
comm = cmt.create_communicator('naive', device='cpu')
if sabotage:
    # the classic missing-1/size bug: the gradient "mean" is a sum
    def summed(tensors):
        for t in tensors:
            dist.all_reduce(t)
        return tensors
    comm._allreduce_impl = summed
model = models.MLP(n_units=n_units, device='cpu')
clf = models.Classifier(model)
opt = cmt.create_multi_node_optimizer(
    ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
train, test = mnist.get_mnist(variant='hard')
train = cmt.scatter_dataset(train, comm)
test = cmt.scatter_dataset(test, comm)
batch = 104 // world
updater = training.StandardUpdater(
    training.SerialIterator(train, batch), opt, clf, model, comm)
trainer = training.Trainer(updater, (5, 'epoch'), out=out + '.d')
trainer.extend(cmt.create_multi_node_evaluator(training.Evaluator(
    training.SerialIterator(test, batch, repeat=False, shuffle=False),
    clf.eval_metrics, comm), comm))
log = training.extensions.LogReport(rank0_only=False)
trainer.extend(log)
trainer.run()
with open(out, 'w') as f:
    json.dump({'epoch': updater.epoch, 'entries': len(log.log),
               'accuracy': trainer.observation['validation/main/accuracy'],
               'iteration': updater.iteration}, f)
dist.destroy_process_group()
'''


def _run_gate(tmp_path, world, n_units=100, sabotage=False):
    """One full trainer run per rank; returns each rank's result."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    outs = [tmp_path / ('rank%d.json' % r) for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, '-c', _GATE, str(tmp_path / 'store'), str(r),
         str(world), str(outs[r]), str(n_units), '1' if sabotage else '0'],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log.decode()[-3000:]
    results = [json.loads(o.read_text()) for o in outs]
    # the evaluator's mean is the same number on every rank
    assert len({r['accuracy'] for r in results}) == 1
    return results


@pytest.mark.parametrize('world', [1, 2])
def test_mnist_convergence(tmp_path, world):
    results = _run_gate(tmp_path, world)
    for r in results:
        assert r['epoch'] == 5 and r['entries'] == 5
    acc = results[0]['accuracy']
    print('convergence gate, %d gloo rank(s): %.4f' % (world, acc))
    assert acc >= 0.95, 'validation accuracy %.4f < 0.95' % acc


@pytest.mark.slow
def test_gate_fails_on_broken_gradient_mean(tmp_path):
    """A sum in place of the gradient mean must fail the gate: on 8
    ranks (the reference's (2, 4) mesh), since on one a sum is the
    mean."""
    acc = _run_gate(tmp_path, 8, sabotage=True)[0]['accuracy']
    print('sum in place of the mean, 8 ranks: %.4f' % acc)
    assert acc < 0.95, ('gate PASSED (%.4f) despite a sum-instead-of-mean '
                        'allreduce: the bar has no teeth' % acc)


@pytest.mark.slow
def test_gate_fails_on_crippled_model(tmp_path):
    """The task is not linearly separable: a 2-unit MLP must fail."""
    acc = _run_gate(tmp_path, 8, n_units=2)[0]['accuracy']
    print('2-unit model, 8 ranks: %.4f' % acc)
    assert acc < 0.95, ('gate PASSED (%.4f) with a 2-hidden-unit model'
                        % acc)


# ---------------------------------------------------------------------
# the example script

def test_example_quick_runs_snapshots_and_resumes(tmp_path, capsys):
    out = tmp_path / 'a'
    trainer = train_mnist.main(['--quick', '--device', 'cpu',
                                '--communicator', 'naive', '--unit', '50',
                                '--out', str(out)])
    trainer.updater.comm.close()
    log = json.loads((out / 'log').read_text())
    assert [e['epoch'] for e in log] == [1, 2]
    assert 'validation/main/accuracy' in log[-1]
    assert log[-1]['loss'] < log[0]['loss']
    snaps = sorted(out.glob('snapshot_iter_*.npz'))
    assert [s.name for s in snaps] == ['snapshot_iter_10.npz',
                                       'snapshot_iter_5.npz']
    assert 'validation/main/accuracy' in capsys.readouterr().out
    # resume from the first epoch's snapshot: epoch 2 comes out the same
    resumed = train_mnist.main([
        '--quick', '--device', 'cpu', '--communicator', 'naive', '--unit',
        '50', '--out', str(tmp_path / 'b'), '--resume', str(snaps[1])])
    resumed.updater.comm.close()
    assert resumed.updater.iteration == trainer.updater.iteration == 10
    assert resumed.observation['loss'] == trainer.observation['loss']
    # --policy bf16 (ported): bf16 compute and batches, f32 masters
    bf16 = train_mnist.main([
        '--quick', '--device', 'cpu', '--communicator', 'naive', '--unit',
        '50', '--out', str(tmp_path / 'c'), '--policy', 'bf16'])
    bf16.updater.comm.close()
    assert bf16.updater.policy == cmt.Policy.bf16()
    assert bf16.updater.model.dtype == torch.bfloat16
    assert {p.dtype for p in bf16.updater.model.parameters()} == {
        torch.float32}
    np.testing.assert_allclose(bf16.observation['loss'],
                               trainer.observation['loss'], rtol=5e-2,
                               atol=5e-3)


_RESUME = r'''
import sys
import torch
torch.set_num_threads(2)
from chainermn_tpu_torch.examples.mnist import train_mnist
train_mnist.main(sys.argv[1:]).updater.comm.close()
'''


def test_resume_continues_bit_for_bit(tmp_path):
    """2 epochs and a snapshot; a fresh process resumes and runs a third;
    against 3 epochs straight: the same parameters, optimizer state and
    counters, bit for bit (the shuffled order included)."""
    common = ['--device', 'cpu', '--communicator', 'naive', '--unit', '32']
    train_mnist.main(common + ['--epoch', '2', '--out', str(tmp_path / 'a')]
                     ).updater.comm.close()
    straight = train_mnist.main(common + ['--epoch', '3', '--out',
                                          str(tmp_path / 'c')])
    straight.updater.comm.close()
    snap = tmp_path / 'a' / 'snapshot_iter_120.npz'
    env = dict(os.environ, PYTHONPATH=str(REPO))
    run = subprocess.run(
        [sys.executable, '-c', _RESUME] + common + [
            '--epoch', '3', '--out', str(tmp_path / 'b'), '--resume',
            str(snap)], env=env, capture_output=True, text=True,
        timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    n = straight.updater.iteration
    assert n == 180
    got, _ = cmt.serializers.read_npz(
        str(tmp_path / 'b' / ('snapshot_iter_%d.npz' % n)))
    want, _ = cmt.serializers.read_npz(
        str(tmp_path / 'c' / ('snapshot_iter_%d.npz' % n)))
    assert sorted(got) == sorted(want)
    assert any(k.startswith('opt_state/actual_state/') for k in want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    log_b = json.loads((tmp_path / 'b' / 'log').read_text())
    log_c = json.loads((tmp_path / 'c' / 'log').read_text())
    assert log_b[-1]['loss'] == log_c[-1]['loss']
    assert (log_b[-1]['validation/main/accuracy']
            == log_c[-1]['validation/main/accuracy'])
