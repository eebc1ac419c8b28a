"""The training step's loop knobs against the JAX package and against
the port without them.

- ``accum_steps``: against the full batch (SGD is linear in the gradient
  mean) and against the JAX updater with the same ``accum_steps`` on a
  one-device mesh, rtol 1e-5 in f32 (JAX ``test_training.py:313``);
- ``remat``: against no remat on a small BN model, through the fused op
  and its flax oracle -- loss, gradients and running statistics equal
  (the recompute must not update the statistics again) -- and on a model
  with ``Dropout``, whose recompute must replay the forward's masks;
- ``Trainer(async_metrics=True)`` against the sync trainer: the same
  ``LogReport`` entries, 0-d tensors in the observation, and no
  ``float()`` an iteration (JAX ``test_training.py:205``);
- ``double_buffering`` (staleness, convergence, ``bucketed``) and
  ``broadcast_first=False`` against the JAX optimizer and on 2 gloo
  ranks (JAX ``test_multi_node_optimizer.py:100,134,160``); the 2-rank
  run also counts the one collective a communicator runs when it is
  built.
"""

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
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import MLP as JaxMLP, classifier_loss
from chainermn_tpu_torch import models, training
from chainermn_tpu_torch.models._layers import Dense, Dropout
from chainermn_tpu_torch.training import extensions

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-5, atol=1e-6)


def _jax_comm():
    return chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))


# ---------------------------------------------------------------------
# accum_steps

def _accum_data():
    rng = np.random.RandomState(1)
    x = rng.rand(32, 5).astype(np.float32)
    y = (x.sum(axis=1) > 2.5).astype(np.int32)
    return list(zip(x, y))


def _jax_accum(ds, accum):
    model = JaxMLP(n_units=16, n_out=2)
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 5)))['params'])
    comm = _jax_comm()
    opt = chainermn_tpu.create_multi_node_optimizer(optax.sgd(0.1), comm)
    upd = jtraining.StandardUpdater(
        jtraining.SerialIterator(ds, 32, shuffle=False), opt,
        classifier_loss(lambda p, xb: model.apply({'params': p}, xb)),
        params, comm, has_aux=True, accum_steps=accum)
    losses = [upd.update()['loss'] for _ in range(3)]
    return losses, jax.device_get(upd.params), params


def _port_accum(ds, accum, params):
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=16, n_out=2, n_in=5, device='cpu')
    models.load_flax_variables(model, {'params': params})
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    upd = training.StandardUpdater(
        training.SerialIterator(ds, 32, shuffle=False), opt,
        models.Classifier(model), model, comm, accum_steps=accum)
    losses = [upd.update()['loss'] for _ in range(3)]
    return losses, models.to_flax_variables(model)['params']


def _leaves(tree, prefix=''):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + '/')
        else:
            yield prefix + k, np.asarray(v)


def test_gradient_accumulation_matches_full_batch_and_jax():
    ds = _accum_data()
    jlosses, jparams, params = _jax_accum(ds, 2)
    one, p1 = _port_accum(ds, 1, params)
    two, p2 = _port_accum(ds, 2, params)
    four, p4 = _port_accum(ds, 4, params)
    np.testing.assert_allclose(two, one, atol=1e-6)
    np.testing.assert_allclose(four, one, atol=1e-6)
    np.testing.assert_allclose(two, jlosses, **F32)
    want = dict(_leaves(jparams))
    for (k1, a), (k2, b), (k4, c) in zip(_leaves(p1), _leaves(p2),
                                         _leaves(p4)):
        assert k1 == k2 == k4
        np.testing.assert_allclose(b, a, atol=1e-6, err_msg=k1)
        np.testing.assert_allclose(c, a, atol=1e-6, err_msg=k1)
        np.testing.assert_allclose(b, want[k1], **F32, err_msg=k1)


def test_accum_steps_must_divide_the_batch():
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=4, n_in=5, device='cpu')
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    with pytest.raises(ValueError, match='accum_steps'):
        training.StandardUpdater(iter([]), opt, models.Classifier(model),
                                 model, comm, accum_steps=0)
    up = training.StandardUpdater(iter([]), opt, models.Classifier(model),
                                  model, comm, accum_steps=3)
    with pytest.raises(ValueError, match='divisible by accum_steps 3'):
        up.update_core((torch.zeros(8, 5), torch.zeros(8,
                                                       dtype=torch.long)))


def test_accum_threads_the_running_statistics():
    """Two micro-batches update the BN buffers twice, in order: as two
    forwards of the halves, one after the other."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(8, 16, 16, 3).astype(np.float32))
    y = torch.tensor([0, 1, 2, 0, 1, 2, 0, 1])
    got = _bn_model()
    comm = cmt.create_communicator('xla', device='cpu')
    up = training.StandardUpdater(
        iter([]), torch.optim.SGD(got.parameters(), lr=0.1),
        models.StatefulClassifier(got).loss, got, comm, accum_steps=2)
    up.update_core((x, y))
    want = _bn_model()
    with torch.no_grad():
        want.train()
        want(x[:4])
        want(x[4:])
    for (name, a), b in zip(got.named_buffers(), want.buffers()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=name)


# ---------------------------------------------------------------------
# remat

def _bn_model(fused=True):
    return models.ResNet(stage_sizes=[1, 1], width=4, num_classes=3,
                         dtype=torch.float32, fused_norm=fused,
                         device='cpu')


def _run(model, loss, batch, steps, **kw):
    """``steps`` updates through the port (a broadcast call, then SGD
    with momentum); returns the losses, the gradients of the first
    call (left in the parameters by the broadcast call) and the
    buffers after the first call."""
    comm = cmt.create_communicator('xla', device='cpu')
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.05, momentum=0.9), comm)
    up = training.StandardUpdater(iter([]), opt, loss, model, comm, **kw)
    losses = [float(up.update_core(batch)['loss'])]
    grads = [p.grad.clone() for p in model.parameters()]
    buffers = [b.clone() for b in model.buffers()]
    losses += [float(up.update_core(batch)['loss'])
               for _ in range(steps - 1)]
    return losses, grads, buffers


@pytest.mark.parametrize('fused', [True, False])
def test_remat_equals_no_remat_on_a_bn_model(fused):
    rng = np.random.RandomState(3)
    batch = (torch.from_numpy(rng.randn(4, 16, 16, 3).astype(np.float32)),
             torch.tensor([0, 1, 2, 0]))
    out = {}
    for remat in (False, True):
        model = _bn_model(fused)
        out[remat] = (_run(model, models.StatefulClassifier(model).loss,
                           batch, 3, remat=remat), model)
    (l0, g0, b0), m0 = out[False]
    (l1, g1, b1), m1 = out[True]
    assert l1 == l0
    for a, b in zip(g1, g0):
        assert torch.equal(a, b)
    # one update of the running statistics a step, as without remat
    for a, b in zip(b1, b0):
        assert torch.equal(a, b)
    for a, b in zip(list(m1.parameters()) + list(m1.buffers()),
                    list(m0.parameters()) + list(m0.buffers())):
        assert torch.equal(a, b)
    assert not torch.equal(b0[0], torch.zeros_like(b0[0]))


class _DropoutNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(5)
        self.Dense_0 = Dense(6, 32, dtype=torch.float32, generator=g)
        self.dropout = Dropout(0.5)
        self.Dense_1 = Dense(32, 3, dtype=torch.float32, generator=g)

    def loss(self, x, y):
        h = self.dropout(torch.relu(self.Dense_0(x)))
        return torch.nn.functional.cross_entropy(self.Dense_1(h), y), {}


def test_remat_replays_the_dropout_masks():
    rng = np.random.RandomState(4)
    batch = (torch.from_numpy(rng.randn(16, 6).astype(np.float32)),
             torch.from_numpy(rng.randint(0, 3, 16)))
    out = {}
    for remat in (False, True):
        model = _DropoutNet()
        out[remat] = _run(model, model.loss, batch, 3, remat=remat, rng=7)
    assert out[True][0] == out[False][0]
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    # dropout did act: the first loss is not the loss without it
    with torch.no_grad():
        plain = float(_DropoutNet().eval().loss(*batch)[0])
    assert abs(plain - out[False][0][0]) > 1e-3


def test_remat_under_a_policy_and_accumulation():
    """remat, a bf16 policy and two micro-batches together: the same
    trajectory as without remat."""
    rng = np.random.RandomState(6)
    batch = (torch.from_numpy(rng.randn(4, 16, 16, 3).astype(np.float32)),
             torch.tensor([0, 1, 2, 0]))
    runs = []
    for remat in (False, True):
        model = models.ResNet(stage_sizes=[1], width=4, num_classes=3,
                              fused_norm=True, device='cpu')
        runs.append(_run(model, models.StatefulClassifier(model).loss,
                         batch, 3, remat=remat, accum_steps=2,
                         policy=cmt.Policy.bf16()))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][2], runs[1][2]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------
# async metrics

def _small_trainer(async_metrics, n_epoch=4):
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=8, n_in=5, n_out=2, device='cpu')
    opt = cmt.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-2), comm)
    up = training.StandardUpdater(
        training.SerialIterator(_accum_data(), 8, shuffle=False), opt,
        models.Classifier(model), model, comm)
    tr = training.Trainer(up, (n_epoch, 'epoch'), out=None,
                          async_metrics=async_metrics, sync_interval=8)
    log = extensions.LogReport()
    tr.extend(log)
    return tr, log


def test_async_metrics_trainer_matches_sync(monkeypatch):
    tr, log = _small_trainer(False)
    tr.run()
    tr2, log2 = _small_trainer(True)
    kinds = []
    tr2.extend(lambda t: kinds.append(
        (torch.is_tensor(t.observation['loss']),
         getattr(t.observation['loss'], 'ndim', None))),
        trigger=(1, 'iteration'), name='probe', priority=500)
    reads = []
    to_float = torch.Tensor.__float__

    def counted(self):
        reads.append(tr2.updater.iteration)
        return to_float(self)

    monkeypatch.setattr(torch.Tensor, '__float__', counted)
    tr2.run()
    monkeypatch.undo()
    iterations = tr2.updater.iteration
    assert iterations == 16 and kinds == [(True, 0)] * 16
    # LogReport reads its two keys at its 4 emits, the trainer one
    # scalar every 8 iterations: no read an iteration
    assert len(reads) == 2 * 4 + iterations // 8
    assert len(log.log) == len(log2.log) == 4
    for a, b in zip(log.log, log2.log):
        assert a['loss'] == b['loss'] and a['accuracy'] == b['accuracy']
        assert a['iteration'] == b['iteration']


def test_nan_guard_reads_tensor_metrics_at_its_audit():
    from chainermn_tpu_torch.utils import DivergenceError, NanGuard

    class Trainer:
        observation = {'loss': torch.tensor(float('nan'))}

        class updater:
            iteration = 3
            params = {'w': np.ones(2, np.float32)}

    guard = NanGuard(param_interval=4)
    guard(Trainer)                  # not an audit iteration: no read
    Trainer.updater.iteration = 4
    with pytest.raises(DivergenceError, match='loss'):
        guard(Trainer)


# ---------------------------------------------------------------------
# double buffering, broadcast_first

def _jax_double_buffering(grads, broadcast_first=True):
    """The JAX optimizer on a one-device mesh: ``w`` starts at zeros(2),
    step t's gradient is ``full(2, grads[t])``; returns w[0] after each
    step."""
    comm = _jax_comm()
    opt = chainermn_tpu.create_multi_node_optimizer(
        optax.sgd(1.0), comm, double_buffering=True,
        broadcast_first=broadcast_first)

    def steps():
        params = {'w': jnp.zeros((2,))}
        state = opt.init(params)
        history = []
        for g in grads:
            updates, state = opt.update({'w': jnp.full((2,), g)}, state,
                                        params)
            params = optax.apply_updates(params, updates)
            history.append(params['w'][0])
        return jnp.stack(history)

    return np.asarray(jax.jit(jax.shard_map(
        steps, mesh=comm.mesh, in_specs=(), out_specs=P(),
        check_vma=False))())


def _port_double_buffering(grads, broadcast_first=True, momentum=0.0):
    comm = cmt.create_communicator('xla', device='cpu')
    w = torch.nn.Parameter(torch.zeros(2))
    inner = torch.optim.SGD([w], lr=1.0, momentum=momentum)
    opt = cmt.create_multi_node_optimizer(
        inner, comm, double_buffering=True, broadcast_first=broadcast_first)
    history, states = [], []
    for g in grads:
        opt.zero_grad(set_to_none=True)
        w.grad = torch.full((2,), float(g))
        opt.step()
        history.append(float(w.detach()[0]))
        states.append(len(inner.state))
    return np.asarray(history, np.float32), states


@pytest.mark.parametrize('broadcast_first', [True, False])
def test_double_buffering_staleness_matches_jax(broadcast_first):
    grads = [1.0, 2.0, 3.0, 4.0]
    got, states = _port_double_buffering(grads, broadcast_first)
    want = _jax_double_buffering(grads, broadcast_first)
    np.testing.assert_array_equal(got, want)
    if broadcast_first:
        # broadcast, fill (no update), then step t applies t - 1's
        np.testing.assert_array_equal(got, [0, 0, -2, -5])
    else:
        np.testing.assert_array_equal(got, [0, -1, -3, -6])


def test_double_buffering_fill_step_leaves_the_optimizer_alone():
    _, states = _port_double_buffering([1.0, 2.0, 3.0], momentum=0.9)
    assert states == [0, 0, 1]   # no momentum buffer until step 2


def test_double_buffering_converges():
    """A staleness-1 trajectory still converges at a stable step size."""
    comm = cmt.create_communicator('xla', device='cpu')
    target = torch.linspace(-2.0, 2.0, 8)
    w = torch.nn.Parameter(torch.zeros(8))
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD([w], lr=0.1), comm, double_buffering=True)
    for _ in range(80):
        opt.zero_grad(set_to_none=True)
        ((w - target) ** 2).sum().backward()
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), target.numpy(),
                               atol=1e-2)


def test_broadcast_first_false_steps_at_once():
    comm = cmt.create_communicator('xla', device='cpu')
    w = torch.nn.Parameter(torch.ones(3))
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD([w], lr=0.5), comm, broadcast_first=False)
    assert not opt.needs_broadcast
    w.sum().backward()
    opt.step()
    np.testing.assert_array_equal(w.detach().numpy(), [0.5] * 3)


def test_communicator_runs_one_collective_when_built(monkeypatch):
    calls = []
    real = dist.all_reduce
    monkeypatch.setattr(dist, 'all_reduce', lambda t, *a, **kw: (
        calls.append(tuple(t.shape)), real(t, *a, **kw))[1])
    cmt.create_communicator('xla', device='cpu')
    assert calls == [(1,)]


_RANK_SCRIPT = r'''
import sys
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt

torch.set_num_threads(1)
store_path, rank, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group('gloo', store=dist.FileStore(store_path, 2),
                        rank=rank, world_size=2)
log = []
for name in ('all_reduce', 'broadcast', 'batch_isend_irecv', 'send',
             'recv', 'barrier', 'all_gather', 'reduce_scatter_tensor'):
    real = getattr(dist, name)
    setattr(dist, name, (lambda n, f: lambda *a, **kw: (
        log.append(n), f(*a, **kw))[1])(name, real))
comms = {name: cmt.create_communicator(name, device='cpu')
         for name in ('xla', 'bucketed')}
built = list(log)
# staleness: w starts at the rank, step t's gradient is r + 1 + t
out = {'built': np.array(built)}
for name, comm in comms.items():
    w = torch.nn.Parameter(torch.full((2,), float(rank)))
    b = torch.nn.Parameter(torch.full((3,), -float(rank)))
    opt = cmt.create_multi_node_optimizer(torch.optim.SGD([w, b], lr=1.0),
                                          comm, double_buffering=True)
    history = []
    for t in range(4):
        opt.zero_grad(set_to_none=True)
        w.grad = torch.full((2,), rank + 1.0 + t)
        b.grad = torch.full((3,), 0.5 * (rank + t))
        opt.step()
        history.append(torch.cat([w.detach(), b.detach()]).numpy().copy())
    out[name] = np.stack(history)
# convergence on a quadratic whose target differs by rank
comm = comms['xla']
target = torch.linspace(-2.0, 2.0, 8) + rank
w = torch.nn.Parameter(torch.zeros(8))
opt = cmt.create_multi_node_optimizer(torch.optim.SGD([w], lr=0.1), comm,
                                      double_buffering=True)
for _ in range(80):
    opt.zero_grad(set_to_none=True)
    ((w - target) ** 2).sum().backward()
    opt.step()
out['converged'] = w.detach().numpy()
np.savez(out_path, **out)
dist.destroy_process_group()
'''


@pytest.fixture(scope='module')
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('ranks')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK_SCRIPT, str(tmp / 'store'), str(r),
         str(tmp / ('r%d.npz' % r))], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)   # a hang fails here
            assert p.returncode == 0, out.decode()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [np.load(tmp / ('r%d.npz' % r)) for r in range(2)]


def test_two_ranks_first_collective_is_the_communicators(two_ranks):
    """Each communicator, as it is built, runs one all_reduce over the
    default group before anything else: no later point-to-point call
    can be the group's first."""
    for got in two_ranks:
        assert list(got['built']) == ['all_reduce', 'all_reduce']


def test_two_ranks_double_buffering_staleness(two_ranks):
    # mean over ranks of r + 1 + t is 1.5 + t; of 0.5 (r + t), 0.25 + t / 2
    w = [0.0, 0.0, -2.5, -6.0]
    b = [0.0, 0.0, -0.75, -2.0]
    for got in two_ranks:
        np.testing.assert_allclose(got['xla'][:, 0], w, rtol=1e-6)
        np.testing.assert_allclose(got['xla'][:, 2], b, rtol=1e-6)


def test_two_ranks_double_buffering_composes_with_bucketed(two_ranks):
    for got in two_ranks:
        np.testing.assert_allclose(got['bucketed'], got['xla'], rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_array_equal(two_ranks[0]['bucketed'],
                                  two_ranks[1]['bucketed'])


def test_two_ranks_double_buffering_converges(two_ranks):
    # the mean of the two ranks' targets
    want = np.linspace(-2.0, 2.0, 8) + 0.5
    for got in two_ranks:
        np.testing.assert_allclose(got['converged'], want, atol=1e-2)
