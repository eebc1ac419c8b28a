"""The port's evaluator and multi-node evaluator against the JAX package.

The ``Evaluator`` over the hard stand-in's 1000-example test set at a
batch of 104 (the last batch holds 64) against the JAX ``Evaluator``
for the same weights; the object collectives; and
``create_multi_node_evaluator`` on two gloo ranks spawned as processes.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chainermn_tpu
import chainermn_tpu_torch as cmt
from chainermn_tpu import training as jtraining
from chainermn_tpu.datasets import mnist as jmnist
from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu.models import Classifier as JaxClassifier
from chainermn_tpu_torch import models, training
from chainermn_tpu_torch.datasets import mnist

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent


def _weights():
    jm = JaxMLP(n_units=100, n_out=10)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(1),
                                       jnp.zeros((1, 784), jnp.float32)))
    return jm, variables


def _port_model(variables):
    model = models.MLP(n_units=100, device='cpu')
    models.load_flax_variables(model, variables)
    return model


def test_evaluator_matches_jax_with_a_partial_last_batch():
    jm, variables = _weights()
    _, test = jmnist.get_mnist(variant='hard')
    assert len(test) % 104 == 64
    jcomm = chainermn_tpu.create_communicator('naive')   # the 8 devices
    want = jtraining.Evaluator(
        jtraining.SerialIterator(test, 104, repeat=False, shuffle=False),
        JaxClassifier(jm.apply).eval_metrics, lambda: variables,
        jcomm).evaluate()
    comm = cmt.create_communicator('naive', device='cpu')
    clf = models.Classifier(_port_model(variables))
    ev = training.Evaluator(
        training.SerialIterator(mnist.get_mnist(variant='hard')[1], 104,
                                repeat=False, shuffle=False),
        clf.eval_metrics, comm)
    got = ev.evaluate()
    assert sorted(got) == ['validation/main/accuracy', 'validation/main/loss']
    for key, value in want.items():
        assert isinstance(got[key], float)
        np.testing.assert_allclose(got[key], value, rtol=1e-5, err_msg=key)
    # a second evaluation resets the iterator and gives the same result
    assert ev() == got
    assert (ev.trigger, ev.priority, ev.name) == ((1, 'epoch'), 300,
                                                  'validation')


def test_evaluator_weights_batch_means_by_their_count():
    _, variables = _weights()
    comm = cmt.create_communicator('naive', device='cpu')
    clf = models.Classifier(_port_model(variables))
    _, test = mnist.get_mnist(variant='hard')

    def means(x, y):
        return {k: v.mean() for k, v in clf.eval_metrics(x, y).items()}

    def evaluate(fn):
        return training.Evaluator(
            training.SerialIterator(test, 104, repeat=False, shuffle=False),
            fn, comm, prefix='v/').evaluate()

    per_example, per_batch = evaluate(clf.eval_metrics), evaluate(means)
    for key in per_example:
        np.testing.assert_allclose(per_batch[key], per_example[key],
                                   rtol=1e-6)
    empty = training.Evaluator(training.SerialIterator(
        [], 4, repeat=False), clf.eval_metrics, comm)
    assert empty.evaluate() == {}


def test_object_collectives_world_of_one():
    comm = cmt.create_communicator('naive', device='cpu')
    for value in (3, 2.5, np.float32(0.25), torch.tensor(1.5)):
        out = comm.allreduce_obj(value)
        assert isinstance(out, float) and out == float(value)
    assert comm.allreduce_obj(4, op='max') == 4.0
    with pytest.raises(ValueError):
        comm.allreduce_obj(1.0, op='prod')
    assert comm.bcast_obj({'a': [1, 2]}) == {'a': [1, 2]}
    for call in (lambda: comm.send_obj(1, 0), lambda: comm.recv_obj(0),
                 lambda: comm.barrier(timeout=1.0)):
        with pytest.raises(NotImplementedError, match='A1'):
            call()


def test_multi_node_evaluator_forwards_attributes():
    comm = cmt.create_communicator('naive', device='cpu')
    calls = []

    def fn():
        calls.append(1)
        return {'b': 2, 'a': np.float64(1.0)}

    fn.trigger = (2, 'epoch')
    wrapped = cmt.create_multi_node_evaluator(fn, comm)
    assert wrapped() == {'a': 1.0, 'b': 2.0}
    assert list(wrapped.evaluate()) == ['a', 'b']   # sorted
    assert wrapped.trigger == (2, 'epoch') and len(calls) == 2


_TWO_RANKS = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import models, training
from chainermn_tpu_torch.datasets import mnist
from chainermn_tpu_torch.examples.mnist import train_mnist

torch.set_num_threads(1)
store, rank, out, weights = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
dist.init_process_group('gloo', store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
comm = cmt.create_communicator('naive', device='cpu')
result = {}


class Local:
    """Different local metrics on each rank."""
    priority = 7

    def evaluate(self):
        return {'b/acc': 0.5 + rank, 'a/loss': np.float32(2.0 * (rank + 1))}


result['fake'] = cmt.create_multi_node_evaluator(Local(), comm)()
result['priority'] = cmt.create_multi_node_evaluator(Local(), comm).priority
# the real evaluator over this rank's half of the test set
with np.load(weights) as w:
    variables = {'params': {k: {'kernel': w[k + '/kernel'],
                                'bias': w[k + '/bias']}
                            for k in ('Dense_0', 'Dense_1', 'Dense_2')}}
model = models.MLP(n_units=100, device='cpu')
models.load_flax_variables(model, variables)
clf = models.Classifier(model)
_, test = mnist.get_mnist(variant='hard')
shard = cmt.scatter_dataset(test, comm)
result['real'] = cmt.create_multi_node_evaluator(training.Evaluator(
    training.SerialIterator(shard, 52, repeat=False, shuffle=False),
    clf.eval_metrics, comm), comm)()
result['bcast'] = comm.bcast_obj({'from': rank, 'x': [1, 2]})
result['sum'] = comm.allreduce_obj(rank + 1, op='sum')
try:
    train_mnist.main(['--device', 'cpu', '--batchsize', '101'])
    result['indivisible'] = 'ran'
except ValueError as e:
    result['indivisible'] = str(e)
with open(out, 'w') as f:
    json.dump(result, f)
dist.destroy_process_group()
'''


def test_two_rank_multi_node_evaluator(tmp_path):
    jm, variables = _weights()
    flat = {'%s/%s' % (layer, leaf): v
            for layer, leaves in variables['params'].items()
            for leaf, v in leaves.items()}
    np.savez(tmp_path / 'w.npz', **flat)
    env = dict(os.environ, PYTHONPATH=str(REPO))
    outs = [tmp_path / ('r%d.json' % r) for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, '-c', _TWO_RANKS, str(tmp_path / 'store'), str(r),
         str(outs[r]), str(tmp_path / 'w.npz')], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log.decode()[-3000:]
    results = [json.loads(o.read_text()) for o in outs]
    # the key-by-key mean, the same on both ranks
    for r in results:
        assert r['fake'] == {'a/loss': 3.0, 'b/acc': 1.0}
        assert r['priority'] == 7
        assert r['bcast'] == {'from': 0, 'x': [1, 2]}
        assert r['sum'] == 3.0
        assert 'does not divide over 2' in r['indivisible']
    assert results[0]['real'] == results[1]['real']
    # two halves of 500: their mean is the whole set's mean
    comm = cmt.create_communicator('naive', device='cpu')
    clf = models.Classifier(_port_model(variables))
    whole = training.Evaluator(
        training.SerialIterator(mnist.get_mnist(variant='hard')[1], 104,
                                repeat=False, shuffle=False),
        clf.eval_metrics, comm).evaluate()
    for key, value in whole.items():
        np.testing.assert_allclose(results[0]['real'][key], value,
                                   rtol=1e-6, err_msg=key)
