"""The port's ``MultiNodeChainList`` against the JAX one.

The cycle, crossing and branching topologies of ``tests/test_link.py``
(the reference's ``tests/test_link.py``), from the same ``jax.random``
weights: outputs (rtol 1e-5) and every stage's gradient (rtol 1e-4)
against the JAX container in host mode and in ``spmd=True`` mode.  The
port runs in gloo processes: in a world of one, on 2 ranks (cycle,
crossing) and on 5 (branching), in host mode and in its process-program
``spmd`` mode, where each stage runs on its home rank only and its
gradient arrives there.  Every process has a timeout, so a deadlock in
the backward fails the test.
"""

import os
import pickle
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

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
WIDTH = 6
# the worlds and the topologies each runs
WORLDS = {1: ('cycle', 'crossing', 'branching'), 2: ('cycle', 'crossing'),
          5: ('branching',)}

# stages: (rank_in, rank_out, rank) of tests/test_link.py
TOPOLOGIES = {
    'cycle': [(None, 1, 0), (0, 0, 1), (1, None, 0)],
    'crossing': [(None, 1, 0), (None, 0, 1), (1, None, 0), (0, None, 1)],
    'branching': [(None, [1, 2, 3], 0), (0, 4, 1), (0, 4, 2), (0, 4, 3),
                  ([1, 2, 3], None, 4)],
}


def _dense(key, n_in, n_out):
    k1, k2 = jax.random.split(jax.random.PRNGKey(key))
    return {'w': jax.random.normal(k1, (n_in, n_out)) * 0.3,
            'b': jax.random.normal(k2, (n_out,)) * 0.1}


def _apply(p, x):
    return jnp.tanh(x @ p['w'] + p['b'])


def _jax_model(comm, topology, spmd):
    m = chainermn_tpu.MultiNodeChainList(comm, spmd=spmd)
    for rank_in, rank_out, rank in TOPOLOGIES[topology]:
        link = _apply
        if isinstance(rank_in, list):
            def link(p, a, b, c):
                return _apply(p, a + b + c)
        m.add_link(link, rank_in=rank_in, rank_out=rank_out, rank=rank)
    return m


def _jax_results(topology, spmd):
    comm = chainermn_tpu.create_communicator('xla', mesh_shape=(1, 8))
    m = _jax_model(comm, topology, spmd)
    params = [_dense(i, WIDTH, WIDTH)
              for i in range(len(TOPOLOGIES[topology]))]
    x = jax.random.normal(jax.random.PRNGKey(7), (4, WIDTH))

    def loss(ps):
        return sum(jnp.sum(leaf ** 2)
                   for leaf in jax.tree_util.tree_leaves(m(ps, x)))

    out = jax.jit(lambda ps: m(ps, x))(params)
    grads = jax.jit(jax.grad(loss))(params)
    return dict(
        params=[{k: np.asarray(v) for k, v in p.items()} for p in params],
        x=np.asarray(x),
        out=[np.asarray(o) for o in jax.tree_util.tree_leaves(out)],
        grads=[{k: np.asarray(v) for k, v in g.items()} for g in grads])


_RANK_SCRIPT = r'''
import pickle
import sys
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt

torch.set_num_threads(1)
store, rank, world, inp, out = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4], sys.argv[5])
dist.init_process_group('gloo', store=dist.FileStore(store, world),
                        rank=rank, world_size=world)
comm = cmt.create_communicator('xla', device='cpu')
with open(inp, 'rb') as f:
    cases = pickle.load(f)


class Dense(torch.nn.Module):
    def __init__(self, p):
        super().__init__()
        self.w = torch.nn.Parameter(torch.from_numpy(p['w']))
        self.b = torch.nn.Parameter(torch.from_numpy(p['b']))

    def forward(self, *xs):
        return torch.tanh(sum(xs) @ self.w + self.b)


res = {}
for (topology, mode), case in cases.items():
    m = cmt.MultiNodeChainList(comm, spmd=mode == 'spmd')
    stages = [Dense(p) for p in case['params']]
    for stage, (rank_in, rank_out, r) in zip(stages, case['stages']):
        m.add_link(stage, rank_in=rank_in, rank_out=rank_out, rank=r)
    y = m(torch.from_numpy(case['x']))
    ys = y if isinstance(y, tuple) else (y,)
    sum((t ** 2).sum() for t in ys).backward()
    res[topology, mode] = dict(
        out=[t.detach().numpy() for t in ys],
        grads=[None if s.w.grad is None else
               {'w': s.w.grad.numpy(), 'b': s.b.grad.numpy()}
               for s in stages])

# the two RuntimeErrors, raised on every rank in both modes
dense = Dense(cases[('cycle', 'host')]['params'][0]) \
    if ('cycle', 'host') in cases else Dense(
        next(iter(cases.values()))['params'][0])
x = torch.ones(2, 6)
for mode in ('host', 'spmd'):
    m = cmt.MultiNodeChainList(comm, spmd=mode == 'spmd')
    m.add_link(dense, rank_in=None, rank_out=1 % world, rank=0)
    m.add_link(dense, rank_in=None, rank_out=None, rank=1 % world)
    try:
        m(x)
    except RuntimeError as e:
        res['unconsumed', mode] = str(e)
    m = cmt.MultiNodeChainList(comm, spmd=mode == 'spmd')
    m.add_link(dense, rank_in=5, rank_out=None, rank=0)
    try:
        m(x)
    except RuntimeError as e:
        res['missing', mode] = str(e)
with open(out, 'wb') as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope='module')
def jax_results():
    return {(t, mode): _jax_results(t, mode == 'spmd')
            for t in TOPOLOGIES for mode in ('host', 'spmd')}


@pytest.fixture(scope='module')
def worlds(tmp_path_factory, jax_results):
    """Every world's ranks at once, 8 processes in all; returns
    ``{world: [rank results]}``."""
    tmp = tmp_path_factory.mktemp('link')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = []
    for world, topologies in WORLDS.items():
        cases = {(t, mode): dict(jax_results[t, mode],
                                 stages=TOPOLOGIES[t])
                 for t in topologies for mode in ('host', 'spmd')}
        inp = tmp / ('cases%d.pkl' % world)
        with open(inp, 'wb') as f:
            pickle.dump(cases, f)
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, '-c', _RANK_SCRIPT,
                 str(tmp / ('store%d' % world)), str(r), str(world),
                 str(inp), str(tmp / ('w%d_r%d.pkl' % (world, r)))],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            assert p.returncode == 0, out.decode()
    finally:
        for p in procs:
            p.kill()
    out = {}
    for world in WORLDS:
        out[world] = []
        for r in range(world):
            with open(tmp / ('w%d_r%d.pkl' % (world, r)), 'rb') as f:
                out[world].append(pickle.load(f))
    return out


CASES = [(world, t, mode) for world, ts in WORLDS.items() for t in ts
         for mode in ('host', 'spmd')]


@pytest.mark.parametrize('world,topology,mode', CASES)
def test_topology_matches_jax(worlds, jax_results, world, topology, mode):
    """Outputs on every rank, and each stage's gradient on the rank that
    ran it (every rank in host mode, its home in ``spmd`` mode), against
    the JAX container in the same mode."""
    want = jax_results[topology, mode]
    stages = TOPOLOGIES[topology]
    for rank, res in enumerate(worlds[world]):
        got = res[topology, mode]
        assert len(got['out']) == len(want['out'])
        for a, b in zip(got['out'], want['out']):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        for i, (g, w) in enumerate(zip(got['grads'], want['grads'])):
            home = stages[i][2] % world
            if mode == 'spmd' and home != rank:
                assert g is None, (rank, i)
                continue
            for k in ('w', 'b'):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4,
                                           atol=1e-6)


@pytest.mark.parametrize('world', sorted(WORLDS))
def test_routing_errors_raise_on_every_rank(worlds, world):
    for res in worlds[world]:
        for mode in ('host', 'spmd'):
            assert 'unconsumed' in res['unconsumed', mode]
            assert 'expects input from rank 5' in res['missing', mode]


def test_host_and_spmd_modes_agree_with_jax(jax_results):
    """The JAX container's two modes agree with each other (the port's
    tests above hold each mode to its own)."""
    for t in TOPOLOGIES:
        for a, b in zip(jax_results[t, 'host']['out'],
                        jax_results[t, 'spmd']['out']):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_in_process_errors_and_len():
    with pytest.raises(ValueError):
        cmt.MultiNodeChainList(spmd=True)
    m = cmt.MultiNodeChainList()
    lin = torch.nn.Linear(3, 3)
    m.add_link(lin, rank_in=None, rank_out=1, rank=0)
    m.add_link(lin, rank_in=None, rank_out=None, rank=1)
    assert len(m) == 2
    assert list(dict(m.named_parameters())) == ['link_0.weight',
                                                'link_0.bias']
    with pytest.raises(RuntimeError, match='unconsumed'):
        m(torch.ones(2, 3))
    m = cmt.MultiNodeChainList()
    m.add_link(lambda x: x * 2.0, rank_in=None, rank_out=None)
    np.testing.assert_array_equal(m(torch.ones(2)).numpy(), [2.0, 2.0])
