"""The port's eager object channel: ``send_obj`` / ``recv_obj``,
``barrier(timeout)``, ``p2p_gc`` and ``allreduce_obj(timeout=)`` over
the default group's c10d store, with the semantics of
``chainermn_tpu/communicators/base.py:454-830``, on two gloo processes
(and in a world of one); and the bounded-wait arithmetic
(``Deadline``, ``Backoff``) against the JAX package's.
"""

import os
import pickle
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import chainermn_tpu_torch as cmt
from chainermn_tpu.utils import failure as jfailure
from chainermn_tpu_torch.utils import failure

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
RECV_TIMEOUT = 1.0
BARRIER_TIMEOUT = 1.0

_RANK_SCRIPT = r'''
import pickle
import sys
import time
import numpy as np
import torch
import torch.distributed as dist
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch.utils import ChannelTimeout

torch.set_num_threads(1)
store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
recv_timeout, barrier_timeout = float(sys.argv[4]), float(sys.argv[5])
dist.init_process_group('gloo', store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
comm = cmt.create_communicator('xla', device='cpu')
peer = 1 - rank
res = {}

# a ring exchange
comm.send_obj({'from': rank, 'arr': np.arange(3) * (rank + 1)}, dest=peer)
res['ring'] = comm.recv_obj(source=peer)

# FIFO over three messages on one tag
if rank == 0:
    for i in range(3):
        comm.send_obj(('msg', i), dest=1, tag=5)
else:
    res['fifo'] = [comm.recv_obj(0, tag=5) for _ in range(3)]

# a receive that nobody feeds times out; the cursor stays
if rank == 1:
    t0 = time.monotonic()
    try:
        comm.recv_obj(0, tag=7, timeout=recv_timeout)
    except ChannelTimeout as e:
        res['timeout'] = (time.monotonic() - t0, str(e),
                          isinstance(e, TimeoutError))
    res['cursor_after_timeout'] = comm._recv_seq.get((0, 7, comm._channel),
                                                     0)
comm.barrier(timeout=60.0, tag='sync')
if rank == 0:
    comm.send_obj('late', dest=1, tag=7)
else:
    res['late'] = comm.recv_obj(0, tag=7, timeout=60.0)
    res['cursor_after_late'] = comm._recv_seq[(0, 7, comm._channel)]

# a barrier with one rank absent, then one with both
if rank == 0:
    t0 = time.monotonic()
    try:
        comm.barrier(timeout=barrier_timeout, tag='absent')
    except ChannelTimeout as e:
        res['absent'] = (time.monotonic() - t0, str(e))
comm.barrier(timeout=60.0, tag='both')
res['both'] = comm._barrier_epochs['both']

# p2p_gc: a message nobody took is swept and its slot reused
if rank == 0:
    comm.send_obj('lost', dest=1, tag=9)
    comm.p2p_gc(grace=0.0)
    res['send_cursor_after_gc'] = comm._send_seq[(1, 9, comm._channel)]
    comm.send_obj('kept', dest=1, tag=9)
comm.barrier(timeout=60.0, tag='gc')
if rank == 1:
    res['after_gc'] = comm.recv_obj(0, tag=9, timeout=60.0)

res['allreduce_obj'] = comm.allreduce_obj(float(rank), timeout=30.0)
with open(out, 'wb') as f:
    pickle.dump(res, f)
dist.destroy_process_group()
'''


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('p2p')
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK_SCRIPT, str(tmp / 'store'), str(r),
         str(tmp / ('r%d.pkl' % r)), str(RECV_TIMEOUT),
         str(BARRIER_TIMEOUT)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=180)
        assert p.returncode == 0, out.decode()
    out = []
    for r in range(2):
        with open(tmp / ('r%d.pkl' % r), 'rb') as f:
            out.append(pickle.load(f))
    return out


def test_ring_exchange(results):
    for rank, res in enumerate(results):
        got = res['ring']
        assert got['from'] == 1 - rank
        assert got['arr'].tolist() == [0, 2 - rank, 2 * (2 - rank)]


def test_fifo_on_one_tag(results):
    assert results[1]['fifo'] == [('msg', 0), ('msg', 1), ('msg', 2)]


def test_recv_timeout_raises_and_keeps_the_cursor(results):
    res = results[1]
    elapsed, msg, is_timeout_error = res['timeout']
    assert RECV_TIMEOUT <= elapsed < RECV_TIMEOUT + 2.0
    assert is_timeout_error and 'seq 0' in msg and 'tag 7' in msg
    assert res['cursor_after_timeout'] == 0
    # the later send is taken at seq 0
    assert res['late'] == 'late' and res['cursor_after_late'] == 1


def test_barrier_with_a_rank_absent_raises(results):
    elapsed, msg = results[0]['absent']
    assert BARRIER_TIMEOUT <= elapsed < BARRIER_TIMEOUT + 2.0
    assert "'absent'" in msg and 'epoch 1' in msg and '1 of 2' in msg
    # with both present it returns; epochs count per tag
    assert results[0]['both'] == results[1]['both'] == 1


def test_p2p_gc_sweeps_and_rewinds(results):
    assert results[0]['send_cursor_after_gc'] == 0
    assert results[1]['after_gc'] == 'kept'


def test_allreduce_obj_with_timeout(results):
    assert results[0]['allreduce_obj'] == results[1]['allreduce_obj'] == 0.5


def test_world_of_one(tmp_path):
    comm = cmt.create_communicator('hierarchical', device='cpu')
    comm.barrier(timeout=0.01)   # returns at once
    comm.send_obj({'x': [1, 2]}, dest=0, tag='t')
    comm.send_obj('second', dest=0, tag='t')
    assert comm.recv_obj(0, tag='t') == {'x': [1, 2]}
    assert comm.recv_obj(0, tag='t') == 'second'
    with pytest.raises(failure.ChannelTimeout):
        comm.recv_obj(0, tag='t', timeout=0.2)
    assert comm.allreduce_obj(3.0, timeout=1.0) == 3.0
    comm.p2p_gc()
    # peer liveness: this process's heartbeat, its own state alive
    hb = comm.enable_peer_liveness(str(tmp_path), interval=0.05)
    assert comm.peer_state(0) == 'alive'
    hb.stop()
    assert failure.read_heartbeat(str(tmp_path / 'heartbeat-0.json'))[
        'stopped'] is True


def test_two_communicators_have_their_own_channels():
    a = cmt.create_communicator('xla', device='cpu')
    b = cmt.create_communicator('xla', device='cpu')
    a.send_obj('for a', dest=0)
    with pytest.raises(failure.ChannelTimeout):
        b.recv_obj(0, timeout=0.1)
    assert a.recv_obj(0) == 'for a'


def test_failure_types_match_jax():
    for name in ('ChannelTimeout', 'CommFailure'):
        ours, theirs = getattr(failure, name), getattr(jfailure, name)
        assert ours.status_name == theirs.status_name
        assert [c.__name__ for c in ours.__mro__] == [
            c.__name__ for c in theirs.__mro__]


@pytest.mark.parametrize('kw', [{}, dict(initial=0.1, max_delay=2.0),
                                dict(initial=0.05, factor=3.0, max_delay=1.0,
                                     jitter=0.5, seed=7)])
def test_backoff_schedule_matches_jax(kw):
    ours, theirs = failure.Backoff(**kw), jfailure.Backoff(**kw)
    assert ours.delays(8) == theirs.delays(8)
    assert [ours.next() for _ in range(8)] == [theirs.next()
                                              for _ in range(8)]
    with pytest.raises(ValueError):
        failure.Backoff(initial=0)


def test_deadline_arithmetic_matches_jax():
    now = [0.0]
    for cls in (failure.Deadline, jfailure.Deadline):
        now[0] = 0.0
        d = cls(2.0, clock=lambda: now[0])
        now[0] = 1.5
        assert d.remaining() == 0.5 and not d.expired()
        assert d.slice(1.0) == 0.5 and d.slice(0.1) == 0.1
        now[0] = 2.5
        assert d.expired() and d.slice(1.0) == 1e-3
        assert cls(None).remaining() == float('inf')
