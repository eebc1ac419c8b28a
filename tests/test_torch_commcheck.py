"""The port's cross-rank checker against the JAX package's.

The framework-free core of ``chainermn_tpu_torch.analysis.commcheck``
(``verify_streams``, ``match_p2p``, ``check_ppermute_chain``,
``simulate_1f1b_streams``) must return exactly what the JAX
``chainermn_tpu.analysis.commcheck`` returns on the JAX tests' own
stream fixtures (``tests/test_analysis.py``), and the two recording
communicators must record one protocol alike.  The doctor's protocol
replay reaches the same ``verify_streams``.
"""

import torch

torch.set_num_threads(2)

import pytest  # noqa: E402

from chainermn_tpu.analysis import commcheck as jcc  # noqa: E402
from chainermn_tpu.communicators import recording as jrec  # noqa: E402
from chainermn_tpu_torch.analysis import commcheck as cc  # noqa: E402
from chainermn_tpu_torch.communicators import recording as rec  # noqa: E402


# -- the JAX tests' protocols (tests/test_analysis.py)

def _branched(comm):
    comm.allreduce_obj(0.0, op='mean')
    if comm.rank == 1:
        comm.allreduce_obj(1.0, op='sum')
    comm.barrier(tag='sync')


def _reordered(comm):
    if comm.rank == 0:
        comm.barrier(tag='a')
        comm.allreduce_obj(0.0, op='mean')
    else:
        comm.allreduce_obj(0.0, op='mean')
        comm.barrier(tag='a')


def _rooted(comm):
    comm.allreduce_obj(0.0, op='mean')
    if comm.rank == 0:
        comm.allreduce_obj(0.0, op='gather')
    comm.barrier(tag='done')


def _lonely(comm):
    if comm.rank == 0:
        comm.send_obj({'x': 1}, 1, tag=9)


def _collide(comm):
    if comm.rank == 0:
        comm.send_obj('first', 1, tag=3)
        comm.rebuilt().send_obj('second', 1, tag=3)
    else:
        comm.recv_obj(0, tag=3)


def _headon(comm):
    comm.recv_obj(1 - comm.rank, tag=0)
    comm.send_obj(None, 1 - comm.rank, tag=0)


def _early_exit(comm):
    if comm.rank != 1:
        comm.barrier(tag='sync')


def _bounded(comm):
    comm.allreduce_obj(0.0, op='sum', timeout=5.0)
    comm.broadcast_data(None, root=0)
    comm.barrier()


PROTOCOLS = {
    'branched': (_branched, 3), 'reordered': (_reordered, 2),
    'rooted': (_rooted, 2), 'lonely': (_lonely, 2),
    'collide': (_collide, 2), 'headon': (_headon, 2),
    'early_exit': (_early_exit, 3), 'bounded': (_bounded, 3),
    'reference@2': (jcc.reference_protocol, 2),
    'reference@3': (jcc.reference_protocol, 3),
    'reference@4': (jcc.reference_protocol, 4),
}


def _streams(name):
    fn, ws = PROTOCOLS[name]
    return jrec.simulate_protocol(fn, ws)


@pytest.mark.parametrize('name', sorted(PROTOCOLS))
def test_verify_streams_matches_jax(name):
    streams = _streams(name)
    want = jcc.verify_streams(streams)
    assert cc.verify_streams(streams) == want
    assert str(cc.verify_streams(streams, context=1)) \
        == str(jcc.verify_streams(streams, context=1))


@pytest.mark.parametrize('name', sorted(PROTOCOLS))
def test_match_p2p_matches_jax(name):
    streams = _streams(name)
    assert cc.match_p2p(streams) == jcc.match_p2p(streams)


def test_rank_addressed_exemption_matches_jax():
    streams = _streams('rooted')
    for recs in streams.values():
        for r in recs:
            if r.get('op') == 'allreduce_obj' and r.get('seq') == 1:
                r['op'] = 'root_gather'
    for excl in ((), ('root_gather',)):
        assert cc.verify_streams(streams, rank_addressed=excl) \
            == jcc.verify_streams(streams, rank_addressed=excl)


def _strip(records):
    out = []
    for r in records:
        r = dict(r)
        if 'key' in r:
            r['key'] = r['key'].split('/p2p/', 1)[1]
        out.append(r)
    return out


@pytest.mark.parametrize('name', sorted(PROTOCOLS))
def test_recording_communicators_record_alike(name):
    """The two fakes replay one protocol into equal records; the p2p
    keys differ only in their prefix (``chainermn_tpu/`` against
    ``chainermn_tpu_torch/``, the port channel's namespace)."""
    fn, ws = PROTOCOLS[name]
    mine = rec.simulate_protocol(fn, ws)
    theirs = jrec.simulate_protocol(fn, ws)
    assert sorted(mine) == sorted(theirs)
    for r in mine:
        assert _strip(mine[r]) == _strip(theirs[r])
        for got in mine[r]:
            if 'key' in got:
                assert got['key'].startswith('chainermn_tpu_torch/p2p/')


CHAINS = [([(0, 1), (1, 2)], 4, 3), ([(i, (i + 1) % 4) for i in range(4)],
                                     4, 8),
          ([(0, 1)], 2, 1), ([(0, 2), (2, 1)], 3, 2), ([], 3, 5),
          ([(1, 0), (0, 1)], 4, 6), ([(0, 1), (1, 2), (2, 3)], 4, 2)]


@pytest.mark.parametrize('perm,size,steps', CHAINS)
def test_check_ppermute_chain_matches_jax(perm, size, steps):
    assert cc.check_ppermute_chain(perm, size, steps) \
        == jcc.check_ppermute_chain(perm, size, steps)


@pytest.mark.parametrize('stages,micro', [(s, m) for s in (2, 3, 4)
                                          for m in (1, 3, 8)])
def test_simulate_1f1b_streams_matches_jax(stages, micro):
    mine = cc.simulate_1f1b_streams(stages, micro)
    theirs = jcc.simulate_1f1b_streams(stages, micro)
    assert {r: _strip(v) for r, v in mine.items()} \
        == {r: _strip(v) for r, v in theirs.items()}
    assert cc.match_p2p(mine) == [] == jcc.match_p2p(theirs)


def test_recorded_keys_are_the_port_channels():
    """A send the recording communicator stamps is the key the port's
    object channel publishes (``CommunicatorBase._p2p_key``), counted
    the same: 0-based cursors per (peer, tag, channel), 1-based barrier
    epochs per tag, a rebuilt communicator back at seq 0."""
    from chainermn_tpu_torch.communicators.base import CommunicatorBase
    r = rec.RecordingCommunicator(0, 2, channel='c1')
    r.send_obj(None, 1, tag=4)
    r.send_obj(None, 1, tag=4)
    r.rebuilt().send_obj(None, 1, tag=4)
    r.barrier(tag='t')
    r.barrier(tag='t')
    keys = [x['key'] for x in r.records if 'key' in x]
    assert keys == [CommunicatorBase._p2p_key(None, 'c1', 0, 1, 4, s)
                    for s in (0, 1, 0)]
    assert [x['seq'] for x in r.records if x['op'] == 'barrier'] == [1, 2]


def test_the_doctor_replays_through_the_one_verify_streams():
    from chainermn_tpu_torch.telemetry import diagnosis

    assert not hasattr(diagnosis, 'verify_streams')
    spans = []
    for rank in (0, 1):
        names = ['barrier', 'allreduce_obj'] + (['allreduce_obj']
                                                if rank == 1 else [])
        for i, name in enumerate(names):
            spans.append({'kind': 'collective', 'name': name, 'tag': None,
                          'seq': i, 'rank': rank, 't0': float(i)})
    d = diagnosis.protocol_divergence(spans)
    assert d == cc.verify_streams({
        r: [{'op': s['name'], 'kind': 'collective', 'tag': None,
             'seq': s['seq']} for s in spans if s['rank'] == r]
        for r in (0, 1)})
    assert d['kind'] == 'truncated' and d['position'] == 2
