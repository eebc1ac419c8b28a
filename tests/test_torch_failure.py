"""The port's failure taxonomy, liveness and ledger against the JAX
package's ``utils/failure.py`` and ``utils/ledger.py``.

- ``classify_exit`` over every return code from -15 to 130 (and None),
  ``exit_code_for`` over every typed exception: the same names and codes;
- ``detect_stall`` over a table of beat ages, timeouts and ``missing``
  modes, and the supervisor's ``StallWatch`` over the same heartbeat
  files under the same injected clock: the same verdicts;
- a ``Ledger`` and a heartbeat file written by one package read by the
  other; ``Heartbeat.stop`` stamps ``stopped``;
- the flight recorder: typed failures drop ``flight-rank0.json`` (the
  JAX doctor loads it), ``dump_flight(blocking=False)`` with the
  recorder's lock held writes a degraded record instead of waiting.
"""

import builtins
import json
import os
import time

import pytest
import torch

from chainermn_tpu.telemetry import diagnosis as jdiagnosis
from chainermn_tpu.training import supervisor as jsup
from chainermn_tpu.utils import failure as jfailure
from chainermn_tpu.utils import ledger as jledger
from chainermn_tpu_torch import telemetry
from chainermn_tpu_torch.training import supervisor as sup
from chainermn_tpu_torch.utils import failure, ledger

torch.set_num_threads(1)


@pytest.mark.parametrize('lo,hi', [(-15, 0), (0, 70), (70, 80),
                                   (80, 131)])
def test_classify_exit_matches_jax(lo, hi):
    for rc in range(lo, hi):
        assert failure.classify_exit(rc) == jfailure.classify_exit(rc), rc
    assert failure.classify_exit(None) == jfailure.classify_exit(None)


def test_exit_names_match_jax():
    assert failure.EXIT_NAMES == jfailure.EXIT_NAMES
    for name in ('EXIT_OK', 'EXIT_UNCAUGHT', 'EXIT_PREEMPTED',
                 'EXIT_DIVERGENCE', 'EXIT_CHANNEL_TIMEOUT',
                 'EXIT_PEER_DEAD', 'EXIT_CKPT_CORRUPT'):
        assert getattr(failure, name) == getattr(jfailure, name)


_TYPED = [
    ('PeerDeadError', ('x',), {'process_index': 1}),
    ('ChannelTimeout', ('t',), {}),
    ('CheckpointCorruptError', ('c',), {'kind': 'crc'}),
    ('DataCorruptError', ('d',), {'kind': 'crc'}),
    ('DivergenceError', ('nan',), {}),
    ('ReplicaDeadError', ('r',), {'replica': 2}),
    ('OverloadError', ('o',), {}),
    ('WeightSwapError', ('w',), {}),
]


@pytest.mark.parametrize('name,args,kw', _TYPED + [
    ('RuntimeError', ('boom',), {})])
def test_exit_code_for_matches_jax(name, args, kw):
    mine = getattr(failure, name, None) or getattr(builtins, name)
    theirs = getattr(jfailure, name, None) or getattr(builtins, name)
    got = failure.exit_code_for(mine(*args, **kw))
    assert got == jfailure.exit_code_for(theirs(*args, **kw))
    status = getattr(theirs, 'status_name', None)
    assert getattr(mine, 'status_name', None) == status


def test_typed_failures_keep_their_fields_and_bases():
    e = failure.PeerDeadError('gone', process_index=3)
    assert isinstance(e, failure.CommFailure) and e.process_index == 3
    r = failure.ReplicaDeadError('r', replica=1, request_ids=[4, 5])
    assert (r.replica, r.request_ids) == (1, (4, 5))
    assert issubclass(failure.CheckpointSkippedWarning, UserWarning)
    assert failure.PeerDeadError.__mro__[1].__name__ == \
        jfailure.PeerDeadError.__mro__[1].__name__


def _beat(live, rank, t, iteration, stopped=False):
    os.makedirs(live, exist_ok=True)
    with open(os.path.join(live, 'heartbeat-%d.json' % rank), 'w') as f:
        json.dump({'pid': 1, 'process_index': rank, 'time': t,
                   'iteration': iteration, 'stopped': stopped}, f)


@pytest.mark.parametrize('missing', ['stalled', 'alive'])
def test_detect_stall_matches_jax(missing, tmp_path):
    live = str(tmp_path)
    path = os.path.join(live, 'heartbeat-0.json')
    now = 1000.0
    for timeout in (0.5, 5.0, 60.0):
        assert failure.detect_stall(path, timeout, now, missing) == \
            jfailure.detect_stall(path, timeout, now, missing)
    for age in (0.0, 0.4, 4.9, 5.1, 59.0, 61.0, 1e4):
        _beat(live, 0, now - age, 3)
        for timeout in (0.5, 5.0, 60.0):
            got = failure.detect_stall(path, timeout, now, missing)
            assert got == jfailure.detect_stall(path, timeout, now,
                                                missing), (age, timeout)
    with open(path, 'w') as f:
        f.write('{"torn')
    assert failure.detect_stall(path, 1.0, now, missing) == \
        jfailure.detect_stall(path, 1.0, now, missing)
    with pytest.raises(ValueError):
        failure.detect_stall(path, missing='maybe')


class _Clock:
    def __init__(self, t):
        self.t = t

    def __call__(self):
        return self.t


# each script: (advance of the clock, {rank: (iteration, stopped)} beats
# written at the new time, or None to write nothing)
_WATCH_SCRIPTS = {
    'missing_in_grace': [(0.0, None), (10.0, None)],
    'missing_after_grace': [(0.0, None), (31.0, None)],
    'frozen_after_progress': [
        (0.0, {0: (1, False), 1: (1, False)}),
        (2.0, {0: (2, False), 1: (2, False)}),
        (2.0, {0: (3, False), 1: (2, False)}),
        (2.0, {0: (4, False), 1: (2, False)}),
        (2.0, {0: (5, False), 1: (2, False)})],
    'stopped_exempt': [
        (0.0, {0: (3, False), 1: (3, True)}),
        (40.0, {0: (9, False)})],
    'stale_file': [
        (0.0, {0: (1, False), 1: (1, False)}),
        (40.0, {0: (2, False)})],
    'never_advanced_after_grace': [
        (0.0, {0: (0, False), 1: (0, False)}),
        (20.0, {0: (0, False), 1: (0, False)}),
        (15.0, {0: (0, False), 1: (0, False)})],
}


@pytest.mark.parametrize('script', sorted(_WATCH_SCRIPTS))
def test_stall_watch_verdicts_match_jax(script, tmp_path):
    t0 = time.time()
    clocks = (_Clock(t0), _Clock(t0))
    live = str(tmp_path)
    watches = [mod.StallWatch(live, [0, 1], stall_timeout=5.0,
                              startup_grace=30.0, clock=c)
               for mod, c in zip((sup, jsup), clocks)]
    for dt, beats in _WATCH_SCRIPTS[script]:
        for c in clocks:
            c.t += dt
        for rank, (it, stopped) in (beats or {}).items():
            _beat(live, rank, clocks[0].t, it, stopped)
        got, want = (w.poll() for w in watches)
        assert got == want, script
    assert (watches[0].first_progress_t is None) == (
        watches[1].first_progress_t is None)


def test_ledgers_cross_read(tmp_path):
    path = str(tmp_path / 'supervisor_ledger.jsonl')
    ledger.Ledger(path).append('start', nprocs=3)
    jledger.Ledger(path).append('failure', cause='killed', rank=1)
    ledger.Ledger(path).append('decision', action='shrink', world_after=2)
    with open(path, 'a') as f:
        f.write('{"event": "fail')              # a writer killed mid-line
    mine, theirs = ledger.Ledger.read(path), jledger.Ledger.read(path)
    assert mine == theirs
    assert [e['event'] for e in mine] == ['start', 'failure', 'decision']
    assert ledger.events(mine, 'failure') == jledger.events(theirs,
                                                            'failure')
    assert ledger.Ledger.read(str(tmp_path / 'none')) == []


def test_heartbeats_cross_read(tmp_path):
    path = str(tmp_path / 'live' / 'heartbeat-0.json')
    hb = failure.Heartbeat(path, interval=0.05).start()
    hb.beat(7)
    time.sleep(0.2)
    beat = jfailure.read_heartbeat(path)
    assert beat['process_index'] == 0 and beat['iteration'] == 7
    assert not jfailure.detect_stall(path, 5.0)
    hb.stop()
    final = jfailure.read_heartbeat(path)
    assert final['stopped'] is True and final['iteration'] == 7
    # a JAX heartbeat read by the port
    jpath = str(tmp_path / 'live' / 'heartbeat-1.json')
    jhb = jfailure.Heartbeat(jpath, interval=0.05).start()
    jhb.beat(3)
    time.sleep(0.2)
    jhb.stop()
    assert failure.read_heartbeat(jpath)['iteration'] == 3
    assert failure.read_heartbeat(jpath)['stopped'] is True
    assert failure.detect_stall(jpath, 1e-9, now=time.time() + 1)


def test_heartbeat_extension_finalize_stops_the_beat(tmp_path):
    ext = failure.heartbeat_extension(str(tmp_path), interval=0.05)
    assert (ext.trigger, ext.priority, ext.name) == (
        (1, 'iteration'), 20, 'heartbeat')

    class _T:
        class updater:
            iteration = 11

    ext(_T)
    ext.finalize()
    beat = failure.read_heartbeat(str(tmp_path / 'heartbeat-0.json'))
    assert beat['stopped'] and beat['iteration'] == 11


def test_typed_failures_drop_flight_records(tmp_path):
    telemetry.disable()
    rec = telemetry.enable(str(tmp_path))
    try:
        with telemetry.span('recv_obj', kind='p2p', source=1, seq=4):
            failure.PeerDeadError('peer 1 stalled', process_index=1)
        flights = jdiagnosis.load_flight_records(str(tmp_path))
        assert sorted(flights) == [0]
        f = flights[0]
        assert f['reason'] == 'PeerDeadError'
        assert f['attrs']['process_index'] == 1
        assert [s['name'] for s in f['open_spans']] == ['recv_obj']
        failure.CheckpointCorruptError('bad', path='p', kind='crc')
        assert jdiagnosis.load_flight_records(str(tmp_path))[0][
            'reason'] == 'CheckpointCorruptError'
        failure.OverloadError('full')          # sheds drop no record
        assert rec.flight_dumps == 2
        # a signal handler's dump with the lock held does not wait
        with rec._lock:
            path = telemetry.dump_flight('sigterm', blocking=False)
        assert path is not None
        with open(path) as f:
            flight = json.load(f)
        assert flight['degraded'] is True and flight['complete'] is True
        rec.flight_sources['table'] = lambda: {'live': 3}
        telemetry.dump_flight('again')
        with open(path) as f:
            assert json.load(f)['table'] == {'live': 3}
    finally:
        telemetry.disable()
    assert telemetry.dump_flight('off') is None
