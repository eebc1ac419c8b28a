"""The port's supervisor, doctor and goodput against the JAX package's
``training/supervisor.py``, ``telemetry/diagnosis.py`` and
``telemetry/goodput.py``.

- The JAX ``tests/test_supervisor.py`` scenarios of ``RestartPolicy``
  (fake clock), ``escalate`` (fake process table), ``classify_failure``
  (with and without a doctor verdict) and ``slice_verdict``: the same
  verdicts from both packages.
- The doctor over captures written by the port: a hand-made three-rank
  capture (paired collectives with a late rank, a killed rank's flight
  record, a survivor's ``PeerDeadError``, heartbeats) and the end-to-end
  run's; ``quick_verdict`` / ``diagnose`` of the port equal the JAX
  package's ``diagnose``.  ``build_goodput`` is equal over one ledger and
  its captures.
- One end-to-end run on gloo: ``python -m chainermn_tpu_torch.supervisor
  -n 3 --steps 6 --ckpt-every 2 --device cpu`` under
  ``CHAINERMN_TPU_CHAOS='rank=1;kill_step=@3'``: the ledger says
  ``killed``, rank 1, ``kill_step``, the doctor agreeing, shrink 3 -> 2,
  resumed at 2, one restart; the losses equal the oracle's at atol 1e-5
  (as JAX ``tests/test_supervisor_mp.py`` asserts), and the oracle equals
  the JAX demo trainer's losses from the same weights at rtol 1e-5.
- Peer liveness on 2 gloo processes: ``recv_obj`` from a slow peer raises
  ``ChannelTimeout``, from a dead one ``PeerDeadError`` naming it, as do
  ``barrier`` and ``allreduce_obj(timeout=)``; a phantom
  ``extra_collective`` is the protocol divergence both doctors name.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu import models as jmodels
from chainermn_tpu import training as jtraining
from chainermn_tpu.telemetry import diagnosis as jdiagnosis
from chainermn_tpu.telemetry import goodput as jgoodput
from chainermn_tpu.training import supervisor as jsup
from chainermn_tpu.utils import failure as jfailure
from chainermn_tpu_torch import models
from chainermn_tpu_torch import supervisor as cli
from chainermn_tpu_torch.telemetry import diagnosis, goodput
from chainermn_tpu_torch.telemetry.recorder import Recorder
from chainermn_tpu_torch.training import supervisor as sup
from chainermn_tpu_torch.utils import failure
from chainermn_tpu_torch.utils.ledger import Ledger, events

from torch_spawn import REPO, spawn

torch.set_num_threads(1)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.t += dt


def _both(fn):
    """``fn(supervisor module, failure module)`` for the port and JAX."""
    return fn(sup, failure), fn(jsup, jfailure)


# (cause, nprocs, dead ranks, granularity, slice size, clock advance)
_POLICY_SCRIPTS = {
    'budget': (dict(max_restarts=2, crash_window=1.0, crash_threshold=100),
               [('killed', 2, [1], 'rank', 1, 0), ('uncaught', 2, [], 'rank',
                                                    1, 100),
                ('uncaught', 2, [], 'rank', 1, 100)]),
    'crash_loop': (dict(max_restarts=100, crash_window=60.0,
                        crash_threshold=3),
                   [('checkpoint_corrupt', 2, [], 'rank', 1, 0)] * 1
                   + [('checkpoint_corrupt', 2, [], 'rank', 1, 10)] * 2),
    'spaced': (dict(crash_window=60.0, crash_threshold=3),
               [('uncaught', 2, [], 'rank', 1, 100)] * 5),
    'shrink_vs_restart': (dict(crash_threshold=100, min_procs=2),
                          [('killed', 3, [1], 'rank', 1, 0),
                           ('hang', 2, [0], 'rank', 1, 1000),
                           ('checkpoint_corrupt', 3, [0], 'rank', 1, 1000),
                           ('divergence', 3, [0], 'rank', 1, 1000),
                           ('killed', 3, [], 'rank', 1, 1000),
                           ('peer_dead', 4, [2, 3], 'rank', 1, 1000)]),
    'slices': (dict(max_restarts=8, crash_window=300.0, crash_threshold=3),
               [('killed', 4, [2, 3], 'slice', 2, 0),
                ('killed', 2, [0, 1], 'slice', 2, 1),
                ('crash', 2, [0], 'rank', 2, 1)]),
    'slice_rounding': (dict(min_procs=2),
                       [('crash', 4, [3], 'rank', 2, 0),
                        ('crash', 2, [1], 'rank', 2, 1000)]),
}


@pytest.mark.parametrize('script', sorted(_POLICY_SCRIPTS))
def test_restart_policy_decisions_match_jax(script):
    kw, calls = _POLICY_SCRIPTS[script]

    def run(mod, fail):
        clock = FakeClock()
        p = mod.RestartPolicy(clock=clock, backoff=fail.Backoff(
            initial=0.5, factor=2.0, max_delay=8.0), **kw)
        out = []
        for cause, n, dead, gran, size, dt in calls:
            clock.t += dt
            out.append(tuple(p.on_failure(cause, n, dead_ranks=dead,
                                          granularity=gran,
                                          slice_size=size)))
        p.on_success()
        clock.t += 1000
        out.append(tuple(p.on_failure('uncaught', 2)))
        return out, p.restarts, p.describe()

    mine, theirs = _both(run)
    assert mine == theirs


class FakeTable:
    """``exits_after[rank]`` seconds after its SIGTERM the rank leaves on
    its own; None: never."""

    def __init__(self, exits_after, clock):
        self.exits_after = dict(exits_after)
        self.clock = clock
        self.term_t = {}
        self.killed = []

    def live_ranks(self):
        out = []
        for r, dt in sorted(self.exits_after.items()):
            if r in self.killed:
                continue
            t0 = self.term_t.get(r)
            if t0 is not None and dt is not None and \
                    self.clock() - t0 >= dt:
                continue
            out.append(r)
        return out

    def terminate(self, rank):
        self.term_t[rank] = self.clock()

    def kill(self, rank):
        self.killed.append(rank)


@pytest.mark.parametrize('exits,grace', [({0: 0.3, 1: 0.5}, 5.0),
                                         ({0: 0.2, 1: None}, 2.0),
                                         ({1: None}, 0.5),
                                         ({0: None, 1: None, 2: 1.0}, 0.7)])
def test_escalate_matches_jax(exits, grace):
    def run(mod, _):
        clock = FakeClock()
        log = mod.escalate(FakeTable(exits, clock), term_grace=grace,
                           clock=clock, sleep=clock.sleep,
                           poll_interval=0.1)
        return log, round(clock.t, 6)

    mine, theirs = _both(run)
    assert mine == theirs


def _doctor(dead_ranks=(), flights=None, chaos_events=None):
    per_rank = {r: {'flight_reason': reason}
                for r, reason in (flights or {}).items()}
    for r, names in (chaos_events or {}).items():
        per_rank.setdefault(r, {})['chaos_events'] = names
    return {'crash': {'per_rank': per_rank},
            'verdict': {'dead_ranks': list(dead_ranks),
                        'summary': ['test']}}


_CLASSIFY = [
    ((0, 75), {0: 75, 1: -9}, None, ()),
    ((1, 42), {0: -9, 1: 42, 2: -9},
     _doctor([1], {1: 'chaos:kill_step'}), ()),
    ((0, 74), {0: 74, 1: 42}, _doctor([1], {0: 'PeerDeadError',
                                            1: 'chaos:kill_recv'}), ()),
    (None, {0: -9, 1: -9}, _doctor(flights={1: 'chaos:hang_step'}),
     (0, 1)),
    (None, {0: -9, 1: -9}, _doctor(flights={0: 'sigterm'}, chaos_events={
        0: ['chaos:hang_step']}), (0, 1)),
    (None, {0: -9, 1: 0}, None, (0,)),
    (None, {0: -9, 1: -9}, None, (0, 1)),
    ((1, -15), {0: 0, 1: -15}, None, ()),
    ((0, 71), {0: 71}, _doctor(flights={0: 'sigterm'}, chaos_events={
        0: ['chaos:sigterm_step']}), ()),
    ((2, 70), {0: 74, 1: 74, 2: 70}, _doctor([2], chaos_events={
        2: ['chaos:delay_send']}), ()),
    ((3, 45), {0: 71, 1: 71, 2: 45, 3: 45}, _doctor(
        [2, 3], {2: 'chaos:slice_loss', 3: 'chaos:slice_loss'}), ()),
    ((0, 72), {0: 72, 1: 0}, _doctor(), ()),
]


@pytest.mark.parametrize('case', range(len(_CLASSIFY)))
def test_classify_failure_matches_jax(case):
    first, rcs, doctor, hang = _CLASSIFY[case]
    got, want = _both(lambda mod, _: mod.classify_failure(
        first, rcs, doctor=doctor, hang_ranks=hang))
    assert got == want


_SLICES = [
    (2, {2: 70}, None, (), ()), (2, {2: 70}, 1, (), ()),
    (None, {}, None, (), ()),
    (3, {0: 71, 1: 71, 2: 45, 3: 45}, 2, (), ()),
    (3, {0: 71, 1: 71, 2: 71, 3: 45}, 2, (), ()),
    (2, {0: 0, 1: 0, 2: -9, 3: -11}, 2, (), ()),
    (3, {0: 0, 1: 0, 2: -9, 3: 45}, 2, (), (2,)),
    (3, {0: 71, 1: 71, 2: 0, 3: 45}, 2, (2,), ()),
    (0, {0: 45, 1: 45, 2: 45, 3: 45}, 2, (), ()),
    (4, {i: (45 if i in (3, 4, 5) else 74) for i in range(6)}, 3, (), ()),
]


@pytest.mark.parametrize('case', range(len(_SLICES)))
def test_slice_verdict_matches_jax(case):
    culprit, rcs, per, dead, forced = _SLICES[case]
    got, want = _both(lambda mod, _: mod.slice_verdict(
        culprit, rcs, per, doctor_dead=dead, forced=forced))
    assert got == want


def test_worker_main_maps_exits_as_jax():
    for fn, code in ((lambda: 'preempted', failure.EXIT_PREEMPTED),
                     (lambda: None, 0),
                     (lambda: (_ for _ in ()).throw(
                         failure.PeerDeadError('x', 1)),
                      failure.EXIT_PEER_DEAD),
                     (lambda: (_ for _ in ()).throw(ValueError('x')),
                      failure.EXIT_UNCAUGHT)):
        with pytest.raises(SystemExit) as ei:
            sup.worker_main(fn)
        assert ei.value.code == code
    assert (sup.ENV_RANK, sup.ENV_PORT, sup.ENV_LIVE, sup.LEDGER_NAME,
            sup.DEMO_ROWS) == (jsup.ENV_RANK, jsup.ENV_PORT, jsup.ENV_LIVE,
                               jsup.LEDGER_NAME, jsup.DEMO_ROWS)


def test_cli_usage_exit_codes(capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main(['--nprocs'])
    assert ei.value.code == 2
    with pytest.raises(SystemExit) as ei:
        cli.main(['--help'])
    assert ei.value.code == 0


def _recorder(rank, outdir):
    rec = Recorder(outdir=outdir)
    rec._rank = lambda: rank
    return rec


def test_doctor_over_a_port_capture_matches_jax(tmp_path):
    """Three ranks: rank 2 arrives late to every barrier and is
    chronically slow in ``host_batch_prep``; rank 1 is killed by chaos
    (its flight record) and rank 0 raises ``PeerDeadError`` naming it."""
    out, live = str(tmp_path / 'cap'), str(tmp_path / 'live')
    recs = [_recorder(r, out) for r in range(3)]
    base = 1000.0
    for seq in range(12):
        t = base + seq
        for r, rec in enumerate(recs):
            late = 0.020 if r == 2 else 0.001 * r
            rec._append({'type': 'span', 'name': 'host_batch_prep',
                         'kind': 'host', 't0': t, 't1': t + 0.005 + late,
                         'iteration': seq})
            rec._append({'type': 'span', 'name': 'jitted_step',
                         'kind': 'compute', 't0': t + 0.03,
                         't1': t + 0.05 + (0.05 if seq == 7 else 0.0),
                         'iteration': seq})
            if r == 1 and seq >= 10:
                continue
            rec._append({'type': 'span', 'name': 'barrier',
                         'kind': 'collective', 'tag': 'b', 'seq': seq,
                         't0': t + 0.06 + late, 't1': t + 0.09})
    recs[1].event('chaos:kill_step', kind='chaos', occurrence=10)
    recs[1].liveness_dir = live
    with recs[0].span('recv_obj', kind='p2p', source=1, tag=0, seq=3):
        recs[0].dump_flight('PeerDeadError', process_index=1,
                            message='peer 1 stalled')
    recs[1].dump_flight('chaos:kill_step', occurrence=10)
    recs[2].flush()
    for r, t in ((0, base + 20), (1, base + 10), (2, base + 20)):
        os.makedirs(live, exist_ok=True)
        with open(os.path.join(live, 'heartbeat-%d.json' % r), 'w') as f:
            json.dump({'pid': 1, 'process_index': r, 'time': t,
                       'iteration': 10, 'stopped': False}, f)
    mine = diagnosis.quick_verdict(out, liveness_dirs=(live,))
    theirs = jdiagnosis.diagnose(out, liveness_dirs=(live,))
    norm = json.loads
    assert norm(json.dumps(mine, default=repr)) == \
        norm(json.dumps(theirs, default=repr))
    assert mine['verdict']['dead_ranks'] == [1]
    assert mine['verdict']['straggler_rank'] == 2
    metas, spans, evs, _ = diagnosis.load_rank_logs(out)
    crash = diagnosis.crash_analysis(
        out, metas, spans, evs, diagnosis.load_flight_records(out),
        liveness_dirs=(live,))
    assert crash['dead_ranks'] == [1]
    assert crash['per_rank'][0]['blocked_in'][0]['name'] == 'recv_obj'
    text = diagnosis.render_doctor_text(mine)
    assert text == jdiagnosis.render_doctor_text(theirs)
    assert diagnosis.export(out, mine)['verdict'] == mine['verdict']
    assert diagnosis.quick_verdict(str(tmp_path / 'none')) is None


FAST = ['--steps', '6', '--ckpt-every', '2', '--device', 'cpu',
        '--drain-grace', '3', '--term-grace', '6', '--backoff-initial',
        '0.2', '--startup-grace', '40', '--stall-timeout', '30',
        '--attempt-timeout', '50']


@pytest.fixture(scope='module')
def killed_run(tmp_path_factory):
    out = str(tmp_path_factory.mktemp('supervised') / 'run')
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(('CHAINERMN_TPU_', 'CMN_SUP_'))}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS='1',
               CHAINERMN_TPU_CHAOS='rank=1;kill_step=@3')
    proc = subprocess.run(
        [sys.executable, '-m', 'chainermn_tpu_torch.supervisor', '-n', '3',
         '--out', out] + FAST, env=env, capture_output=True, text=True,
        timeout=60)
    return proc, out, Ledger.read(os.path.join(out, sup.LEDGER_NAME))


def _worker_json(out, attempt, rank):
    with open(os.path.join(out, 'workers',
                           'a%d-rank%d.json' % (attempt, rank))) as f:
        return json.load(f)


def test_supervised_kill_is_classified_shrunk_and_resumed(killed_run):
    proc, out, ledger = killed_run
    assert proc.returncode == 0, proc.stdout + proc.stderr
    fails = events(ledger, 'failure')
    assert len(fails) == 1, fails
    f = fails[0]
    assert (f['cause'], f['rank'], f['chaos_site'], f['world_size']) == (
        'killed', 1, 'kill_step', 3)
    assert 1 in f['doctor_dead_ranks'] and f['doctor_agrees'] is True
    decs = events(ledger, 'decision')
    assert [(d['action'], d['world_before'], d['world_after'])
            for d in decs] == [('shrink', 3, 2)]
    recs = events(ledger, 'recovered')
    assert len(recs) == 1 and recs[0]['resumed_step'] == 2
    assert recs[0]['downtime_s'] > 0
    comp = events(ledger, 'complete')
    assert len(comp) == 1
    assert (comp[0]['world_size'], comp[0]['resumed_step'],
            comp[0]['restarts']) == (2, 2, 1)
    assert comp[0]['mttr_s'] == recs[0]['downtime_s']
    assert events(ledger, 'launch')[1]['chaos'] == 'rank=1'  # stripped
    for rank in (0, 1):
        res = _worker_json(out, 1, rank)
        assert (res['world_size'], res['resumed_at'],
                res['final_iteration']) == (2, 2, 6)
        np.testing.assert_allclose(res['losses'], res['oracle'][2:],
                                   rtol=0, atol=1e-5)
        assert abs(res['param_sum'] - res['oracle_param_sum']) < 1e-4
    logs = set(os.listdir(os.path.join(out, 'logs')))
    assert {'a0-rank0.log', 'a0-rank1.log', 'a0-rank2.log',
            'a1-rank0.log', 'a1-rank1.log'} <= logs
    # the survivors left typed: PeerDeadError naming rank 1, or the same
    # collective error as a plain exit when the heartbeat had not stalled
    assert f['rank_exit_codes']['1'] == 42


def test_doctor_and_goodput_over_the_run_match_jax(killed_run):
    _, out, _ = killed_run
    tdir = os.path.join(out, 'telemetry', 'a0')
    live = os.path.join(out, 'live', 'a0')
    mine = diagnosis.quick_verdict(tdir, liveness_dirs=(live,))
    theirs = jdiagnosis.diagnose(tdir, liveness_dirs=(live,))
    assert mine['verdict']['dead_ranks'] == \
        theirs['verdict']['dead_ranks'] == [1]
    assert json.dumps(mine['crash'], sort_keys=True, default=repr) == \
        json.dumps(theirs['crash'], sort_keys=True, default=repr)
    gp, jgp = goodput.build_goodput(out), jgoodput.build_goodput(out)
    assert gp == jgp
    assert 0.0 < gp['goodput_fraction'] < 1.0
    assert gp['buckets_s']['restart_downtime'] > 0.0
    assert sum(gp['buckets_s'].values()) == pytest.approx(gp['wall_s'],
                                                          rel=1e-3)
    assert gp['ledger']['failures'] == 1 and gp['ledger']['shrinks'] == 1
    assert goodput.render_text(gp) == jgoodput.render_text(jgp)
    assert goodput.export(out, gp) == gp


def test_demo_oracle_matches_the_jax_demo_trainer(killed_run):
    """The port's demo trainer (its oracle at 3 processes) against the
    JAX package's demo trainer (``_build_demo_train``'s MLP, SGD 0.1 with
    momentum 0.9, ZeRO-1, ``DEMO_ROWS`` rows from seed 1234) from the
    port's initial weights."""
    _, out, _ = killed_run
    want = _worker_json(out, 0, 0)['oracle']
    model = models.MLP(n_units=16, n_out=4, n_in=8, device='cpu')
    params = models.to_flax_variables(model)['params']
    jm = jmodels.MLP(n_units=16, n_out=4)
    comm = chainermn_tpu.create_communicator(
        'xla', devices=jax.devices()[:1], mesh_shape=(1, 1))
    upd = jtraining.StandardUpdater(
        iter([]), optax.sgd(0.1, momentum=0.9),
        jmodels.classifier_loss(lambda p, x: jm.apply({'params': p}, x)),
        params, comm, has_aux=True, donate=False, zero=True)
    rs = np.random.RandomState(1234)
    gx = rs.randn(sup.DEMO_ROWS, 8).astype(np.float32)
    gy = (rs.rand(sup.DEMO_ROWS) * 4).astype(np.int32)
    batch = upd.shard_batch(list(zip(gx, gy)))
    got = [float(upd.update_core(batch)['loss']) for _ in range(len(want))]
    np.testing.assert_allclose(want, got, rtol=1e-5)


_LIVENESS = r'''
import os, time
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import telemetry
from chainermn_tpu_torch.utils import chaos, failure
live, tdir = argv
telemetry.enable(tdir)
comm = cmt.create_communicator('xla', device='cpu')
if rank == 0:
    chaos.install(chaos.FaultInjector('extra_collective=@0'))
res['sum'] = np.float64(comm.allreduce_obj(rank + 1.0, op='sum'))
chaos.uninstall()
telemetry.flush()
telemetry.disable()
comm.enable_peer_liveness(live, interval=0.1, stall_timeout=1.0)
comm.barrier(timeout=20)
if rank == 1:
    comm.send_obj('hello', dest=0, tag=1)
    time.sleep(1.5)                     # slow, but beating
    comm.send_obj('late', dest=0, tag=2)
    comm.recv_obj(0, tag=9, timeout=20)
    np.savez(_out_path, **res)
    os._exit(0)                         # dies: the heartbeat goes stale
assert comm.recv_obj(1, tag=1, timeout=20) == 'hello'
time.sleep(0.3)                         # the peer's first beat is on disk
assert comm.peer_state(1) == 'alive' and comm.peer_state(0) == 'alive'
t0 = time.monotonic()
try:
    comm.recv_obj(1, tag=2, timeout=0.6)
except failure.PeerDeadError:
    raise
except failure.ChannelTimeout:
    res['slow'] = np.float64(time.monotonic() - t0)
assert comm.recv_obj(1, tag=2, timeout=20) == 'late'
comm.send_obj('bye', dest=1, tag=9)
errors = []
for call in (lambda: comm.recv_obj(1, tag=3, timeout=20),
             lambda: comm.barrier(timeout=20),
             lambda: comm.allreduce_obj(1.0, timeout=20)):
    t0 = time.monotonic()
    try:
        call()
    except failure.PeerDeadError as e:
        errors.append((e.process_index, time.monotonic() - t0))
res['dead'] = np.array([e[0] for e in errors])
res['dead_s'] = np.array([e[1] for e in errors])
res['state'] = np.array(comm.peer_state(1))
np.savez(_out_path, **res)
os._exit(0)                             # the peer is gone: no teardown
'''


def test_peer_liveness_tells_dead_from_slow(tmp_path):
    tdir = str(tmp_path / 'tele')
    out = spawn(tmp_path, _LIVENESS, 2,
                argv=(str(tmp_path / 'live'), tdir), deadline=60)
    assert float(out[0]['sum']) == float(out[1]['sum']) == 3.0
    assert 0.5 < float(out[0]['slow']) < 5.0          # a ChannelTimeout
    assert list(out[0]['dead']) == [1, 1, 1]          # recv, barrier, obj
    assert (out[0]['dead_s'] < 10.0).all()
    assert str(out[0]['state']) == 'dead'
    # the phantom collective on rank 0 is the divergence both doctors name
    mine = diagnosis.diagnose(tdir)['protocol_divergence']
    theirs = jdiagnosis.diagnose(tdir)['protocol_divergence']
    assert mine == theirs and mine is not None
    assert mine['kind'] == 'truncated'
