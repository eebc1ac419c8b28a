"""The port's replica fleet against the JAX package.

Units first, each held to the JAX package on the same inputs (made from a
seed with numpy): ``canary_slice`` over 10,000 ids, the
``RequestJournal`` written by either package and replayed by the other,
``CanaryJudge`` verdicts, the ``DegradationPolicy`` ladder with its ledger
events, and the ``CheckpointWatcher`` over a chain whose newest snapshot
lacks its sentinel or is corrupt.  Then the demo: the port's demo model
and ``demo_train`` against the JAX ones, and one booted in-process fleet
(served on the CPU, in f32, from snapshots the JAX package's
``demo_train`` wrote) whose streams equal the JAX ``GenerationEngine``'s
token for token across a canary breach and rollback, and across a healthy
roll and promote; and the exact-replay recovery of a replica killed
mid-decode, in the slab, paged-prefix and speculative modes, equal token
for token to the uninterrupted JAX engine.  The front's recovery and the
supervisor's crash-loop abort run over stubs, as in the JAX tests.
"""

import os
import threading
import time
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import serializers as jserializers
from chainermn_tpu.serving import fleet as jfleet
from chainermn_tpu.serving.generate import GenerationEngine as JEngine
from chainermn_tpu.serving.generate import GenerationQueue as JQueue
from chainermn_tpu.utils import failure as jfailure
from chainermn_tpu.utils.ledger import Ledger as JLedger
from chainermn_tpu_torch import models, serializers, telemetry
from chainermn_tpu_torch.serving import fleet
from chainermn_tpu_torch.training import recovery
from chainermn_tpu_torch.training.supervisor import RestartPolicy
from chainermn_tpu_torch.utils import chaos, failure
from chainermn_tpu_torch.utils.ledger import Ledger, events

torch.set_num_threads(2)

RESULT_TIMEOUT = 60.0


# ---------------------------------------------------------------------
# canary slicing

@pytest.mark.parametrize('fraction', [0.0, 0.01, 0.1, 0.25, 0.5, 0.9,
                                      0.9999, 1.0])
def test_canary_slice_equals_jax(fraction):
    ids = ['r%d' % i for i in range(1, 10001)]
    got = [fleet.canary_slice(r, fraction) for r in ids]
    assert got == [jfleet.canary_slice(r, fraction) for r in ids]
    if 0.0 < fraction < 1.0:
        assert abs(sum(got) / len(ids) - fraction) < 0.03


def test_canary_slice_deterministic_and_monotone():
    ids = ['r%d' % i for i in range(1, 400)]
    first = [fleet.canary_slice(r, 0.25) for r in ids]
    assert first == [fleet.canary_slice(r, 0.25) for r in ids]
    small = {r for r in ids if fleet.canary_slice(r, 0.1)}
    large = {r for r in ids if fleet.canary_slice(r, 0.5)}
    assert small <= large
    assert not fleet.canary_slice('r1', 0.0)
    assert fleet.canary_slice('r1', 1.0)


# ---------------------------------------------------------------------
# the request journal

def _fill_journal(journal):
    journal.admit('r1', [3, 1], 4, None, 'replica-0', 2)
    journal.admit('r2', np.asarray([5], np.int32), 6, 123.4, 'replica-1',
                  2)
    journal.admit('r3', [7, 7, 7], 3, 99.0, 'replica-1', 4)
    journal.tokens('r1', [7, 8])
    journal.tokens('rZ', [9])            # unknown id: dropped quietly
    journal.tokens('r3', np.asarray([1, 2], np.int64))
    journal.reassign('r2', 'replica-0')
    assert journal.done('r1', outcome='served')
    journal.tokens('r3', [5])


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_journal_replays_in_the_other_package(tmp_path, writer):
    path = str(tmp_path / 'journal.jsonl')
    pkg = jfleet if writer == 'jax' else fleet
    j = pkg.RequestJournal(path)
    _fill_journal(j)
    with open(path, 'a') as f:
        f.write('{"event": "token", "request_id": "r2", "tok')  # torn
    got = fleet.RequestJournal.replay(path)
    assert got == jfleet.RequestJournal.replay(path)
    assert got == {rid: dict(e, emitted=list(e['emitted']))
                   for rid, e in j.inflight().items()}
    assert got['r3']['emitted'] == [1, 2, 5]
    assert got['r2']['replica'] == 'replica-0'
    assert set(got) == {'r2', 'r3'}


def test_journal_done_first_closer_wins(tmp_path):
    j = fleet.RequestJournal(str(tmp_path / 'j.jsonl'))
    j.admit('r1', [1], 2, None, 'a', 0)
    assert j.done('r1', outcome='served')
    assert not j.done('r1', outcome='shed', reason='deadline')
    assert (j.admitted, j.completed) == (1, 1)
    h = fleet.FrontHandle('r1')
    h._complete([4, 5])
    h._fail(RuntimeError('late'))        # first wins: ignored
    assert list(h.result(timeout=0)) == [4, 5]
    with pytest.raises(TimeoutError):
        fleet.FrontHandle('r2').result(timeout=0.01)


# ---------------------------------------------------------------------
# the canary judge

def _random_eval(rng):
    if rng.rand() < 0.1:
        return None
    rows = {}
    for name in ('ttft_p99', 'intertoken_p99', 'latency_p99'):
        if rng.rand() < 0.7:
            fast = {'count': int(rng.randint(0, 20))}
            if rng.rand() < 0.9:
                fast['p99'] = float(rng.exponential(0.03))
            rows[name] = {'kind': 'latency', 'fast': fast}
    if rng.rand() < 0.7:
        rows['shed_fraction'] = {'kind': 'fraction', 'fast': {
            'value': float(rng.uniform(0, 0.3) ** 2),
            'count': int(rng.randint(0, 20))}}
    overall = ['ok', 'warn', 'breach', None][rng.randint(4)]
    return {'slos': rows, 'verdict': {
        'overall': overall,
        'breaches': ['ttft_p99'] if overall == 'breach' else []}}


@pytest.mark.parametrize('seed', range(12))
def test_canary_judge_equals_jax(seed):
    rng = np.random.RandomState(seed)
    kw = dict(latency_ratio=float(rng.uniform(1.1, 2.0)),
              latency_floor_ms=float(rng.choice([0.0, 5.0, 20.0])),
              shed_delta=float(rng.uniform(0.0, 0.1)),
              min_events=int(rng.randint(1, 8)))
    judge, jjudge = fleet.CanaryJudge(**kw), jfleet.CanaryJudge(**kw)
    assert judge.describe() == jjudge.describe()
    verdicts = set()
    for _ in range(40):
        cand = _random_eval(rng)
        incs = [_random_eval(rng) for _ in range(rng.randint(0, 3))]
        got = judge.judge(cand, [e for e in incs if e])
        assert got == jjudge.judge(cand, [e for e in incs if e])
        verdicts.add(got['verdict'])
    assert len(verdicts) >= 2


def _eval(itl_p99=None, shed=None, n=20, overall='ok'):
    rows = {}
    if itl_p99 is not None:
        rows['intertoken_p99'] = {'fast': {'p99': itl_p99, 'count': n}}
    if shed is not None:
        rows['shed_fraction'] = {'fast': {'value': shed, 'count': n}}
    return {'slos': rows, 'verdict': {
        'overall': overall,
        'breaches': ['ttft_p99'] if overall == 'breach' else []}}


class TestCanaryJudge:
    def test_no_data_is_pending(self):
        j = fleet.CanaryJudge()
        assert j.judge(None, [])['verdict'] == 'pending'
        assert j.judge(_eval(), [_eval()])['verdict'] == 'pending'

    def test_latency_regression_breaches_and_floor_suppresses(self):
        j = fleet.CanaryJudge(latency_ratio=1.5, latency_floor_ms=5)
        v = j.judge(_eval(itl_p99=0.100), [_eval(itl_p99=0.010)])
        assert v['verdict'] == 'breach'
        assert any('intertoken_p99' in r for r in v['reasons'])
        v = j.judge(_eval(itl_p99=0.00006), [_eval(itl_p99=0.00002)])
        assert v['verdict'] == 'ok'

    def test_incumbent_baseline_is_max(self):
        j = fleet.CanaryJudge(latency_ratio=1.5, latency_floor_ms=5)
        v = j.judge(_eval(itl_p99=0.100),
                    [_eval(itl_p99=0.010), _eval(itl_p99=0.090)])
        assert v['verdict'] == 'ok'

    def test_own_breach_and_shed_delta(self):
        j = fleet.CanaryJudge(shed_delta=0.05)
        v = j.judge(_eval(itl_p99=0.01, overall='breach'),
                    [_eval(itl_p99=0.01)])
        assert v['reasons'][0].startswith('slo_breach:')
        v = j.judge(_eval(shed=0.20), [_eval(shed=0.02)])
        assert any(r.startswith('shed_fraction') for r in v['reasons'])


# ---------------------------------------------------------------------
# the degradation ladder

class _LadderEngine:
    class _Idx:
        def __init__(self):
            self.evicted = 0

        def evict(self, n):
            if self.evicted >= 3:
                return 0
            self.evicted += 1
            return 1

    def __init__(self):
        self.speculative = True
        self.spec_tokens = 4
        self.admit_cap = None
        self._prefix_index = self._Idx()


def test_apply_rung_is_idempotent_and_reversible():
    eng, saved = _LadderEngine(), {}
    fleet.apply_degradation_rung(eng, 3, saved)
    assert eng._prefix_index.evicted == 3
    assert (eng.speculative, eng.spec_tokens, eng.admit_cap) == (False, 2, 1)
    fleet.apply_degradation_rung(eng, 3, saved)
    assert (eng.spec_tokens, eng.admit_cap) == (2, 1)
    fleet.apply_degradation_rung(eng, 0, saved)
    assert (eng.speculative, eng.spec_tokens, eng.admit_cap) \
        == (True, 4, None)


@pytest.mark.parametrize('rung', [-1, 0, 1, 2, 3, 4, 9])
def test_apply_rung_equals_jax(rung):
    a, b = _LadderEngine(), _LadderEngine()
    assert fleet.apply_degradation_rung(a, rung, {}) \
        == jfleet.apply_degradation_rung(b, rung, {})
    assert (a.speculative, a.spec_tokens, a.admit_cap,
            a._prefix_index.evicted) == (b.speculative, b.spec_tokens,
                                         b.admit_cap, b._prefix_index.evicted)


def _strip_t(entries):
    return [{k: v for k, v in e.items() if k != 't'} for e in entries]


@pytest.mark.parametrize('seed', range(6))
def test_degradation_policy_equals_jax(tmp_path, seed):
    rng = np.random.RandomState(seed)
    kw = dict(kv_free_floor=float(rng.choice([0.1, 0.125, 0.3])),
              recover_healthy=int(rng.randint(1, 4)),
              shed_fraction=float(rng.uniform(0.2, 0.8)))
    clk = [0.0]
    pol = fleet.DegradationPolicy(ledger=Ledger(str(tmp_path / 'p.jsonl')),
                                  clock=lambda: clk[0], **kw)
    jpol = jfleet.DegradationPolicy(
        ledger=JLedger(str(tmp_path / 'j.jsonl')), clock=lambda: clk[0],
        **kw)
    moves = []
    for _ in range(60):
        clk[0] += float(rng.uniform(0.1, 2.0))
        overall = ['ok', 'ok', 'ok', 'warn', 'breach', None][rng.randint(6)]
        obs = dict(breaches=(['ttft_p99', 'intertoken_p99'][:rng.randint(3)]
                             if overall == 'breach' else ()))
        if rng.rand() < 0.3:
            obs.update(kv_in_use=int(rng.randint(0, 33)), kv_total=32)
        got = pol.observe(overall, **obs)
        assert got == jpol.observe(overall, **obs)
        moves.append(got)
        rids = ['r%d' % i for i in range(50)]
        assert [pol.sheds(r) for r in rids] == [jpol.sheds(r) for r in rids]
    assert any(m is not None for m in moves)
    assert pol.describe() == jpol.describe()
    assert _strip_t(Ledger.read(str(tmp_path / 'p.jsonl'))) \
        == _strip_t(JLedger.read(str(tmp_path / 'j.jsonl')))


def test_degradation_hysteresis_and_ledger_events(tmp_path):
    led = Ledger(str(tmp_path / 'led.jsonl'))
    pol = fleet.DegradationPolicy(ledger=led, recover_healthy=2,
                                  clock=lambda: 0.0)
    assert pol.observe('ok') is None
    assert pol.observe('breach', breaches=['ttft_p99']) == 1
    assert pol.observe(None, kv_in_use=31, kv_total=32) == 2
    assert pol.observe('breach') == 3
    assert pol.observe('breach') == 4
    assert pol.observe('breach') is None
    assert pol.observe('ok') is None
    assert pol.observe('breach') is None
    assert pol.observe('ok') is None
    assert pol.observe('ok') == 3
    entries = events(Ledger.read(str(tmp_path / 'led.jsonl')), 'degrade')
    assert [(e['direction'], e['to_name']) for e in entries] == [
        ('escalate', 'evict_prefix'), ('escalate', 'no_spec'),
        ('escalate', 'shrink_admission'), ('escalate', 'shed'),
        ('recover', 'shrink_admission')]
    assert entries[1]['reasons'] == ['kv_pressure:3%_free']


# ---------------------------------------------------------------------
# the checkpoint watcher

def _write_snapshot(ckpt_dir, it, scale=1.0):
    os.makedirs(ckpt_dir, exist_ok=True)
    tree = {'params': {'w': np.full((4, 4), scale, np.float32)}}
    return serializers.save_npz(
        os.path.join(ckpt_dir, 'snapshot_iter_%d' % it), tree)


def _corrupt_leaf(path, scale):
    """Flip one byte inside the stored ``w`` leaf: the manifest (and so
    the cheap completeness probe) still reads, the full verify fails."""
    with open(path, 'rb') as f:
        data = bytearray(f.read())
    pattern = np.full((4, 4), scale, np.float32).tobytes()
    at = data.find(pattern)
    assert at >= 0
    data[at + 9] ^= 0xFF
    with open(path, 'wb') as f:
        f.write(bytes(data))


def _watch_sequence(watcher, clk, times):
    out = []
    for t in times:
        clk[0] = t
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            got = watcher.poll()
        kinds = (failure.CheckpointSkippedWarning,
                 jfailure.CheckpointSkippedWarning)
        skipped = [w for w in caught if issubclass(w.category, kinds)]
        out.append((None if got is None
                    else (got[0], os.path.basename(got[1]), got[2]),
                    len(skipped)))
    return out


def test_watcher_sequence_equals_jax(tmp_path):
    """A chain whose newest lacks its sentinel and whose next newest is
    corrupt: both watchers skip the first unseen, reject the second once
    (typed warning) and fire the valid one, at the same polls."""
    ck = str(tmp_path / 'ck')
    _write_snapshot(ck, 2, 1.0)
    _write_snapshot(ck, 4, 2.5)
    _corrupt_leaf(os.path.join(ck, 'snapshot_iter_4.npz'), 2.5)
    np.savez(os.path.join(ck, 'snapshot_iter_6.npz'),
             w=np.zeros(4, np.float32))          # no manifest sentinel
    times = [0.0, 0.2, 1.0, 1.3, 2.0, 3.0]
    clk = [0.0]
    got = _watch_sequence(fleet.CheckpointWatcher(
        ck, debounce_s=0.5, clock=lambda: clk[0]), clk, times)
    want = _watch_sequence(jfleet.CheckpointWatcher(
        ck, debounce_s=0.5, clock=lambda: clk[0]), clk, times)
    assert got == want
    assert [g for g, _ in got if g] == [('npz', 'snapshot_iter_2.npz', 2)]
    assert sum(n for _, n in got) == 1
    # a newer valid snapshot fires next, once
    _write_snapshot(ck, 8, 3.0)
    w = fleet.CheckpointWatcher(ck, debounce_s=0.1, start_after=2,
                                clock=lambda: clk[0])
    seq = _watch_sequence(w, clk, [10.0, 11.0, 12.0])
    assert [g for g, _ in seq] == [None, ('npz', 'snapshot_iter_8.npz', 8),
                                   None]


def test_watcher_fires_once_after_debounce(tmp_path):
    ck = str(tmp_path / 'ck')
    path = _write_snapshot(ck, 2)
    t = [0.0]
    w = fleet.CheckpointWatcher(ck, debounce_s=1.0, clock=lambda: t[0])
    assert w.poll() is None
    t[0] = 0.5
    assert w.poll() is None
    t[0] = 1.5
    assert w.poll()[1:] == (path, 2)
    t[0] = 2.5
    assert w.poll() is None


def test_watcher_mtime_churn_restarts_debounce(tmp_path):
    ck = str(tmp_path / 'ck')
    path = _write_snapshot(ck, 2)
    t = [0.0]
    w = fleet.CheckpointWatcher(ck, debounce_s=1.0, clock=lambda: t[0])
    assert w.poll() is None
    t[0] = 0.9
    os.utime(path, (time.time(), time.time() + 5))
    assert w.poll() is None
    t[0] = 1.5
    assert w.poll() is None
    t[0] = 2.0
    assert w.poll() is not None


# ---------------------------------------------------------------------
# the front's recovery and the supervisor, over stubs

class _Stub:
    def __init__(self, name, state='serving', version=2):
        self.name = name
        self.state = state
        self.version = version

    def shed_total(self):
        return 0

    def stats(self):
        return {'name': self.name}

    def close(self):
        pass


def _stub_front(tmp_path, replicas):
    return fleet.FleetFront(
        replicas, current_version=2,
        journal=fleet.RequestJournal(str(tmp_path / 'j.jsonl')))


def test_recover_expired_deadline_sheds_typed(tmp_path):
    dead = _Stub('replica-1')
    front = _stub_front(tmp_path, [_Stub('replica-0'), dead])
    front.journal.admit('r1', [1, 2], 4, -1.0, 'replica-1', 2)
    led = Ledger(str(tmp_path / 'led.jsonl'))
    assert front.recover(dead, ledger=led) == ([], ['r1'])
    entries = Ledger.read(str(tmp_path / 'led.jsonl'))
    rs = events(entries, 'requeue_shed')[0]
    assert (rs['request_id'], rs['replica'], rs['reason']) \
        == ('r1', 'replica-1', 'deadline')
    assert events(entries, 'recovered')[0]['shed'] == ['r1']
    assert front.journal.inflight() == {}


def test_recover_completed_at_death_resolves_from_journal(tmp_path):
    dead = _Stub('replica-1')
    front = _stub_front(tmp_path, [dead])
    front.journal.admit('r1', [1], 2, None, 'replica-1', 2)
    front.journal.tokens('r1', [8])
    front.journal.tokens('r1', [9])
    h = fleet.FrontHandle('r1')
    front._handles['r1'] = h
    assert front.recover(dead) == ([], [])
    assert list(h.result(timeout=1.0)) == [8, 9]


def test_recover_without_survivor_sheds_no_replica(tmp_path):
    dead = _Stub('replica-0')
    front = _stub_front(tmp_path, [dead])
    front.journal.admit('r1', [1], 4, None, 'replica-0', 2)
    h = fleet.FrontHandle('r1')
    front._handles['r1'] = h
    assert front.recover(dead)[1] == ['r1']
    with pytest.raises(failure.OverloadError) as ei:
        h.result(timeout=1.0)
    assert ei.value.reason == 'no_replica'


def test_supervisor_crash_loop_aborts_within_budget(tmp_path):
    out = str(tmp_path / 'out')
    front = _stub_front(tmp_path, [_Stub('replica-0', state='dead'),
                                   _Stub('replica-1')])
    ctl = fleet.FleetController(front, str(tmp_path / 'ck'), out,
                                boot=('snap2', 2))
    spawned = []

    def spawn_fn(name, path, version, index):
        spawned.append(name)
        return _Stub(name, state='dead', version=version)

    sup = fleet.ReplicaSupervisor(
        ctl, spawn_fn=spawn_fn,
        policy=RestartPolicy(max_restarts=8, crash_window=120.0,
                             crash_threshold=3, shrink_causes=(),
                             backoff=failure.Backoff(initial=0.001,
                                                     max_delay=0.001)))
    for _ in range(5):
        sup.check()
        if sup.aborted:
            break
    assert sup.aborted and sup.deaths == 3
    assert spawned == ['replica-0r1', 'replica-0r2']
    assert 'crash_loop' in sup.abort_reason
    assert len(events(Ledger.read(os.path.join(out, fleet.LEDGER_NAME)),
                      'abort')) == 1
    assert sup.describe()['lost_requests'] == 0


def test_converge_on_restart_records_recovered_roll(tmp_path):
    out = str(tmp_path / 'out')
    led = Ledger(os.path.join(out, fleet.LEDGER_NAME))
    led.append('start', version=2)
    led.append('roll_start', version=4, from_version=2)
    led.append('replica_swap', replica='replica-0', ok=True, roll_version=4)
    front = fleet.FleetFront([_Stub('replica-0', version=4),
                              _Stub('replica-1', version=4)],
                             current_version=4)
    fleet.FleetController(front, str(tmp_path / 'ck'), out,
                          boot=('snap4', 4)).start()
    conv = events(Ledger.read(os.path.join(out, fleet.LEDGER_NAME)),
                  'converged')
    assert len(conv) == 1
    assert (conv[0]['version'], conv[0]['recovered_roll']) == (4, 4)
    assert set(conv[0]['replicas'].values()) == {4}


# ---------------------------------------------------------------------
# the demo model and its trainer against the JAX ones

def test_demo_model_with_the_jax_weights_equals_jax():
    jmodel, jparams = jfleet.demo_params()
    model, _ = fleet.demo_params(device='cpu')
    models.load_flax_variables(model, {'params': jax.device_get(jparams)})
    toks = np.random.RandomState(0).randint(0, 32, size=(3, 9))
    want = np.asarray(jmodel.apply({'params': jparams}, jnp.asarray(toks)))
    with torch.no_grad():
        got = model(torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_demo_train_continues_a_jax_snapshot_as_jax_does(tmp_path):
    jck, pck = str(tmp_path / 'j'), str(tmp_path / 'p')
    jfleet.demo_train(jck, steps=2, snapshot_every=2)
    os.makedirs(pck)
    os.link(os.path.join(jck, 'snapshot_iter_2.npz'),
            os.path.join(pck, 'snapshot_iter_2.npz'))
    jfleet.demo_train(jck, steps=3, snapshot_every=3)
    written = fleet.demo_train(pck, steps=3, snapshot_every=3, device='cpu')
    assert [os.path.basename(p) for p in written] \
        == ['snapshot_iter_3.npz', 'snapshot_iter_5.npz']
    _, template = jfleet.demo_params()
    want = jserializers.load_npz(os.path.join(jck, 'snapshot_iter_5.npz'),
                                 {'params': template})['params']
    got = jserializers.load_npz(written[-1], {'params': template})['params']
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert all(serializers.checkpoint_complete(p) for p in written)


# ---------------------------------------------------------------------
# one booted fleet, served from the JAX package's snapshots

_PROMPTS = [np.asarray(p, np.int32) for p in
            ([3, 1, 4, 1], [5, 9], [2, 6, 5], [3], [5, 8, 9, 7], [9, 3])]
_NEW = 6


def _jax_streams(jeng, prompts, max_new):
    q = JQueue(jeng.max_prompt_len, max_queue=64)
    reqs = [q.submit(p, max_new) for p in prompts]
    for _ in range(3000):
        if all(r.done() for r in reqs):
            break
        jeng.step(q)
    return [[int(t) for t in r.result(timeout=0)] for r in reqs]


def _fleet_streams(front, prompts, max_new):
    handles = [front.submit(p, max_new) for p in prompts]
    return [[int(t) for t in h.result(timeout=RESULT_TIMEOUT)]
            for h in handles]


@pytest.fixture(scope='module')
def booted_fleet(tmp_path_factory):
    """One booted two-replica port fleet on the CPU, from a snapshot the
    JAX package's ``demo_train`` wrote, and the JAX engine that serves the
    same snapshots (its weights swapped in as the chain grows)."""
    tmp = tmp_path_factory.mktemp('fleet')
    ck, out = str(tmp / 'ckpt'), str(tmp / 'out')
    jfleet.demo_train(ck, steps=2, snapshot_every=2)
    jmodel, template = jfleet.demo_params()
    jeng = JEngine.from_checkpoint(
        os.path.join(ck, 'snapshot_iter_2.npz'), jmodel, template,
        n_slots=2, max_prompt_len=4, version=2)
    installed = telemetry.active() is None
    if installed:
        telemetry.enable()
    ctl = fleet.build_local_fleet(
        ck, out, n_replicas=2, canary_seconds=2.5, judge_interval=0.25,
        drain_timeout=30.0, device='cpu',
        judge=fleet.CanaryJudge(latency_ratio=1.5, latency_floor_ms=20.0,
                                min_events=4))
    ctl.watcher.debounce_s = 0.15
    ctl.start()
    yield ctl, ck, out, jeng
    ctl.close()
    if installed:
        telemetry.disable()


def _run_roll(ctl, ck, target_version, rate=40.0, timeout=90.0):
    """A JAX-written snapshot at ``target_version`` under live traffic;
    waits for the controller to handle the roll."""
    traffic = fleet._TrafficGen(ctl.front, rate=rate,
                                max_new_tokens=4).start()
    stop = threading.Event()
    t = threading.Thread(target=ctl.run, args=(stop,), daemon=True)
    t.start()
    try:
        jfleet.demo_train(ck, steps=2, snapshot_every=2)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if ctl.last_handled_version == target_version:
                break
            time.sleep(0.05)
        time.sleep(0.3)
    finally:
        traffic.stop()
        stop.set()
        t.join(timeout=10.0)
    assert not t.is_alive()
    assert ctl.last_handled_version == target_version
    return traffic.stats()


def test_booted_fleet_serves_the_jax_streams(booted_fleet):
    ctl, ck, out, jeng = booted_fleet
    want = _jax_streams(jeng, _PROMPTS, _NEW)
    assert _fleet_streams(ctl.front, _PROMPTS, _NEW) == want


def test_serve_slow_canary_breach_rolls_back(booted_fleet):
    """Snapshot 4 ships a latency regression (``serve_slow`` bites on the
    hot-swapped canary only): the judge breaches on the inter-token
    delta, the canary swaps back, the fleet converges on version 2, no
    request is shed, and the streams are still the JAX engine's at 2."""
    ctl, ck, out, jeng = booted_fleet
    chaos.install(chaos.FaultInjector('serve_slow=*:0.12'))
    try:
        stats = _run_roll(ctl, ck, target_version=4, timeout=120.0)
    finally:
        chaos.uninstall()
    assert stats['served'] > 0 and stats['errors'] == 0
    assert stats['shed_submit'] == stats['shed_result'] == 0
    assert (ctl.rollbacks, ctl.promotes) == (1, 0)
    assert all(r.version == 2 for r in ctl.replicas)
    led = Ledger.read(os.path.join(out, fleet.LEDGER_NAME))
    cv = [e for e in events(led, 'canary_verdict') if e['version'] == 4]
    assert cv[0]['verdict'] == 'breach'
    assert any('intertoken_p99' in r for r in cv[0]['reasons'])
    rb = [e for e in events(led, 'rollback') if e['version'] == 4]
    assert rb[0]['to_version'] == 2
    conv = events(led, 'converged')[-1]
    assert conv['version'] == 2 and set(conv['replicas'].values()) == {2}
    assert _fleet_streams(ctl.front, _PROMPTS, _NEW) \
        == _jax_streams(jeng, _PROMPTS, _NEW)


def test_roll_promotes_with_zero_swap_sheds(booted_fleet):
    """A healthy snapshot (6) rolls canary -> promote under live traffic:
    every request served, no shed attributable to the swaps, the trace
    counts flat, the ledger ladder in order, and the fleet's streams at
    version 6 equal the JAX engine's at 6."""
    ctl, ck, out, jeng = booted_fleet
    traces0 = [r.engine.stats()['decode_trace_count'] for r in ctl.replicas]
    # the judge still reads both arms, but a healthy canary on a loaded
    # CPU must not breach on scheduling noise: the floor sits above it
    judge, ctl.judge = ctl.judge, fleet.CanaryJudge(
        latency_ratio=1.5, latency_floor_ms=250.0, min_events=4)
    try:
        stats = _run_roll(ctl, ck, target_version=6)
    finally:
        ctl.judge = judge
    assert stats['served'] > 0 and stats['errors'] == 0
    assert stats['shed_submit'] == stats['shed_result'] == 0
    assert (ctl.promotes, ctl.rollbacks) == (1, 1)
    assert all(r.version == 6 for r in ctl.replicas)
    assert [r.engine.stats()['decode_trace_count']
            for r in ctl.replicas] == traces0
    led = Ledger.read(os.path.join(out, fleet.LEDGER_NAME))
    v6 = [e['event'] for e in led
          if e.get('version') == 6 or e.get('roll_version') == 6]
    assert v6.index('roll_start') < v6.index('canary_verdict') \
        < v6.index('promote') < v6.index('converged')
    swaps = [e for e in events(led, 'replica_swap') if e['roll_version'] == 6]
    assert {s['replica'] for s in swaps} == {'replica-0', 'replica-1'}
    assert all(s['ok'] and s['shed_during_swap'] == 0 for s in swaps)
    assert ctl.dropped_during_swap == 0
    jeng.swap_from_checkpoint(os.path.join(ck, 'snapshot_iter_6.npz'),
                              version=6)
    assert _fleet_streams(ctl.front, _PROMPTS, _NEW) \
        == _jax_streams(jeng, _PROMPTS, _NEW)


def test_front_sheds_typed_only_when_nothing_serves(booted_fleet):
    ctl = booted_fleet[0]
    saved = [r.state for r in ctl.replicas]
    try:
        for r in ctl.replicas:
            r.state = 'draining'
        with pytest.raises(failure.OverloadError) as ei:
            ctl.front.submit([1, 2], 2)
        assert ei.value.reason == 'no_replica'
    finally:
        for r, s in zip(ctl.replicas, saved):
            r.state = s


# ---------------------------------------------------------------------
# exact-replay recovery of a killed replica, token for token

_RECOVERY_MAXNEW = 10


def _recovery_prompts():
    rng = np.random.RandomState(7)
    base = rng.randint(0, 32, size=2)
    return [np.concatenate([base, rng.randint(0, 32, size=1)])
            for _ in range(5)]


@pytest.fixture(scope='module')
def recovery_seed(tmp_path_factory):
    """A JAX-written demo snapshot and the uninterrupted JAX engine's
    streams of the recovery prompts."""
    ck = str(tmp_path_factory.mktemp('recovery') / 'ckpt')
    jfleet.demo_train(ck, steps=2, snapshot_every=2)
    kind, path, it = recovery.latest_snapshot(ck)
    jmodel, template = jfleet.demo_params()
    jeng = JEngine.from_checkpoint(path, jmodel, template, n_slots=2,
                                   max_prompt_len=12, version=it)
    prompts = _recovery_prompts()
    return ck, path, it, prompts, _jax_streams(jeng, prompts,
                                                _RECOVERY_MAXNEW)


@pytest.mark.parametrize('mode', ['slab', 'paged_prefix', 'speculative'])
def test_replica_kill_midflight_recovers_token_parity(recovery_seed, mode,
                                                      tmp_path):
    """A replica killed mid-decode with >= 4 generations in flight: every
    stream completes equal to the uninterrupted JAX engine's (journaled
    prefix + teacher-forced continuation on the survivor), the ledger
    attributes every requeue, nothing is lost, and the respawned replica
    serves the incumbent version."""
    ck, path, it, prompts, oracle = recovery_seed
    engine_kw = {}
    if mode == 'paged_prefix':
        engine_kw = dict(paged=True, page_size=8)
    elif mode == 'speculative':
        _model, template = fleet.demo_params(device='cpu')
        from chainermn_tpu_torch.serving.engine import load_params
        engine_kw = dict(draft_model=fleet.demo_model(device='cpu'),
                         draft_params=load_params(path, template))
    out = str(tmp_path / 'out')
    ctl = fleet.build_local_fleet(ck, out, n_replicas=2, n_slots=2,
                                  max_prompt_len=12, journal=True,
                                  engine_kw=engine_kw, warmup=False,
                                  device='cpu')
    ctl.start()
    sup = fleet.ReplicaSupervisor(ctl, spawn_fn=fleet.local_respawn_fn(
        n_slots=2, max_prompt_len=12, engine_kw=engine_kw, warmup=False,
        device='cpu'))
    front = ctl.front
    try:
        front.replicas[0].state = 'draining'     # pin to replica-1
        handles = [front.submit(p, _RECOVERY_MAXNEW) for p in prompts]
        front.replicas[0].state = 'serving'
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            inf = front.journal.inflight(replica='replica-1')
            if any(e['emitted'] for e in inf.values()):
                break
            time.sleep(0.002)
        front.replicas[1].kill()
        assert len(front.journal.inflight(replica='replica-1')) >= 4
        sup.check()
        results = [[int(t) for t in h.result(timeout=RESULT_TIMEOUT)]
                   for h in handles]
        assert results == oracle
        entries = Ledger.read(os.path.join(out, fleet.LEDGER_NAME))
        assert events(entries, 'replica_dead')[0]['replica'] == 'replica-1'
        rec = events(entries, 'recovered')[0]
        assert rec['request_ids'] == [e['request_id']
                                      for e in events(entries, 'requeue')]
        assert rec['shed'] == [] and len(rec['request_ids']) >= 4
        assert len(events(entries, 'respawn')) == 1
        assert sup.describe()['lost_requests'] == 0
        replacement = front.replicas[1]
        assert (replacement.name, replacement.version, replacement.state) \
            == ('replica-1r1', it, 'serving')
        h = front.submit(prompts[0], 2)
        assert len(h.result(timeout=RESULT_TIMEOUT)) == 2
    finally:
        sup.stop()
        ctl.close()


def test_local_replica_kill_fails_outstanding_typed(tmp_path):
    """``LocalReplica.kill`` stops the scheduler between ticks and fails
    every outstanding request with ``ReplicaDeadError`` naming them."""
    ck = str(tmp_path / 'ck')
    fleet.demo_train(ck, steps=1, snapshot_every=1, device='cpu')
    ctl = fleet.build_local_fleet(ck, str(tmp_path / 'out'), n_replicas=1,
                                  n_slots=2, max_prompt_len=4, warmup=False,
                                  device='cpu')
    try:
        rep = ctl.replicas[0]
        rep.kill()
        assert rep.state == 'dead' and not rep._thread.is_alive()
        with pytest.raises(failure.ReplicaDeadError):
            rep.submit([1, 2], 3)
        r2 = fleet.LocalReplica('x', rep.engine)
        req = r2.submit([1], 50)      # never started: stays queued
        assert r2.kill() == [req.request_id]
        with pytest.raises(failure.ReplicaDeadError) as ei:
            req.result(timeout=1.0)
        assert ei.value.replica == 'x'
    finally:
        ctl.close()


def test_replica_without_a_device_raises_on_a_cpu_machine(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has a card: the default device exists')
    ck = str(tmp_path / 'ck')
    fleet.demo_train(ck, steps=1, snapshot_every=1, device='cpu')
    with pytest.raises(RuntimeError):
        fleet.build_local_fleet(ck, str(tmp_path / 'out'), n_replicas=1)


# ---------------------------------------------------------------------
# the capture gate: a capture beside other threads' serving calls

def test_capture_gate_orders_captures_against_calls():
    """A capture waits for the calls in flight and holds new calls until
    it ends; calls run side by side; the capturing thread may call and
    nest captures; a capture from inside a call is refused."""
    from chainermn_tpu_torch.serving.engine import CaptureGate
    gate, log = CaptureGate(), []
    in_call, release = threading.Event(), threading.Event()

    def caller(name):
        with gate.call():
            log.append(name + ' in')
            in_call.set()
            assert release.wait(10.0)
            log.append(name + ' out')

    def capturer():
        with gate.capture():
            log.append('capture in')
            with gate.call(), gate.capture():   # the owner: no waiting
                pass
            time.sleep(0.05)
            log.append('capture out')

    a = threading.Thread(target=caller, args=('a',))
    a.start()
    assert in_call.wait(10.0)
    c = threading.Thread(target=capturer)
    c.start()
    time.sleep(0.05)
    assert log == ['a in']              # the capture waits for the call
    release.set()
    c.join(10.0)
    a.join(10.0)
    assert not a.is_alive() and not c.is_alive()
    assert log == ['a in', 'a out', 'capture in', 'capture out']
    # a call arriving during a capture waits for its end
    log.clear()
    started = threading.Event()

    def slow_capture():
        with gate.capture():
            started.set()
            time.sleep(0.1)
            log.append('capture')

    c = threading.Thread(target=slow_capture)
    c.start()
    assert started.wait(10.0)
    with gate.call():
        log.append('call')
    c.join(10.0)
    assert not c.is_alive() and log == ['capture', 'call']
    with gate.call():
        with pytest.raises(RuntimeError, match='wait for itself'):
            with gate.capture():
                pass


def test_capture_gate_pauses_the_cyclic_collector():
    import gc
    from chainermn_tpu_torch.serving.engine import CaptureGate
    gate = CaptureGate()
    assert gc.isenabled()
    with gate.capture():
        assert not gc.isenabled()
        with gate.capture():
            assert not gc.isenabled()
        assert not gc.isenabled()
    assert gc.isenabled()
