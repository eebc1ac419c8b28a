"""The serving chaos sites and replica identity of the port.

The queues' ``serve_burst``, the engines' ``serve_slow`` (a host sleep
before a prefill, chunk, decode, speculative tick or batch execute of a
hot-swapped version), the generation engine's ``serve_cancel`` and
``replica_kill`` (decode ticks only), the load generator's
``serve_longprompt`` and the controller's ``swap_kill``; the ``replica`` /
``version`` attributes on every serve record and the engine's flight
table.  Where a site's effect is observable on the host alone (burst
admission, which requests are cancelled, how many sleeps a request
costs), the same script runs through the JAX package and must give the
same answers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import serving as jserving
from chainermn_tpu.models import TransformerLM as JTransformerLM
from chainermn_tpu.utils import chaos as jchaos
from chainermn_tpu_torch import models, serving, telemetry
from chainermn_tpu_torch.serving import fleet
from chainermn_tpu_torch.serving.engine import module_state
from chainermn_tpu_torch.utils import chaos
from chainermn_tpu_torch.utils.failure import OverloadError
from chainermn_tpu_torch.utils.ledger import Ledger

torch.set_num_threads(2)

LM = dict(vocab_size=32, d_model=16, n_heads=2, n_layers=1, d_ff=32,
          max_len=32)


@pytest.fixture(autouse=True)
def _no_chaos():
    yield
    chaos.uninstall()
    jchaos.uninstall()


def _lm():
    return models.TransformerLM(dtype=torch.float32, device='cpu', **LM)


def _gen(model=None, **kw):
    return serving.GenerationEngine(model or _lm(), n_slots=2,
                                    max_prompt_len=8, device='cpu', **kw)


def _drain(eng, q, reqs, steps=200):
    for _ in range(steps):
        if all(r.done() for r in reqs):
            return
        eng.step(q)
    raise AssertionError('requests not done in %d steps' % steps)


class _Exit(Exception):
    pass


def _patch_exit(monkeypatch, module):
    codes = []

    def fake_exit(code):
        codes.append(code)
        raise _Exit(code)

    monkeypatch.setattr(module.os, '_exit', fake_exit)
    return codes


# ---------------------------------------------------------------------
# serve_burst

@pytest.mark.parametrize('spec,max_queue', [('serve_burst=@0:8', 6),
                                            ('serve_burst=@1:3', 8),
                                            ('serve_burst=*:2', 7)])
def test_batch_burst_admission_equals_jax(spec, max_queue):
    def run(pkg_serving, pkg_chaos):
        pkg_chaos.install(pkg_chaos.FaultInjector(spec))
        q = pkg_serving.RequestQueue(max_batch=4, max_wait=10.0,
                                     max_queue=max_queue)
        log = []
        for _ in range(4):
            try:
                q.submit(np.zeros((1, 2), np.float32))
                log.append(('ok', q.depth()))
            except OverloadError as e:
                log.append((e.reason, q.depth()))
            except Exception as e:   # the JAX package's own class
                log.append((getattr(e, 'reason', type(e).__name__),
                            q.depth()))
        pkg_chaos.uninstall()
        return log, q.stats()
    assert run(serving, chaos) == run(jserving, jchaos)


def test_burst_amplifies_through_bounded_admission():
    chaos.install(chaos.FaultInjector('serve_burst=@0:8'))
    q = serving.RequestQueue(max_batch=4, max_wait=10.0, max_queue=6)
    req = q.submit(np.zeros((1, 2), np.float32))
    assert not req.done()
    assert q.depth() == 6
    assert sum(r.synthetic for r in q._waiting) == 5
    with pytest.raises(OverloadError):
        q.submit(np.zeros((1, 2), np.float32))


def test_burst_saturation_degrades_gracefully():
    chaos.install(chaos.FaultInjector('serve_burst=*:4'))
    eng = serving.InferenceEngine.for_model(
        models.MLP(n_units=16, n_in=48, device='cpu'), None,
        np.zeros(48, np.float32), max_batch=8, device='cpu')
    eng.warmup()
    q = serving.RequestQueue(max_batch=8, max_wait=0.001, max_queue=16)
    rep = serving.open_loop(eng, q, rate=2000.0, n_requests=40, seed=3)
    assert rep['served'] + rep['shed_submit'] + rep['shed_deadline'] \
        + rep['errored'] == 40
    assert rep['served'] > 0


@pytest.mark.parametrize('spec', ['serve_burst=@0:8', 'serve_burst=*:1'])
def test_generation_burst_equals_jax(spec):
    def run(pkg_serving, pkg_chaos):
        pkg_chaos.install(pkg_chaos.FaultInjector(spec))
        q = pkg_serving.GenerationQueue(max_prompt_len=8, max_queue=4)
        log = []
        for i in range(3):
            try:
                r = q.submit([1, 2, i], 4)
                log.append(('ok', q.depth(), r.synthetic))
            except Exception as e:
                log.append((e.reason, q.depth(), None))
        pkg_chaos.uninstall()
        return log, q.stats()
    assert run(serving, chaos) == run(jserving, jchaos)


def test_generation_burst_sheds_with_replica_label():
    rec = telemetry.enable()
    try:
        chaos.install(chaos.FaultInjector('serve_burst=@0:8'))
        q = serving.GenerationQueue(max_prompt_len=8, max_queue=4,
                                    label='rep-3')
        q.submit([1, 2], 4)
        assert q.depth() == 4
        sheds = [r for r in rec.events if r.get('name') == 'shed']
        assert sheds and {r['replica'] for r in sheds} == {'rep-3'}
    finally:
        telemetry.disable()


# ---------------------------------------------------------------------
# serve_slow

def _slow_sleeps(monkeypatch, module):
    slept = []
    monkeypatch.setattr(module.time, 'sleep', slept.append)
    return slept


def test_batch_serve_slow_only_after_a_swap(monkeypatch):
    model = models.MLP(n_units=16, n_in=48, device='cpu')
    eng = serving.InferenceEngine.for_model(
        model, None, np.zeros(48, np.float32), max_batch=2, device='cpu',
        label='rep-0', version=3)
    chaos.install(chaos.FaultInjector('serve_slow=*:0.25'))
    slept = _slow_sleeps(monkeypatch, chaos)
    eng.infer(np.zeros((2, 48), np.float32))
    assert slept == []                      # the boot version: never
    eng.swap_params(module_state(model), version=4)
    eng.infer(np.zeros((2, 48), np.float32))
    assert slept == [0.25]
    eng.swap_params(module_state(model), version=3)
    eng.infer(np.zeros((1, 48), np.float32))
    assert slept == [0.25]                  # back at the boot version


def _jax_lm(n_slots=2, max_prompt_len=8, **kw):
    jm = JTransformerLM(dtype=jnp.float32, **LM)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 4), jnp.int32))['params']
    return jserving.GenerationEngine(jm, params, n_slots=n_slots,
                                     max_prompt_len=max_prompt_len,
                                     aot=False, **kw), params


def _slow_script(eng, params, pkg_serving, slept):
    """Swap, then serve three requests; returns the sleeps after each
    tick."""
    eng.swap_params(params, version=eng.param_version + 1)
    q = pkg_serving.GenerationQueue(max_prompt_len=8)
    reqs = [q.submit([1, 2, 3], 3), q.submit([4], 2), q.submit([5, 6], 2)]
    per_tick = []
    for _ in range(50):
        if all(r.done() for r in reqs):
            break
        eng.step(q)
        per_tick.append(len(slept))
    return per_tick


def test_generation_serve_slow_ticks_equal_jax(monkeypatch):
    """One sleep before each prefill and each decode tick of a swapped
    engine, tick for tick as in the JAX engine."""
    jeng, jparams = _jax_lm()
    jchaos.install(jchaos.FaultInjector('serve_slow=*:0.01'))
    jslept = _slow_sleeps(monkeypatch, jchaos)
    want = _slow_script(jeng, jparams, jserving, jslept)
    eng = _gen()
    chaos.install(chaos.FaultInjector('serve_slow=*:0.01'))
    slept = _slow_sleeps(monkeypatch, chaos)
    got = _slow_script(eng, models.param_tree(eng.model), serving, slept)
    assert got == want
    assert got[-1] > 0


@pytest.mark.parametrize('mode', ['paged_chunked', 'speculative'])
def test_generation_serve_slow_sites_per_mode(monkeypatch, mode):
    model = _lm()
    kw = (dict(paged=True, page_size=4, prefill_chunk=2)
          if mode == 'paged_chunked' else
          dict(draft_model=model, draft_params=models.param_tree(model),
               spec_tokens=3))
    eng = _gen(model, **kw)
    chaos.install(chaos.FaultInjector('serve_slow=*:0.01'))
    slept = _slow_sleeps(monkeypatch, chaos)
    q = serving.GenerationQueue(8, page_size=4 if eng.paged else None)
    _drain(eng, q, [q.submit([1, 2, 3, 4, 5], 4)])
    assert slept == []                      # boot version
    eng.swap_params(models.param_tree(model), version=1)
    st0 = eng.stats()
    _drain(eng, q, [q.submit([1, 2, 3, 4, 5], 4)])
    st = eng.stats()
    # one sleep before each prefill call (a chunk when paged) and each
    # decode or speculative tick
    calls = 'prefill_chunks' if eng.paged else 'prefills'
    assert len(slept) == (st[calls] - st0[calls]
                          + st['decode_steps'] - st0['decode_steps'])
    assert len(slept) >= 2
    assert set(slept) == {0.01}


# ---------------------------------------------------------------------
# serve_cancel and replica_kill in step

def test_serve_cancel_chaos_site():
    chaos.install(chaos.FaultInjector('serve_cancel=@1'))
    eng = _gen()
    q = serving.GenerationQueue(max_prompt_len=8)
    victim = q.submit([1], 20)
    eng.step(q)          # occurrence 0: no fire
    eng.step(q)          # occurrence 1: forced mid-generation cancel
    assert victim.done()
    with pytest.raises(OverloadError) as ei:
        victim.result(timeout=0)
    assert ei.value.reason == 'deadline'
    assert eng.stats()['cancelled'] == 1
    assert len(eng._free) == 2


def test_serve_cancel_picks_the_oldest_as_jax_does():
    def run(eng, pkg_serving, pkg_chaos):
        pkg_chaos.install(pkg_chaos.FaultInjector('serve_cancel=@2:1'))
        q = pkg_serving.GenerationQueue(max_prompt_len=8)
        reqs = [q.submit([1, 2], 6), q.submit([3], 6), q.submit([4], 6)]
        for _ in range(30):
            if all(r.done() for r in reqs):
                break
            eng.step(q)
        pkg_chaos.uninstall()
        out = []
        for r in reqs:
            try:
                r.result(timeout=0)
                out.append('served')
            except Exception as e:
                out.append(e.reason)
        return out
    jeng, _ = _jax_lm()
    got = run(_gen(), serving, chaos)
    assert got == run(jeng, jserving, jchaos)
    assert got.count('deadline') == 1


def test_replica_kill_counts_decode_ticks_only(monkeypatch):
    codes = _patch_exit(monkeypatch, chaos)
    monkeypatch.setenv(chaos.REPLICA_ENV_VAR, '0')
    chaos.install(chaos.FaultInjector('replica_kill=@1:0'))
    eng = _gen()
    q = serving.GenerationQueue(max_prompt_len=8)
    for _ in range(3):
        eng.step(q)      # idle ticks: nothing live, nothing counted
    q.submit([1, 2], 6)
    eng.step(q)          # the prefill, then decode tick 0: survives
    assert codes == []
    with pytest.raises(_Exit):
        eng.step(q)      # decode tick 1: dies rc 46
    assert codes == [46]


def test_replica_kill_inert_for_another_index(monkeypatch):
    codes = _patch_exit(monkeypatch, chaos)
    monkeypatch.setenv(chaos.REPLICA_ENV_VAR, '1')
    chaos.install(chaos.FaultInjector('replica_kill=@0:0'))
    eng = _gen()
    q = serving.GenerationQueue(max_prompt_len=8)
    _drain(eng, q, [q.submit([1, 2], 4)])
    assert codes == []


# ---------------------------------------------------------------------
# serve_longprompt

def test_serve_longprompt_injects_max_length_prompts():
    eng = serving.GenerationEngine(
        models.TransformerLM(vocab_size=32, d_model=32, n_heads=4,
                             n_layers=1, d_ff=32, max_len=64,
                             dtype=torch.float32, device='cpu'),
        n_slots=2, max_prompt_len=16, device='cpu')
    q = serving.GenerationQueue(max_prompt_len=16)
    chaos.install(chaos.FaultInjector('serve_longprompt=@1:2'))
    rep = serving.open_loop_generate(eng, q, rate=200.0, n_requests=3,
                                     seed=0, prompt_len_range=(1, 3),
                                     max_new_tokens=2, result_timeout=30.0)
    assert rep['longprompt_injected'] == 2
    assert rep['offered'] == 3
    assert rep['admitted'] == 5
    assert rep['served'] == 5 and rep['errored'] == 0


# ---------------------------------------------------------------------
# swap_kill in the controller

class _StubReplica:
    def __init__(self, name, version):
        self.name = name
        self.state = 'serving'
        self.version = version

    def shed_total(self):
        return 0

    def drain(self, timeout):
        return True

    def swap(self, path, version):
        self.version = version
        return 0.0

    def reset_slo(self):
        pass

    def slo_eval(self):
        return None

    def stats(self):
        return {'name': self.name, 'version': self.version}

    def close(self):
        pass


def test_swap_kill_dies_at_its_swap_point(tmp_path, monkeypatch):
    """``swap_kill=@1:44``: the canary swap survives, the controller dies
    at the first promote swap with every prior ledger entry written --
    the JAX package's mid-roll wreckage."""
    codes = _patch_exit(monkeypatch, chaos)
    out = str(tmp_path / 'out')
    front = fleet.FleetFront([_StubReplica('replica-0', 2),
                              _StubReplica('replica-1', 2)],
                             current_version=2)
    ctl = fleet.FleetController(front, str(tmp_path / 'ck'), out,
                                boot=('snap2', 2), canary_seconds=0.05,
                                judge_interval=0.01)
    ctl.start()
    chaos.install(chaos.FaultInjector('swap_kill=@1:44'))
    with pytest.raises(_Exit):
        ctl.roll('npz', 'snap4', 4)
    assert codes == [44]
    names = [e['event'] for e in Ledger.read(os.path.join(
        out, fleet.LEDGER_NAME))]
    assert names == ['start', 'version_seen', 'roll_start', 'replica_swap',
                     'canary_verdict']
    assert [r.version for r in front.replicas] == [4, 2]


# ---------------------------------------------------------------------
# replica identity on the serve records

def test_batch_version_labels_on_serve_records():
    eng = serving.InferenceEngine.for_model(
        models.MLP(n_units=16, n_in=48, device='cpu'), None,
        np.zeros(48, np.float32), max_batch=2, device='cpu',
        label='rep-7', version=4)
    eng.warmup()
    rec = telemetry.enable()
    try:
        q = serving.RequestQueue(max_batch=2, max_wait=0.001, label='rep-7')
        req = q.submit(np.zeros((1, 48), np.float32))
        for pb in q.take(timeout=1.0):
            eng.serve_packed(pb)
        req.result(timeout=5)
        recs = [r for r in rec.events if r.get('replica') == 'rep-7']
        assert {r.get('version') for r in recs} == {4}
        stages = {r.get('name') for r in recs if r.get('kind') == 'request'}
        assert {'queue_wait', 'bucket_pack', 'execute'} <= stages
    finally:
        telemetry.disable()


@pytest.mark.parametrize('mode', ['slot', 'paged', 'speculative'])
def test_generation_version_labels_on_every_serve_record(mode):
    model = _lm()
    kw = {'slot': {}, 'paged': dict(paged=True, page_size=4),
          'speculative': dict(draft_model=model,
                              draft_params=models.param_tree(model))}[mode]
    eng = _gen(model, label='rep-9', version=5, **kw)
    rec = telemetry.enable()
    try:
        q = serving.GenerationQueue(8, label='rep-9',
                                    page_size=4 if eng.paged else None)
        _drain(eng, q, [q.submit([1, 2, 3], 4), q.submit([4, 5], 3)])
        eng.swap_params(models.param_tree(model), version=6)
        serve = [r for r in rec.events
                 if r.get('kind') in ('request', 'serve')
                 and r.get('name') != 'serve_warmup']
        assert serve
        assert {(r.get('replica'), r.get('version')) for r in serve} \
            == {('rep-9', 5), ('rep-9', 6)}
        assert [r['version'] for r in serve
                if r['name'] == 'weight_swap'] == [6]
        names = {r['name'] for r in serve}
        assert {'queue_wait', 'bucket_pack', 'prefill', 'decode',
                'complete', 'serve_prefill'} <= names
        tick = 'serve_verify' if mode == 'speculative' else 'serve_decode'
        assert tick in names
        if mode == 'speculative':
            assert {'serve_draft', 'serve_spec'} <= names
        assert eng.stats()['label'] == 'rep-9'
    finally:
        telemetry.disable()


def test_unlabelled_engine_records_carry_no_identity():
    eng = _gen()
    rec = telemetry.enable()
    try:
        q = serving.GenerationQueue(8)
        _drain(eng, q, [q.submit([1, 2], 3)])
        assert not [r for r in rec.events if 'replica' in r]
    finally:
        telemetry.disable()


def test_flight_table_names_live_requests(tmp_path):
    eng = _gen()
    rec = telemetry.enable(str(tmp_path))
    try:
        q = serving.GenerationQueue(8)
        r = q.submit([1, 2, 3], 10)
        eng.step(q)
        table = rec.flight_sources['serve_requests']()
        assert [(a['request_id'], a['stage']) for a in table['active']] \
            == [(r.request_id, 'decode')]
        assert table['active'][0]['tokens'] == 2
        path = telemetry.dump_flight('test')
        with open(path) as f:
            assert r.request_id in f.read()
    finally:
        telemetry.disable()


# ---------------------------------------------------------------------
# the hooks themselves, as the JAX package's chaos tests drive them

@pytest.mark.parametrize('spec', [
    'replica_kill=@2:1;serve_slow=*:0.1', 'replica_kill=*',
    'replica_kill=p0.5;swap_kill=@1', None, '', ' replica_kill=@3 ; x=1',
    'serve_burst=@0:8;replica_kill=@0:0;replica_kill2=@1'])
def test_strip_oneshot_kills_equals_jax(spec):
    from chainermn_tpu.serving.fleet import strip_oneshot_kills as jstrip
    assert fleet.strip_oneshot_kills(spec) == jstrip(spec)


def test_swap_kill_fires_at_its_occurrence(monkeypatch):
    codes = _patch_exit(monkeypatch, chaos)
    chaos.install(chaos.FaultInjector('swap_kill=@1:44'))
    chaos.on_swap()
    assert codes == []
    with pytest.raises(_Exit):
        chaos.on_swap(phase='roll')
    assert codes == [44]
    chaos.on_swap()                  # one-shot
    assert codes == [44]


def test_serve_slow_hook_only_bites_swapped_versions(monkeypatch):
    slept = _slow_sleeps(monkeypatch, chaos)
    chaos.install(chaos.FaultInjector('serve_slow=*:0.2'))
    chaos.on_serve_slow(False)
    assert slept == []
    chaos.on_serve_slow(True)
    assert slept == [0.2]


@pytest.mark.parametrize('spec', ['serve_longprompt=@1:2',
                                  'serve_longprompt=@0', 'serve_cancel=@1',
                                  'serve_burst=*:3'])
def test_count_hooks_equal_jax(spec):
    def run(pkg):
        pkg.install(pkg.FaultInjector(spec))
        out = [(pkg.on_serve_longprompt(), pkg.on_serve_cancel(),
                pkg.on_serve_submit()) for _ in range(4)]
        pkg.uninstall()
        return out
    assert run(chaos) == run(jchaos)


def test_replica_kill_star_rule_is_the_crash_loop(monkeypatch):
    codes = _patch_exit(monkeypatch, chaos)
    monkeypatch.setenv(chaos.REPLICA_ENV_VAR, '0')
    chaos.install(chaos.FaultInjector('replica_kill=*'))
    for _ in range(2):
        with pytest.raises(_Exit):
            chaos.on_replica_kill()
    assert codes == [46, 46]
