"""The whole slice: the port's ``GenerationEngine`` (plain versions on the
CPU) against the JAX package's ``GenerationEngine`` on the same weights
and prompts, token for token and tick for tick.

Both engines run the same scheduler over the same bucket geometry, so
besides the tokens the tests compare, after every ``step``, which
request sits in which slot at which position and which slots are free:
refill at the next step, the free middle slot of the full bucket, eos
and deadline expiry all show there.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import models as jmodels
from chainermn_tpu import serving as jserving
from chainermn_tpu.utils.failure import OverloadError as JOverloadError
from chainermn_tpu_torch import models, precision, serving
from chainermn_tpu_torch.utils.failure import OverloadError

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)


@functools.lru_cache(maxsize=None)
def _pair():
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    tm = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    models.load_flax_variables(tm, {'params': params})
    return jm, params, tm


def _engines(**kw):
    jm, params, tm = _pair()
    kw.setdefault('n_slots', 4)
    kw.setdefault('max_prompt_len', 8)
    return (jserving.GenerationEngine(jm, params, **kw),
            serving.GenerationEngine(tm, device='cpu', **kw))


def _state(eng):
    """Which request (by admission seq) sits in which slot, at which
    position with how many tokens; and the free list."""
    return ({sid: (s.request.seq, s.position, list(s.generated))
             for sid, s in eng._slots.items()}, list(eng._free))


def _lockstep(engines, queues, reqs, clock=None, max_steps=40):
    """Step both engines until every request is done, comparing their
    state after every step; returns the number of steps."""
    kw = {} if clock is None else dict(clock=clock)
    for n in range(max_steps):
        if all(r.done() for rs in reqs for r in rs):
            return n
        worked = [eng.step(q, **kw) for eng, q in zip(engines, queues)]
        assert worked[0] == worked[1]
        assert _state(engines[0]) == _state(engines[1]), 'step %d' % n
    raise AssertionError('requests not done in %d steps' % max_steps)


def _results(reqs):
    out = []
    for r in reqs:
        try:
            out.append([int(t) for t in r.result(timeout=0)])
        except (OverloadError, JOverloadError) as e:
            out.append(('shed', e.reason))
    return out


def _greedy_reference(tm, prompt, n_new):
    toks, out = [int(t) for t in prompt], []
    with torch.no_grad():
        for _ in range(n_new):
            tok = int(torch.argmax(tm(torch.tensor([toks]))[0, -1]))
            out.append(tok)
            toks.append(tok)
    return out


def test_engine_matches_jax_token_for_token():
    """Four prompts fill the four slots; the second finishes after one
    decode step, so a MIDDLE slot is free while three live slots bucket
    up to the full (in-place) bucket; two more requests refill freed
    slots at the next step."""
    engines = _engines()
    queues = [jserving.GenerationQueue(max_prompt_len=8),
              serving.GenerationQueue(max_prompt_len=8)]
    prompts = ([3, 7, 11], [2, 9], [13, 1, 4, 6], [8, 8, 5], [1],
               [5, 6, 7, 8, 9, 10, 11, 12])
    n_new = (6, 2, 6, 6, 3, 5)
    reqs = [[q.submit(p, n) for p, n in zip(prompts, n_new)]
            for q in queues]
    jeng, eng = engines
    for e, q in zip(engines, queues):
        e.step(q)                 # four prefills + one decode step
    assert reqs[1][1].done() and eng._free == [1] == jeng._free
    assert _state(jeng) == _state(eng)
    for e, q in zip(engines, queues):
        e.step(q)                 # the refill: request 5 takes slot 1
    assert eng._slots[1].request is reqs[1][4]
    assert _state(jeng) == _state(eng)
    _lockstep(engines, queues, reqs)
    want = _results(reqs[0])
    assert _results(reqs[1]) == want
    _, _, tm = _pair()
    for got, p, n in zip(want, prompts, n_new):
        assert got == _greedy_reference(tm, p, n)
    js, st = jeng.stats(), eng.stats()
    for key in ('prefills', 'decode_steps', 'tokens_generated',
                'cancelled', 'active_slots', 'prefill_edges',
                'decode_edges', 'decode_buckets'):
        assert st[key] == js[key], key


def test_eos_stops_like_jax():
    _, _, tm = _pair()
    eos = _greedy_reference(tm, [5], 3)[2]     # the third token emitted
    engines = _engines(n_slots=2, eos_id=eos)
    queues = [jserving.GenerationQueue(max_prompt_len=8),
              serving.GenerationQueue(max_prompt_len=8)]
    reqs = [[q.submit([5], 20), q.submit([9, 3], 4)] for q in queues]
    _lockstep(engines, queues, reqs)
    got = _results(reqs[1])
    assert got == _results(reqs[0])
    assert got[0][-1] == eos and len(got[0]) == 3


def test_deadline_expiry_sheds_typed_like_jax():
    clock = [0.0]
    engines = _engines(n_slots=1)
    queues = [jserving.GenerationQueue(max_prompt_len=8,
                                       clock=lambda: clock[0]),
              serving.GenerationQueue(max_prompt_len=8,
                                      clock=lambda: clock[0])]
    reqs = [[q.submit([1], 100, deadline=5.0), q.submit([2], 3),
             q.submit([4], 3, deadline=0.5)] for q in queues]
    for e, q in zip(engines, queues):
        e.step(q, clock=lambda: clock[0])   # the doomed one takes slot 0
    clock[0] = 10.0                          # both deadlines pass
    _lockstep(engines, queues, reqs, clock=lambda: clock[0])
    got = _results(reqs[1])
    assert got == _results(reqs[0])
    assert got[0] == ('shed', 'deadline') == got[2]
    with pytest.raises(OverloadError) as ei:
        reqs[1][0].result(timeout=0)
    assert ei.value.reason == 'deadline'
    assert engines[1].cancelled == 1 == engines[0].cancelled
    assert queues[1].shed_deadline == 1 == queues[0].shed_deadline


def test_int8_kv_engine_matches_jax():
    engines = _engines(n_slots=2, int8_kv=True)
    queues = [jserving.GenerationQueue(max_prompt_len=8),
              serving.GenerationQueue(max_prompt_len=8)]
    reqs = [[q.submit(p, 4) for p in ([3, 1, 4], [1, 5, 9, 2, 6], [5])]
            for q in queues]
    _lockstep(engines, queues, reqs)
    assert _results(reqs[1]) == _results(reqs[0])
    assert engines[1]._cache['k'].dtype == torch.int8


def test_bf16_policy_casts_the_weights_and_serves():
    _, _, tm = _pair()
    eng = serving.GenerationEngine(tm, n_slots=2, max_prompt_len=8,
                                   policy=precision.Policy.bf16(),
                                   device='cpu')
    assert eng.params['block_0']['qkv']['kernel'].dtype == torch.bfloat16
    assert eng.params['lm_head']['kernel'].dtype == torch.bfloat16
    assert tm.block_0.qkv.kernel.dtype == torch.float32   # untouched
    q = serving.GenerationQueue(max_prompt_len=8)
    reqs = [q.submit([3, 1, 4], 5), q.submit([2], 2)]
    for _ in range(10):
        eng.step(q)
    assert [len(r.result(timeout=0)) for r in reqs] == [5, 2]


def test_warmup_runs_every_bucket_and_leaves_the_engine_idle():
    _, eng = _engines(n_slots=4, max_prompt_len=8)
    out = eng.warmup()
    assert sorted(out['prefill']) == [1, 2, 4, 8]
    assert sorted(out['decode']) == [1, 2, 4]
    st = eng.stats()
    assert st['prefill_buckets'] == [1, 2, 4, 8]
    assert st['decode_buckets'] == [1, 2, 4]
    assert st['prefills'] == 0 and st['decode_steps'] == 0
    assert eng._free == [0, 1, 2, 3]
    # warmup garbage is never attended: greedy output is unchanged
    q = serving.GenerationQueue(max_prompt_len=8)
    req = q.submit([3, 7, 11], 4)
    while not req.done():
        eng.step(q)
    _, _, tm = _pair()
    assert [int(t) for t in req.result()] == _greedy_reference(
        tm, [3, 7, 11], 4)


def test_signature_guard_refuses_off_bucket_shapes():
    _, eng = _engines(n_slots=4, max_prompt_len=8)
    with pytest.raises(RuntimeError, match='no-recompile guard'):
        eng.guard_signature((np.zeros((3,), np.int32),
                             np.zeros((3,), np.int32)))
    with pytest.raises(RuntimeError, match='no-recompile guard'):
        eng.guard_signature((np.zeros((1, 5), np.int32), np.int32(5),
                             np.int32(0)))
    # on-bucket shapes pass, as numpy arrays or tensors
    eng.guard_signature((np.zeros((1, 8), np.int32), np.int32(5),
                         np.int32(0)))
    eng.guard_signature((torch.zeros(2, dtype=torch.int32),) * 3)
    eng.guard_signature((torch.zeros(4, dtype=torch.int32),) * 2)


def test_entry_point_without_a_device_raises(monkeypatch):
    _, _, tm = _pair()
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        serving.GenerationEngine(tm, n_slots=2, max_prompt_len=8)


@pytest.mark.parametrize('kw', [dict(plan=object()),
                                dict(param_specs={})])
def test_unported_modes_raise(kw):
    _, _, tm = _pair()
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        serving.GenerationEngine(tm, n_slots=2, max_prompt_len=8,
                                 device='cpu', **kw)


def _other_vocab_draft():
    draft = models.TransformerLM(dtype=torch.float32, device='cpu',
                                 **dict(CFG, vocab_size=16, n_layers=1))
    return dict(draft_model=draft, draft_params=models.param_tree(draft))


@pytest.mark.parametrize('kw,match', [
    (dict(prefill_chunk=4), 'requires paged'),
    (dict(n_pages=8), 'requires paged'),
    (dict(paged=True, prefill_chunk=16), 'exceeds max_prompt_len'),
    ('other_vocab_draft', 'vocab')])
def test_paged_and_speculative_options_are_checked_as_jax_does(kw, match):
    """The JAX constructor's typed ValueErrors, raised by both engines."""
    jm, params, tm = _pair()
    if kw == 'other_vocab_draft':
        kw = _other_vocab_draft()
        jd = jmodels.TransformerLM(dtype=jnp.float32,
                                   **dict(CFG, vocab_size=16, n_layers=1))
        jkw = dict(draft_model=jd, draft_params=jax.device_get(
            jax.jit(jd.init)(jax.random.PRNGKey(1),
                             jnp.zeros((1, 4), jnp.int32))['params']))
    else:
        jkw = kw
    with pytest.raises(ValueError, match=match):
        serving.GenerationEngine(tm, n_slots=2, max_prompt_len=8,
                                 device='cpu', **kw)
    with pytest.raises(ValueError, match=match):
        jserving.GenerationEngine(jm, params, n_slots=2, max_prompt_len=8,
                                  **jkw)


def test_unported_methods_raise():
    """Tensor-parallel serving still raises (ROADMAP.md A7).  Int8
    weights, ``swap_params`` and ``from_checkpoint``, which raised before
    they were ported, now serve: a drained engine swaps to a new version,
    and a missing checkpoint is an ``OSError``, not a refusal."""
    _, _, tm = _pair()
    for kw in (dict(plan=object()), dict(param_specs={})):
        with pytest.raises(NotImplementedError, match='A7'):
            serving.GenerationEngine(tm, n_slots=2, max_prompt_len=8,
                                     device='cpu', **kw)
    _, eng = _engines(n_slots=2)
    assert eng.swap_params(models.param_tree(tm), version=3) == 3
    with pytest.raises(OSError):
        serving.GenerationEngine.from_checkpoint('x', tm, None)
    int8 = serving.GenerationEngine(tm, n_slots=2, max_prompt_len=8,
                                    policy=precision.Int8Policy(),
                                    device='cpu')
    assert int8.stats()['quantized']


# ---------------------------------------------------------------------
# the queue

def test_queue_bounded_over_length_and_close():
    q = serving.GenerationQueue(max_prompt_len=4, max_queue=2)
    q.submit([1, 2], 4)
    with pytest.raises(ValueError, match='exceeds'):
        q.submit([1, 2, 3, 4, 5], 4)
    late = q.submit([3], 4)
    with pytest.raises(OverloadError) as ei:
        q.submit([4], 4)
    assert ei.value.reason == 'queue_full' and q.shed_queue_full == 1
    q.close()
    with pytest.raises(OverloadError) as ei:
        late.result(timeout=0)
    assert ei.value.reason == 'shutdown'
    with pytest.raises(OverloadError):
        q.submit([1], 4)


def test_bucket_geometry_matches_jax():
    for n in (1, 5, 8, 32, 100):
        assert serving.bucket_edges(n) == jserving.bucket_edges(n)
    edges = serving.bucket_edges(32)
    for k in (1, 3, 17, 32):
        assert serving.bucket_of(k, edges) == jserving.bucket_of(k, edges)
    with pytest.raises(ValueError, match='exceeds'):
        serving.bucket_of(33, edges)
    assert serving.next_request_id() != serving.next_request_id()


def test_streaming_callback_sees_every_token():
    _, eng = _engines(n_slots=2)
    q = serving.GenerationQueue(max_prompt_len=8)
    seen = []
    req = q.submit([3, 7], 4, on_token=lambda rid, toks: seen.extend(toks))
    while not req.done():
        eng.step(q)
    assert seen == [int(t) for t in req.result()]


def test_single_token_request_frees_its_slot_at_prefill_like_jax():
    """``max_new_tokens=1`` resolves at admission: the slot goes back
    to the free list without a decode step, and the next request takes
    it at the same tick's admission on both engines."""
    engines = _engines(n_slots=2)
    queues = [jserving.GenerationQueue(max_prompt_len=8),
              serving.GenerationQueue(max_prompt_len=8)]
    reqs = [[q.submit(p, n) for p, n in (([4, 2], 1), ([7], 3),
                                         ([1, 1, 3], 1), ([6, 5], 2))]
            for q in queues]
    _lockstep(engines, queues, reqs)
    got = _results(reqs[1])
    assert got == _results(reqs[0])
    assert [len(t) for t in got] == [1, 3, 1, 2]
    _, _, tm = _pair()
    assert got[0] == _greedy_reference(tm, [4, 2], 1)
    assert engines[1].stats()['prefills'] == 4
