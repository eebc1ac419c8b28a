"""The port's paged and speculative ``GenerationEngine`` (plain versions on
the CPU) against the JAX package's engine in the same modes, on the same
weights and prompts, and against the port's own slot and
non-speculative engines: greedy tokens equal, token for token, and the
page accounting (``stats()``, the pool) equal to the JAX engine's.

Every comparison is exact: tokens, page ids, refcounts and counters.
The JAX engines are built once per mode for the whole module.
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
from chainermn_tpu_torch import models, serving
from chainermn_tpu_torch.utils.failure import OverloadError

torch.set_num_threads(2)

PS = 8
PROMPTS = [np.random.RandomState(0).randint(1, 32, size=n).tolist()
           for n in (3, 7, 12, 5, 14, 9)]


@functools.lru_cache(maxsize=None)
def _lm(n_layers):
    """The JAX test suite's tiny LM (``tests/test_serving.py``) and the
    port's model carrying the same weights."""
    cfg = dict(vocab_size=32, d_model=32, n_heads=4, n_layers=n_layers,
               d_ff=32, max_len=64)
    jm = jmodels.TransformerLM(dtype=jnp.float32, **cfg)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    tm = models.TransformerLM(dtype=torch.float32, device='cpu', **cfg)
    models.load_flax_variables(tm, {'params': params})
    return jm, params, tm


def _engine(port, paged=False, chunk=None, spec=None, **kw):
    """A port (``port=True``) or JAX engine: 2 layers, 2 slots, prompts up
    to 16, depth 32 unless ``kw`` says otherwise; ``spec`` the draft's
    depth (the draft at depth = the target's is the target itself)."""
    base = dict(n_slots=2, max_prompt_len=16, max_len=32)
    base.update(kw)
    if paged:
        base.update(paged=True, page_size=PS, prefill_chunk=chunk)
    jm, params, tm = _lm(2)
    if spec is not None:
        dj, dparams, dt = _lm(spec)
        if port:
            base.update(draft_model=dt, draft_params=models.param_tree(dt))
        else:
            base.update(draft_model=dj, draft_params=dparams)
    if port:
        return serving.GenerationEngine(tm, device='cpu', **base)
    return jserving.GenerationEngine(jm, params, **base)


def _queue(eng, port, **kw):
    lib = serving if port else jserving
    return lib.GenerationQueue(max_prompt_len=eng.max_prompt_len,
                               page_size=PS if eng.paged else None, **kw)


def _drain(eng, q, reqs, max_steps=400):
    for _ in range(max_steps):
        if all(r.done() for r in reqs):
            break
        eng.step(q)
    out = []
    for r in reqs:
        try:
            out.append([int(t) for t in r.result(timeout=0)])
        except (OverloadError, JOverloadError) as e:
            out.append(('shed', e.reason))
    return out


def _serve(port, prompts=PROMPTS, n_new=4, sequential=False, **kw):
    """Serve ``prompts`` (all at once, or one after another) on a fresh
    engine; returns ``(tokens, engine)``."""
    eng = _engine(port, **kw)
    q = _queue(eng, port, max_queue=16)
    if sequential:
        out = []
        for p in prompts:
            out += _drain(eng, q, [q.submit(p, n_new)])
        return out, eng
    return _drain(eng, q, [q.submit(p, n_new) for p in prompts]), eng


PAGED_KEYS = ('pages_in_use', 'pages_free', 'peak_pages_in_use',
              'prefill_chunks', 'cow_copies', 'prefix_lookups',
              'prefix_hits', 'prefix_tokens_reused', 'prefills',
              'decode_steps', 'tokens_generated', 'cancelled')


@functools.lru_cache(maxsize=None)
def _jax_run(**kw):
    """The JAX engine's tokens and stats in one mode (once per module)."""
    kw = dict(kw)
    if 'prompts' in kw:
        kw['prompts'] = [list(p) for p in kw['prompts']]
    out, eng = _serve(False, **kw)
    return out, _stats(eng)


def _stats(eng):
    st = eng.stats()
    return {key: st.get(key) for key in PAGED_KEYS}


@pytest.mark.parametrize('int8_kv', [False, True])
def test_paged_engine_matches_jax_and_the_slot_engine(int8_kv):
    """6 prompts through 2 slots (several refills and page reclaims):
    the paged engine's tokens are the JAX paged engine's and the port's
    slot engine's; its page accounting is the JAX engine's."""
    got, eng = _serve(True, paged=True, int8_kv=int8_kv)
    want, jstats = _jax_run(paged=True, int8_kv=int8_kv)
    slot, _ = _serve(True, int8_kv=int8_kv)
    assert got == want == slot
    assert _stats(eng) == jstats
    assert eng.stats()['paged'] is True and eng.stats()['prefilling'] == 0


def test_paged_engine_steps_in_lockstep_with_jax():
    """After every step both engines hold the same requests in the same
    slots at the same positions, through the same page ids."""
    engines = [_engine(False, paged=True), _engine(True, paged=True)]
    queues = [_queue(e, p, max_queue=16)
              for e, p in zip(engines, (False, True))]
    reqs = [[q.submit(p, 4) for p in PROMPTS] for q in queues]

    def state(eng):
        return ({sid: (s.request.seq, s.position, list(s.generated),
                       list(s.pages)) for sid, s in eng._slots.items()},
                {sid: (st.request.seq, st.pos, list(st.pages))
                 for sid, st in eng._prefilling.items()},
                list(eng._free), eng.pool.in_use())

    for step in range(60):
        if all(r.done() for rs in reqs for r in rs):
            break
        assert [e.step(q) for e, q in zip(engines, queues)] \
            == [True, True]
        assert state(engines[0]) == state(engines[1]), 'step %d' % step
    assert all(r.done() for rs in reqs for r in rs)


def test_chunked_prefill_equals_monolithic_and_jax():
    """Chunking is a schedule, not a model change: chunks of 4 give the
    monolithic prefill's tokens and the JAX chunked engine's."""
    prompts = tuple(tuple(p) for p in
                    (np.random.RandomState(1).randint(1, 32, size=n).tolist()
                     for n in (2, 11, 16, 7)))
    mono, _ = _serve(True, prompts=prompts, paged=True)
    got, eng = _serve(True, prompts=prompts, paged=True, chunk=4)
    want, jstats = _jax_run(prompts=prompts, paged=True, chunk=4)
    assert got == mono == want
    assert _stats(eng) == jstats
    assert eng.stats()['prefill_chunks'] > len(prompts)
    assert eng.stats()['prefill_chunk'] == 4


def test_prefix_sharing_capacity_case_like_jax():
    """8 requests of one 24-token prompt in a pool smaller than the slot
    engine's slab (20 usable pages against 8 x 4): the first banks its 3
    full pages, the 7 followers each retain them and copy the boundary
    page once (the JAX package's capacity pin and its numbers)."""
    prompt = np.random.RandomState(2).randint(1, 32, size=24).tolist()
    results = {}
    for port in (True, False):
        eng = _engine(port, paged=True, n_slots=8, max_prompt_len=24,
                      n_pages=21)
        q = _queue(eng, port, max_queue=16)
        first = _drain(eng, q, [q.submit(prompt, 4)])[0]
        banked = eng.pool.in_use()
        followers = [q.submit(prompt, 4) for _ in range(7)]
        samples = []
        for _ in range(64):
            if all(r.done() for r in followers):
                break
            eng.step(q)
            samples.append(eng.pool.in_use())
        outs = _drain(eng, q, followers)
        results[port] = (first, banked, outs, max(samples), _stats(eng))
    first, banked, outs, most, st = results[True]
    assert results[True] == results[False]
    assert banked == 3 and all(o == first for o in outs)
    assert st['prefix_hits'] == 7 and st['cow_copies'] == 7
    assert st['prefix_tokens_reused'] == 7 * 24
    assert most <= 17 < 8 * 4 and st['peak_pages_in_use'] <= 17
    assert st['pages_in_use'] == 3          # only the bank survives


def test_copy_on_write_divergence_matches_the_slot_engine_and_jax():
    """B shares A's banked prefix and diverges inside the boundary page;
    A again over-covers its last banked page, which is demoted to a copy:
    the tokens are the slot engine's and the JAX paged engine's."""
    rng = np.random.RandomState(3)
    a = rng.randint(1, 32, size=12).tolist()
    b = a + rng.randint(1, 32, size=6).tolist()
    prompts = (tuple(a), tuple(b), tuple(a))
    got, eng = _serve(True, prompts=prompts, sequential=True, paged=True,
                      max_prompt_len=18)
    slot, _ = _serve(True, prompts=prompts, sequential=True,
                     max_prompt_len=18)
    want, jstats = _jax_run(prompts=prompts, sequential=True, paged=True,
                               max_prompt_len=18)
    assert got == slot == want
    st = eng.stats()
    assert st['prefix_hits'] == 2 and st['cow_copies'] >= 2
    assert _stats(eng) == jstats


def test_prefix_key_ignores_arrival_order_and_groups_admission():
    rng = np.random.RandomState(5)
    prompts = [rng.randint(1, 32, size=n).tolist()
               for n in (3, 9, 17, 8, 24)]

    def keys(order):
        q = serving.GenerationQueue(max_prompt_len=32, max_queue=16,
                                    page_size=PS)
        return {i: q.submit(prompts[i], 2).prefix_key for i in order}

    first = keys(range(5))
    assert first == keys([4, 2, 0, 3, 1])
    for i, p in enumerate(prompts):
        assert first[i] == serving.prefix_key(p, PS)
        aligned = (len(p) // PS) * PS
        if aligned >= PS:
            assert serving.prefix_key(p[:aligned] + [31], PS) \
                == serving.prefix_key(p[:aligned], PS)
    # co-admission: waiters sharing the head's key are pulled forward,
    # in order, and nothing else is reordered
    head = prompts[2]
    order = [head, prompts[1], head[:16] + [1, 2], prompts[3], head]
    for lib in (serving, jserving):
        q = lib.GenerationQueue(max_prompt_len=32, max_queue=16,
                                page_size=PS)
        reqs = [q.submit(p, 2) for p in order]
        assert q.pop(3, group_prefix=True) == [reqs[0], reqs[2], reqs[4]]
        assert q.pop(3, group_prefix=True) == [reqs[1], reqs[3]]


def test_dry_pool_sheds_kv_pages_and_expiry_mid_prefill_frees_pages():
    """A prompt whose pages the pool cannot hold is shed typed
    (``kv_pages``); a chunked prompt whose deadline passes between chunks
    is shed (``deadline``) and its pages go back -- as in the JAX
    engine."""
    clock = [0.0]
    prompts = [list(range(1, 17)), [3, 4, 5]]
    results = {}
    for port in (True, False):
        eng = _engine(port, paged=True, n_pages=2, prefix_sharing=False)
        q = _queue(eng, port, clock=lambda: clock[0])
        shed = _drain(eng, q, [q.submit(prompts[0], 2)])
        small = _drain(eng, q, [q.submit(prompts[1], 2)])
        eng2 = _engine(port, paged=True, chunk=4, prefix_sharing=False)
        q2 = _queue(eng2, port, clock=lambda: clock[0])
        late = q2.submit(prompts[0], 2, deadline=5.0)
        eng2.step(q2, clock=lambda: clock[0])          # one chunk of four
        in_use = eng2.pool.in_use()
        clock[0] = 10.0
        eng2.step(q2, clock=lambda: clock[0])
        results[port] = (shed, small, in_use, _drain(eng2, q2, [late]),
                         eng2.pool.in_use(), eng.cancelled, eng2.cancelled)
        clock[0] = 0.0
    assert results[True] == results[False]
    shed, small, in_use, late, after, c1, c2 = results[True]
    assert shed == [('shed', 'kv_pages')] and len(small[0]) == 2
    assert in_use == 1 and late == [('shed', 'deadline')] and after == 0
    assert (c1, c2) == (1, 1)


# ---------------------------------------------------------------------
# speculative decoding

SPEC_MODES = [dict(),                                  # slab
              dict(paged=True),                        # paged
              dict(int8_kv=True),                      # int8-KV slab
              dict(paged=True, chunk=4),               # paged + chunked
              dict(paged=True, int8_kv=True)]          # paged + int8-KV


@pytest.mark.parametrize('mode', SPEC_MODES)
def test_speculative_tokens_equal_the_plain_engine_in_every_cache_mode(
        mode):
    """6 prompts through 2 slots with a 1-layer draft: the speculative
    engine's tokens are the non-speculative engine's, token for token."""
    want, _ = _serve(True, n_new=6, **mode)
    got, eng = _serve(True, n_new=6, spec=1, **mode)
    assert got == want
    st = eng.stats()['speculative']
    assert st['verify_steps'] > 0 and st['draft_proposed'] > 0
    assert st['draft_steps'] == 4 * st['verify_steps']


def test_paged_rollback_returns_the_window_pages():
    """After the drain the speculative engine holds as many pool pages as
    the plain one (the JAX package's prompts): pages grown for rejected
    window positions went back to the pool."""
    prompts = tuple(tuple(np.random.RandomState(2).randint(1, 32, size=n))
                    for n in (9, 9, 13, 6))
    _, oracle = _serve(True, prompts=prompts, n_new=6, paged=True)
    _, eng = _serve(True, prompts=prompts, n_new=6, paged=True, spec=1)
    assert eng.pool.in_use() == oracle.pool.in_use()


@pytest.mark.parametrize('paged', [False, True])
def test_speculative_engine_matches_jax(paged):
    """The same accept decisions as the JAX speculative engine: the same
    tokens and the same proposed / accepted counts."""
    got, eng = _serve(True, n_new=6, spec=1, paged=paged)
    jeng = _engine(False, paged=paged, spec=1)
    q = _queue(jeng, False, max_queue=16)
    want = _drain(jeng, q, [q.submit(p, 6) for p in PROMPTS])
    assert got == want
    keys = ('draft_steps', 'verify_steps', 'draft_proposed',
            'draft_accepted', 'accepted_draft_rate')
    st, jst = eng.stats()['speculative'], jeng.stats()['speculative']
    assert {k: st[k] for k in keys} == {k: jst[k] for k in keys}
    st = eng.stats()
    assert _stats(eng) == {key: jeng.stats().get(key) for key in PAGED_KEYS}
    if paged:
        assert eng.pool.in_use() == jeng.pool.in_use()
        assert st['pages_in_use'] == eng.pool.in_use()


def test_perfect_draft_amortizes_the_verify():
    """draft == target: every proposal accepted, and fewer verify passes
    than generated tokens (k = 4 commits up to 4 tokens a pass)."""
    eng = _engine(True, paged=True, spec=2)
    q = _queue(eng, True, max_queue=16)
    _drain(eng, q, [q.submit([3, 5, 7], 8), q.submit([2, 4], 8)])
    st = eng.stats()['speculative']
    assert st['accepted_draft_rate'] == 1.0
    tokens = eng.tokens_generated
    assert st['verify_steps'] < tokens
    assert st['verify_steps'] <= -(-tokens // 2)


def test_eos_inside_an_accepted_prefix_stops_where_the_plain_loop_does():
    out, _ = _serve(True, prompts=([5],), n_new=6)
    eos = out[0][2]
    want, _ = _serve(True, prompts=([5],), n_new=50, eos_id=eos)
    got, _ = _serve(True, prompts=([5],), n_new=50, eos_id=eos, spec=2)
    assert got == want and got[0][-1] == eos and len(got[0]) < 50


def test_window_is_clipped_by_max_new_tokens():
    want, _ = _serve(True, prompts=([7, 9],), n_new=2)
    got, _ = _serve(True, prompts=([7, 9],), n_new=2, spec=2)
    assert got == want and len(got[0]) == 2


def test_speculative_options_are_checked_as_jax_does():
    _, _, dt = _lm(1)
    _, _, tm = _lm(2)
    dparams = models.param_tree(dt)
    cases = [(dict(draft_model=dt), 'draft_params'),
             (dict(draft_params=dparams), 'draft_model'),
             (dict(draft_model=dt, draft_params=dparams, spec_tokens=1),
              'spec_tokens'),
             (dict(draft_model=dt, draft_params=dparams, max_len=80),
              'cover the cache depth')]
    for kw, match in cases:
        with pytest.raises(ValueError, match=match):
            serving.GenerationEngine(tm, n_slots=2, max_prompt_len=8,
                                     device='cpu', **kw)


def test_paged_speculative_warmup_and_signatures():
    """Warmup runs every prefill width, decode and verify bucket of both
    models and leaves the engine idle; the guard takes the paged operand
    signatures and refuses the slot ones; ``stats()`` has the paged
    keys."""
    eng = _engine(True, paged=True, chunk=4, spec=1)
    out = eng.warmup()
    assert sorted(out) == ['decode', 'draft_decode', 'draft_prefill',
                           'prefill', 'verify']
    assert sorted(out['prefill']) == [4] and sorted(out['verify']) == [1, 2]
    assert eng.pool.in_use() == 0 and eng.cow_copies == 0
    pps = eng.pages_per_seq
    z = lambda *s: np.zeros(s, np.int32)  # noqa: E731
    eng.guard_signature((z(2), z(2), z(2, pps)))
    eng.guard_signature((z(1, 4), z(1), z(1, pps)))
    eng.guard_signature((z(1, 4), z(), z(), z(pps)))
    with pytest.raises(RuntimeError, match='no-recompile guard'):
        eng.guard_signature((z(2), z(2)))
    st = eng.stats()
    for key in ('paged', 'page_size', 'n_pages', 'pages_per_seq',
                'pages_in_use', 'pages_free', 'peak_pages_in_use',
                'prefill_chunk', 'prefill_chunks', 'cow_copies',
                'prefilling', 'prefix_lookups', 'prefix_hits',
                'prefix_hit_rate', 'prefix_tokens_reused'):
        assert key in st, key
    assert st['n_pages'] == 1 + 2 * 4 and st['pages_per_seq'] == 4
    got, _ = _serve(True, n_new=3, paged=True, chunk=4, spec=1)
    q = _queue(eng, True, max_queue=16)
    assert _drain(eng, q, [q.submit(p, 3) for p in PROMPTS]) == got
