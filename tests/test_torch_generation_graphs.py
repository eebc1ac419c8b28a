"""The generation engine's per-bucket CUDA graphs (``GenerationEngine(
aot=)``): what a replay runs, and the engine's warm-up and accounting.

On the CPU no graph can be captured, so the tests run the graph bodies
eagerly, fed through the engine's static operand buffers exactly as a
capture records them, and hold them bit for bit to the model functions
called directly (the engine's path before the graphs); they check that
no body reads a tensor on the host (a capture would raise), that the
prefill functions give the same bits with device scalars as with ints,
and that ``warmup()`` and ``stats()`` have the JAX engine's keys and
types.  The tests marked ``cuda`` capture the graphs on the card:
replays bit-equal to an eager engine in every family, a hot swap into
the captured storage, and a failed capture that raises.

The JAX package is imported inside the one test that compares with it,
so that the file collects on a machine without it (the card's).
"""

import copy
import types

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from chainermn_tpu_torch import models, precision, serving
from chainermn_tpu_torch.ops import _common

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
PS = 8


def _model(seed=0, dtype=torch.float32, device='cpu', **kw):
    return models.TransformerLM(
        dtype=dtype, device=device,
        generator=torch.Generator().manual_seed(seed), **dict(CFG, **kw))


class _Keep(serving.GenerationEngine):
    """Keeps each call's logits (its body's or graph's output) in
    ``kept``, in call order, and the newest in ``last``."""

    def _read(self, logits, ids):
        self.last = logits.clone()
        self.kept = getattr(self, 'kept', []) + [self.last]
        return super()._read(logits, ids)


def _engine(cls=_Keep, spec=False, **kw):
    base = dict(n_slots=4, max_prompt_len=8, max_len=32, device='cpu')
    base.update(kw)
    tm = _model()
    if spec:
        draft = _model(seed=1, n_layers=1)
        base.update(draft_model=draft, draft_params=models.param_tree(draft))
    return cls(tm, **base)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.int32))


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def _same_cache(a, b):
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, CFG['vocab_size'],
                                               n).astype(np.int32)


def _padded(prompt, width):
    tokens = np.zeros((1, width), np.int32)
    tokens[0, :len(prompt)] = prompt
    return tokens


# ---------------------------------------------------------------------
# the prefill functions' device scalars

@pytest.mark.parametrize('int8_kv', [False, True])
def test_slot_prefill_tensor_scalars_bit_equal_to_ints(int8_kv):
    tm = _model()
    params = models.param_tree(tm)
    tokens = _t(_padded(_prompt(5, 0), 8))
    out = []
    with torch.inference_mode():
        for length, slot in ((5, 2), (_t(5), _t(2)), (_t([5]), _t([2]))):
            cache = models.init_kv_cache(tm, 4, 32, int8_kv=int8_kv,
                                         device='cpu')
            logits, cache = models.prefill(tm, params, cache, tokens,
                                           length, slot)
            out.append((logits, cache))
    for logits, cache in out[1:]:
        assert torch.equal(logits, out[0][0])
        _same_cache(cache, out[0][1])
    # the K/V went to slot 2 only
    assert not out[0][1]['k'][:, [0, 1, 3]].any()
    assert out[0][1]['k'][:, 2, :5].any()


@pytest.mark.parametrize('first', [True, False])
def test_paged_prefill_tensor_scalars_bit_equal_to_ints(first):
    """Both variants: a first chunk (``pos0 == 0``) and a continued one
    over a banked context; ``first=None`` decides from the ints."""
    tm = _model()
    params = models.param_tree(tm)
    prompt = _prompt(14, 1)
    table = _t([3, 5, 0, 0])
    cache0 = models.init_paged_kv_cache(tm, 8, PS, device='cpu')
    pos0 = 0 if first else PS
    with torch.inference_mode():
        if not first:       # bank the first page
            models.prefill_paged(tm, params, cache0, _t(prompt[None, :PS]),
                                 PS, table, 0)
        tokens = _t(_padded(prompt[pos0:pos0 + 6], 8))
        out = []
        for length, p0, flag in ((6, pos0, None), (_t(6), _t(pos0), first),
                                 (_t([6]), _t([pos0]), first),
                                 (6, pos0, first)):
            cache = _clone(cache0)
            logits, cache = models.prefill_paged(
                tm, params, cache, tokens, length, table, p0, first=flag)
            out.append((logits, cache))
    for logits, cache in out[1:]:
        assert torch.equal(logits, out[0][0])
        _same_cache(cache, out[0][1])


def test_paged_first_chunk_equals_slot_prefill():
    """The first-chunk variant is the slot prefill's arithmetic."""
    tm = _model()
    params = models.param_tree(tm)
    tokens = _t(_padded(_prompt(7, 2), 8))
    with torch.inference_mode():
        slot = models.init_kv_cache(tm, 1, 32, device='cpu')
        want, _ = models.prefill(tm, params, slot, tokens, 7, 0)
        paged = models.init_paged_kv_cache(tm, 4, PS, device='cpu')
        got, _ = models.prefill_paged(tm, params, paged, tokens, _t(7),
                                      _t([1, 0, 0, 0]), _t(0), first=True)
    assert torch.equal(got, want)
    assert torch.equal(paged['k'][:, 1, :7], slot['k'][:, 0, :7])


# ---------------------------------------------------------------------
# the graph bodies, fed through the static buffers

def _decode_direct(eng, cache, tokens, positions, rows):
    with torch.inference_mode():
        if eng.paged:
            return models.decode_step_paged(eng.model, eng._view(eng.params),
                                            cache, _t(tokens), _t(positions),
                                            _t(rows))[0]
        return models.decode_step(eng.model, eng._view(eng.params), cache,
                                  _t(tokens), _t(positions),
                                  slots=None if rows is None else _t(rows))[0]


def _bank_slots(eng, prompts):
    """Prefill ``prompts`` into slots 0.. through the engine's bodies and,
    on a copy of the cache, through ``models.prefill`` with ints; both
    must agree bit for bit."""
    direct = _clone(eng._cache)
    params = eng._view(eng.params)
    for slot, prompt in enumerate(prompts):
        tokens = _padded(prompt, 8)
        tok = eng._run_prefill(tokens, len(prompt), slot)
        with torch.inference_mode():
            want, _ = models.prefill(eng.model, params, direct, _t(tokens),
                                     len(prompt), slot)
        assert torch.equal(eng.last, want)
        assert tok == int(torch.argmax(want))
    _same_cache(eng._cache, direct)
    return direct


@pytest.mark.parametrize('int8_kv', [False, True])
def test_full_and_compacted_slot_buckets_bit_equal_to_the_model_functions(
        int8_kv):
    eng = _engine(int8_kv=int8_kv)
    prompts = [_prompt(n, 10 + n) for n in (3, 8, 5, 1)]
    direct = _bank_slots(eng, prompts)
    tokens = np.asarray([7, 9, 11, 13], np.int32)
    positions = np.asarray([len(p) for p in prompts], np.int32)
    # the full bucket: row i is slot i
    ids = eng._run_decode(tokens, positions)
    want = _decode_direct(eng, direct, tokens, positions, None)
    assert torch.equal(eng.last, want)
    assert ids.tolist() == torch.argmax(want, -1).tolist()
    _same_cache(eng._cache, direct)
    # a compacted bucket: rows 0, 1 read slots 2 and 0
    rows = np.asarray([2, 0], np.int32)
    tok2, pos2 = tokens[[2, 0]] + 1, positions[[2, 0]] + 1
    ids = eng._run_decode(tok2, pos2, rows)
    want = _decode_direct(eng, direct, tok2, pos2, rows)
    assert torch.equal(eng.last, want)
    assert ids.tolist() == torch.argmax(want, -1).tolist()
    _same_cache(eng._cache, direct)


def _paged_setup(eng):
    """Sequence A (11 tokens) banked from position 0 in pages 1, 2;
    sequence B shares A's first page and prefills its own 5 tokens from
    position 8 (a continued chunk over the shared prefix) into page 3.
    Runs through the bodies and, on a copy, through ``prefill_paged``
    with ints; returns the copy and the two tables."""
    direct = _clone(eng._cache)
    params = eng._view(eng.params)
    a = _prompt(11, 20)
    b = np.concatenate([a[:PS], _prompt(5, 21)])
    tables = np.zeros((2, eng.pages_per_seq), np.int32)
    tables[0, :2] = [1, 2]
    tables[1, :2] = [1, 3]
    for row, prompt, pos0 in ((0, a, 0), (1, b, PS)):
        chunk = prompt[pos0:]
        tokens = _padded(chunk, 8 if len(chunk) <= 8 else 16)
        tok = eng._run_prefill(tokens, len(chunk), (pos0, tables[row]))
        with torch.inference_mode():
            want, _ = models.prefill_paged(eng.model, params, direct,
                                           _t(tokens), len(chunk),
                                           _t(tables[row]), pos0)
        assert torch.equal(eng.last, want)
        assert tok == int(torch.argmax(want))
    _same_cache(eng._cache, direct)
    return direct, tables, (len(a), len(b))


@pytest.mark.parametrize('int8_kv', [False, True])
def test_paged_bucket_with_pad_rows_and_a_shared_prefix(int8_kv):
    eng = _engine(paged=True, page_size=PS, max_prompt_len=16,
                  int8_kv=int8_kv)
    direct, tables, lengths = _paged_setup(eng)
    # bucket 4: the two live rows, then two pad rows on the scratch page
    rows = np.zeros((4, eng.pages_per_seq), np.int32)
    rows[:2] = tables
    tokens = np.asarray([5, 6, 0, 0], np.int32)
    positions = np.asarray(list(lengths) + [0, 0], np.int32)
    ids = eng._run_decode(tokens, positions, rows)
    want = _decode_direct(eng, direct, tokens, positions, rows)
    assert torch.equal(eng.last, want)
    assert ids.tolist() == torch.argmax(want, -1).tolist()
    _same_cache(eng._cache, direct)


@pytest.mark.parametrize('paged', [False, True])
def test_verify_window_bit_equal_to_the_model_functions(paged):
    kw = dict(paged=True, page_size=PS, max_prompt_len=16) if paged else {}
    eng = _engine(spec=True, **kw)
    if paged:
        direct, rows, lengths = _paged_setup(eng)
        positions = np.asarray(lengths, np.int32)
    else:
        prompts = [_prompt(n, 30 + n) for n in (6, 4, 8, 2)]
        direct = _bank_slots(eng, prompts)
        rows = np.asarray([3, 1], np.int32)
        positions = np.asarray([2, 4], np.int32)
    window = np.random.RandomState(3).randint(
        1, CFG['vocab_size'], (2, eng.spec_tokens)).astype(np.int32)
    ids = eng._run_verify(window, positions, rows)
    with torch.inference_mode():
        fn = models.spec_verify_paged if paged else models.spec_verify
        args = (_t(rows),) if paged else ()
        kw = {} if paged else dict(slots=_t(rows))
        want, _ = fn(eng.model, eng._view(eng.params), direct, _t(window),
                     _t(positions), *args, **kw)
    assert torch.equal(eng.last, want)
    assert ids.tolist() == torch.argmax(want, -1).tolist()
    _same_cache(eng._cache, direct)


@pytest.mark.parametrize('int8_kv', [False, True])
def test_verify_window_past_the_depth_writes_only_inside_it(int8_kv):
    """A window of 4 at position 7 of a depth-9 cache writes positions 7
    and 8 (its first two columns, as a decode step there would) and
    leaves every other position as it was."""
    tm = _model()
    params = models.param_tree(tm)
    with torch.inference_mode():
        cache = models.init_kv_cache(tm, 2, 9, int8_kv=int8_kv,
                                     device='cpu')
        models.prefill(tm, params, cache, _t(_prompt(7, 4)[None]), 7, 0)
        before = _clone(cache)
        window = _t(np.asarray([[5, 6, 7, 8]], np.int32))
        models.spec_verify(tm, params, cache, window, _t([7]),
                           slots=_t([0]))
        step = _clone(before)
        for j in range(2):
            models.decode_step(tm, params, step, window[:, j], _t([7 + j]),
                               slots=_t([0]))
    for key in cache:
        assert torch.equal(cache[key][:, 0, :7], before[key][:, 0, :7])
        assert torch.equal(cache[key][:, 1], before[key][:, 1])
    # the window's K at positions 7, 8 is what the decode steps wrote
    # there up to rounding (the verify attends the window at once)
    np.testing.assert_allclose(cache['k'][:, 0, 7:].float().numpy(),
                               step['k'][:, 0, 7:].float().numpy(),
                               rtol=1e-4, atol=1e-4 if not int8_kv else 1.0)
    assert cache['k'][:, 0, 8].any()


class _NoHostRead(TorchFunctionMode):
    """Raises on any operation that reads a tensor on the host or whose
    output shape depends on tensor values: under a CUDA graph capture
    each would raise (or freeze a value into the graph)."""

    READS = {'__int__', '__bool__', '__float__', '__index__', 'item',
             'tolist', 'numpy', 'nonzero', 'masked_select', 'unique',
             'argwhere', 'cpu'}

    def __torch_function__(self, func, types_, args=(), kwargs=None):
        name = getattr(func, '__name__', '')
        kwargs = kwargs or {}
        if name in self.READS:
            raise AssertionError('host read in a graph body: %s' % name)
        if name in ('__getitem__', '__setitem__', 'index_put_',
                    'index_put') and self._bool_index(args[1:2]):
            raise AssertionError('boolean-mask indexing in a graph body')
        if name == 'repeat_interleave' and len(args) > 1 \
                and torch.is_tensor(args[1]):
            raise AssertionError('repeat_interleave by a tensor')
        return func(*args, **kwargs)

    @staticmethod
    def _bool_index(index):
        flat = []
        for item in index:
            flat.extend(item if isinstance(item, (tuple, list)) else [item])
        return any(torch.is_tensor(t) and t.dtype == torch.bool
                   for t in flat)


@pytest.mark.parametrize('mode', ['slot', 'paged', 'spec_slot', 'spec_paged',
                                  'int8'])
def test_no_graph_body_reads_the_host(mode):
    kw = {'slot': {}, 'int8': dict(int8_kv=True,
                                   policy=precision.Int8Policy.bf16()),
          'paged': dict(paged=True, page_size=PS, prefill_chunk=4)}
    spec = mode.startswith('spec')
    if mode == 'spec_paged':
        kw[mode] = dict(paged=True, page_size=PS)
    eng = _engine(spec=spec, **kw.get(mode, {}))
    eng.warmup()
    assert len(eng._calls) == sum(len(keys) for f in eng._families()
                                  for _, keys in eng._warm_keys(f))
    for call in eng._calls.values():
        with _NoHostRead():
            call.eager()


def test_the_no_host_read_mode_catches_the_old_forms():
    """The check above is not vacuous: an int slot read from a tensor and
    the boolean-mask write that the verify pass had are caught."""
    t = torch.tensor([3])
    with pytest.raises(AssertionError, match='host read'):
        with _NoHostRead():
            int(t)
    x = torch.zeros(4)
    with pytest.raises(AssertionError, match='boolean-mask'):
        with _NoHostRead():
            x[x > 0] = 1.0


# ---------------------------------------------------------------------
# warm-up and accounting

def test_eager_engine_reports_no_graph():
    eng = _engine(cache_dir='unused', aot=True)
    out = eng.warmup()
    assert out == {'prefill': {1: False, 2: False, 4: False, 8: False},
                   'decode': {1: False, 2: False, 4: False}}
    st = eng.stats()
    assert st['aot'] == out and st['aot_requested'] is True
    assert st['cache_persistent'] is False and st['cache_dir'] == 'unused'
    assert st['compile_count'] == 0 and st['replays'] == {}
    assert eng.replayed_launches() == {}
    assert eng.warmup() == out          # prepared buckets are skipped
    q = serving.GenerationQueue(max_prompt_len=8)
    req = q.submit([3, 4, 5], 3)
    eng.step(q)
    with pytest.raises(RuntimeError, match='idle engine'):
        eng._calls.clear()
        eng.warmup()
    while not req.done():
        eng.step(q)


def test_release_tickets_hands_a_streams_counters_over():
    fake = types.SimpleNamespace(cuda_stream=0xfeed)
    counters = torch.zeros(4, dtype=torch.int32)
    _common._TICKETS[(torch.device('cpu'), fake.cuda_stream)] = counters
    assert _common.release_tickets(fake) is counters
    assert _common.release_tickets(fake) is None
    with _common.capture_tickets(counters):
        assert _common._CAPTURE.tickets is counters
    assert getattr(_common._CAPTURE, 'tickets', None) is None


def _jax_engine(kw):
    jax = pytest.importorskip('jax')
    jnp = pytest.importorskip('jax.numpy')
    jmodels = pytest.importorskip('chainermn_tpu.models')
    jserving = pytest.importorskip('chainermn_tpu.serving')
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    params = jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])
    kw = dict(kw)
    if kw.pop('spec', False):
        dm = jmodels.TransformerLM(dtype=jnp.float32,
                                   **dict(CFG, n_layers=1))
        dparams = jax.device_get(jax.jit(dm.init)(
            jax.random.PRNGKey(1), jnp.zeros((1, 4), jnp.int32))['params'])
        kw.update(draft_model=dm, draft_params=dparams)
    return jserving.GenerationEngine(jm, params, **kw)


def _shape(tree):
    """Keys and leaf types of a nested dict (ints and bools as such)."""
    if isinstance(tree, dict):
        return {k: _shape(v) for k, v in tree.items()}
    return type(tree).__name__


@pytest.mark.parametrize('mode', ['slot', 'paged', 'chunked', 'spec'])
def test_warmup_and_stats_aot_match_the_jax_engine(mode):
    """The warm-up fault: ``warmup()`` returns the JAX engine's
    ``{family: {bucket: aot}}``, with the same families, buckets and
    types, and ``stats()`` carries the same ``aot`` tables."""
    kw = dict(n_slots=2, max_prompt_len=8, max_len=32)
    kw.update({'slot': {}, 'paged': dict(paged=True, page_size=PS),
               'chunked': dict(paged=True, page_size=PS, prefill_chunk=4),
               'spec': dict(spec=True)}[mode])
    jeng = _jax_engine(dict(kw, aot=False))
    port = dict(kw)
    eng = _engine(cls=serving.GenerationEngine, spec=port.pop('spec', False),
                  **port)
    jout, out = jeng.warmup(), eng.warmup()
    assert _shape(out) == _shape(jout)
    assert {f: sorted(b) for f, b in out.items()} == \
        {f: sorted(b) for f, b in jout.items()}
    jst, st = jeng.stats(), eng.stats()
    assert _shape(st['aot']) == _shape(jst['aot'])
    for key in ('aot_requested', 'cache_persistent', 'prefill_trace_count',
                'decode_trace_count', 'compile_count'):
        assert type(st[key]) is type(jst[key]), key
    if mode == 'spec':
        spec, jspec = st['speculative'], jst['speculative']
        assert _shape(spec['aot']) == _shape(jspec['aot'])
        for key in ('draft_decode_buckets', 'verify_buckets'):
            assert spec[key] == jspec[key], key
        for key in ('draft_trace_count', 'verify_trace_count'):
            assert type(spec[key]) is type(jspec[key]), key


def test_open_loop_generate_warms_the_engine_first():
    eng = _engine(cls=serving.GenerationEngine)
    q = serving.GenerationQueue(max_prompt_len=8, max_queue=8)
    rep = serving.open_loop_generate(eng, q, rate=1e6, n_requests=3,
                                     seed=1, prompt_len_range=(1, 8),
                                     max_new_tokens=2)
    assert rep['served'] == 3
    st = eng.stats()
    assert st['prefill_buckets'] == [1, 2, 4, 8]
    assert st['decode_buckets'] == [1, 2, 4]


# ---------------------------------------------------------------------
# on the card: the graphs themselves

@pytest.fixture
def cuda():
    """Decided when the test runs, never at import: skip without a card."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: run on the card with '
                    '`python -m pytest -m cuda tests/test_torch_*.py`')


# d_head 32: a width the card's kernels take
CUDA_CFG = dict(vocab_size=64, d_model=64, n_heads=2, n_layers=2, d_ff=128,
                max_len=64)
CUDA_MODES = {
    'slot': {},
    'paged': dict(paged=True, page_size=16),
    'chunked': dict(paged=True, page_size=16, prefill_chunk=8),
    'spec': dict(paged=True, page_size=16, spec=True),
    'int8_weights': dict(policy='int8'),
    'int8_kv': dict(int8_kv=True),
}


def _cuda_engine(mode, aot, seed=0, params=None):
    kw = dict(CUDA_MODES[mode])
    policy = (precision.Int8Policy.bf16() if kw.pop('policy', None)
              else precision.Policy.bf16())
    tm = models.TransformerLM(dtype=torch.bfloat16, device='cuda',
                              generator=torch.Generator().manual_seed(seed),
                              **CUDA_CFG)
    if kw.pop('spec', False):
        draft = models.TransformerLM(
            dtype=torch.bfloat16, device='cuda',
            generator=torch.Generator().manual_seed(seed + 1),
            **dict(CUDA_CFG, n_layers=1))
        kw.update(draft_model=draft, draft_params=models.param_tree(draft))
    return _Keep(tm, params, n_slots=4, max_prompt_len=16, max_len=64,
                 policy=policy, aot=aot, **kw)


def _serve_cuda(eng, n_new=6):
    q = serving.GenerationQueue(max_prompt_len=16,
                                page_size=16 if eng.paged else None)
    rng = np.random.RandomState(4)
    reqs = [q.submit(rng.randint(0, CUDA_CFG['vocab_size'], n), n_new)
            for n in (3, 16, 9, 1, 12, 5)]
    for _ in range(200):
        if all(r.done() for r in reqs):
            break
        eng.step(q)
    return [r.result(timeout=0).tolist() for r in reqs]


def _twice(eng):
    """Every prepared call run twice more on zero operands (the idle
    engine's warm-up writes): ``{key: (logits, logits)}``."""
    out = {}
    for key in sorted(eng._calls, key=repr):
        call = eng._calls[key]
        call.stage(eng._zero_operands(key))
        first = call.run()[0].clone()
        out[key] = (first, call.run()[0].clone())
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize('mode', sorted(CUDA_MODES))
def test_replays_bit_equal_to_eager_in_every_family(cuda, mode):
    graphed, eager = _cuda_engine(mode, True), _cuda_engine(mode, False)
    aot = graphed.warmup()
    assert all(all(b.values()) for b in aot.values())
    assert not any(any(b.values()) for b in eager.warmup().values())
    assert _serve_cuda(graphed) == _serve_cuda(eager)
    assert len(graphed.kept) == len(eager.kept)
    for got, want in zip(graphed.kept, eager.kept):
        assert torch.equal(got, want)
    assert graphed.stats()['compile_count'] == sum(
        len(keys) for f in graphed._families()
        for _, keys in graphed._warm_keys(f))
    g2, e2 = _twice(graphed), _twice(eager)
    assert g2.keys() == e2.keys()
    for key in g2:
        assert torch.equal(g2[key][0], g2[key][1]), key
        assert torch.equal(g2[key][0], e2[key][0]), key


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['slot', 'int8_weights'])
def test_swap_params_into_captured_storage_equals_a_fresh_engine(cuda,
                                                                 mode):
    eng = _cuda_engine(mode, True)
    eng.warmup()
    compiles = eng.stats()['compile_count']
    new = copy.deepcopy(models.param_tree(eng.model))
    rng = np.random.RandomState(9)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict)
                else v + 0.05 * torch.from_numpy(rng.standard_normal(
                    tuple(v.shape)).astype(np.float32)).to(v.device)
                for k, v in tree.items()}

    new = perturb(new)
    eng.swap_params(new)
    assert eng.stats()['compile_count'] == compiles
    fresh = _cuda_engine(mode, True, params=new)
    fresh.warmup()
    assert _serve_cuda(eng) == _serve_cuda(fresh)
    for got, want in zip(eng.kept, fresh.kept):
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_a_failed_capture_raises_and_never_runs_eagerly(cuda, monkeypatch):
    from chainermn_tpu_torch.serving import generate
    decode_step = generate.decode_step

    def syncing(model, params, cache, tokens, positions, slots=None):
        float(tokens.sum())          # a host read: a capture must fail
        return decode_step(model, params, cache, tokens, positions, slots)

    monkeypatch.setattr(generate, 'decode_step', syncing)
    eng = _cuda_engine('slot', True)
    with pytest.raises(RuntimeError):
        eng.warmup()
    zeros = np.zeros((4,), np.int32)
    with pytest.raises(RuntimeError):
        eng._run_decode(zeros, zeros)
    assert eng._calls[('decode', 4)].graph is None
    assert not eng._calls[('decode', 4)].ran
    assert eng.stats()['aot']['decode'][4] is False
