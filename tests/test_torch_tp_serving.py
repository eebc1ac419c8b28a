"""Tensor-parallel serving: the port's ``tp_axis`` model functions,
``GenerationEngine(plan=, param_specs=)`` and ``InferenceEngine(plan=)``
against the JAX package, from the same flax weights and prompts.

One spawn of two gloo processes (``MeshPlan.create(tp=2)``: each process
holds two of the four heads) runs:

- ``prefill`` / ``decode_step`` on a head-sharded slot cache, and
  ``prefill_paged`` / ``decode_step_paged`` on head-sharded int8 pages,
  against the JAX functions under ``shard_map`` with ``kv_cache_specs``
  (``tests/test_transformer.py``'s tp pins): rtol/atol 1e-5 in f32, 5e-2
  with int8 KV;
- the tp=2 ``GenerationEngine`` in slot, paged + chunked (prefix hits and
  copy-on-write included) and speculative (a replicated one-layer draft)
  modes against the JAX engine under ``MeshPlan.create(tp=2)`` (the
  8-device CPU mesh of ``tests/conftest.py``): greedy tokens equal token
  for token in f32, and both processes' streams and stats equal;
- ``swap_params`` under the plan: the swapped engine serves what a fresh
  engine on the new tree serves;
- ``InferenceEngine`` over a ``(2, 1)`` plan (each process runs half of
  each bucket, undivided buckets dropped, as the JAX
  ``TestShardedServing``) and over a ``(1, 2)`` plan whose ``apply_fn``
  carries its own sums (column- and row-parallel layers, parameters cut
  by ``param_specs``), each against the plain engine at 1e-5.

In this process: ``kv_cache_specs`` against the JAX function, the JAX
engines' typed refusals (int8 weights under specs, a ``tp_axis`` draft,
a plan without a ``tp_axis`` model) raised by the port's, and a plan of
one process serving exactly what the plain engine serves.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from chainermn_tpu import models as jmodels
from chainermn_tpu import precision as jprecision
from chainermn_tpu import serving as jserving
from chainermn_tpu.parallel.meshplan import MeshPlan as JMeshPlan
from chainermn_tpu_torch import models, precision, serving
from chainermn_tpu_torch.parallel import MeshPlan
from torch_spawn import save_tree, spawn

torch.set_num_threads(2)

CFG = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
DRAFT = dict(CFG, n_layers=1)
PS = 8
ENGINE = dict(n_slots=2, max_prompt_len=16, max_len=32)
N_NEW = 6
_RS = np.random.RandomState(3)
_PREFIX = _RS.randint(1, 64, size=10).tolist()
PROMPTS = ([_RS.randint(1, 64, size=n).tolist() for n in (3, 7, 12, 5, 14)]
           + [_PREFIX + _RS.randint(1, 64, size=n).tolist() for n in (2, 4)])
#: the engine modes, as keyword arguments of both packages' engines
MODES = {'slot': {},
         'paged_chunked': dict(paged=True, page_size=PS, prefill_chunk=8),
         'speculative': dict(spec_tokens=3)}
STAT_KEYS = ('prefills', 'decode_steps', 'tokens_generated', 'cancelled',
             'prefill_chunks', 'cow_copies', 'prefix_hits',
             'prefix_tokens_reused', 'pages_in_use', 'peak_pages_in_use')

_BODY = r'''
import json
from chainermn_tpu_torch import models, serving
from chainermn_tpu_torch.parallel import MeshPlan, tensor

params = load_tree(argv[0], 'params/')
draft_params = load_tree(argv[0], 'draft/')
with np.load(argv[0]) as f:
    toks, toks_p = f['tokens'], f['tokens_paged']
cfg, draft_cfg, engine_kw, prompts, modes, n_new, ps = (
    eval(a) for a in argv[1:8])
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
plan = MeshPlan.create(tp=2, device='cpu')
specs = models.tp_param_specs(params, 'model')
with plan.bind():
    model = models.TransformerLM(dtype=torch.float32, device='cpu',
                                 tp_axis='model', **cfg)
    def tensors(tree):
        return {k: tensors(v) if isinstance(v, dict) else T(v)
                for k, v in tree.items()}
    shard = tensors(models.shard_variables(params, specs, plan.mesh))
    with torch.no_grad():
        cache = models.init_kv_cache(model, n_slots=2, device='cpu')
        res['cache_heads'] = np.array(cache['k'].shape[3])
        for s in range(2):
            lg, _ = models.prefill(model, shard, cache, T(toks[s:s + 1, :6]),
                                   6, s)
            res['prefill/%d' % s] = lg.numpy()
        calls = []
        real_all_reduce = dist.all_reduce

        def counting(*a, **kw):
            calls.append(1)
            return real_all_reduce(*a, **kw)

        for p in range(6, 9):
            dist.all_reduce = counting
            lg, _ = models.decode_step(model, shard, cache, T(toks[:, p]),
                                       torch.full((2,), p))
            dist.all_reduce = real_all_reduce
            res['decode/%d' % p] = lg.numpy()
        res['decode_all_reduces'] = np.array(len(calls) // 3)
        pc = models.init_paged_kv_cache(model, n_pages=4, page_size=ps,
                                        int8_kv=True, device='cpu')
        res['paged_scale_heads'] = np.array(pc['k_scale'].shape[3])
        table = torch.tensor([2, 1, 3], dtype=torch.int32)
        lg, _ = models.prefill_paged(model, shard, pc, T(toks_p[:, :9]), 9,
                                     table, 0)
        res['paged/8'] = lg.numpy()
        for p in range(9, 14):
            lg, _ = models.decode_step_paged(
                model, shard, pc, T(toks_p[:, p]), torch.full((1,), p),
                table[None])
            res['paged/%d' % p] = lg[0].numpy()

draft = models.TransformerLM(dtype=torch.float32, device='cpu', **draft_cfg)
models.load_flax_variables(draft, {'params': draft_params})


def serve(eng):
    q = serving.GenerationQueue(max_prompt_len=eng.max_prompt_len,
                                page_size=ps if eng.paged else None)
    reqs = [q.submit(p, n_new) for p in prompts]
    for _ in range(400):
        if all(r.done() for r in reqs):
            break
        eng.step(q)
    return np.array([r.result(timeout=0) for r in reqs])


def engine(mode_kw, tree=params):
    kw = dict(engine_kw, **mode_kw)
    if 'spec_tokens' in kw:
        kw.update(draft_model=draft, draft_params=draft_params)
    return serving.GenerationEngine(model, tree, plan=plan,
                                    param_specs=specs, device='cpu', **kw)


for name, mode_kw in modes.items():
    eng = engine(mode_kw)
    eng.warmup()
    res['tokens/' + name] = serve(eng)
    st = eng.stats()
    res['stats/' + name] = np.array(json.dumps(
        {k: v for k, v in st.items() if k not in ('replays',
                                                  'graph_launches')},
        sort_keys=True, default=str))

# swap_params under the plan: the new (unsharded) tree is cut and copied
scaled = lambda t: ({k: scaled(v) for k, v in t.items()}
                    if isinstance(t, dict) else (t * 0.9).astype(t.dtype))
other = scaled(params)
eng = engine({})
res['swap/version'] = np.array(eng.swap_params(other, version=7))
res['swap/tokens'] = serve(eng)
res['swap/fresh'] = serve(engine({}, other))

# InferenceEngine: half of each bucket a process over a (2, 1) plan, and
# a (1, 2) plan whose apply_fn sums over the model axis itself
rs = np.random.RandomState(4)
mlp = {'w1': rs.randn(48, 32).astype(np.float32) * 0.2,
       'b1': rs.randn(32).astype(np.float32) * 0.1,
       'w2': rs.randn(32, 16).astype(np.float32) * 0.2,
       'b2': rs.randn(16).astype(np.float32) * 0.1}
x = rs.rand(16, 48).astype(np.float32)


def apply(p, x):
    return torch.tanh(x @ p['w1'] + p['b1']) @ p['w2'] + p['b2']


def apply_tp(p, x):
    h = torch.tanh(tensor.column_parallel_dense(x, p['w1'], p['b1']))
    return tensor.row_parallel_dense(h, p['w2'], 'model', p['b2'])


example = np.zeros(48, np.float32)
plain = serving.InferenceEngine(apply, mlp, example, max_batch=16,
                                device='cpu')
res['infer/plain16'] = plain.infer(x).numpy()
res['infer/plain2'] = plain.infer(x[:2]).numpy()
dp = serving.InferenceEngine(apply, mlp, example, max_batch=16,
                             plan=MeshPlan.create(tp=1, device='cpu'),
                             device='cpu')
dp.warmup()
res['infer/dp_edges'] = np.array(dp.edges)
res['infer/dp16'] = dp.infer(x).numpy()
res['infer/dp2'] = dp.infer(x[:2]).numpy()
tp_specs = {'w1': (None, 'model'), 'b1': ('model',),
            'w2': ('model', None), 'b2': ()}
tp = serving.InferenceEngine(apply_tp, mlp, example, max_batch=16,
                             plan=plan, param_specs=tp_specs, device='cpu')
res['infer/tp_w1_cols'] = np.array(tp.params['w1'].shape[1])
res['infer/tp16'] = tp.infer(x).numpy()
res['infer/tp_swap_version'] = np.array(tp.swap_params(
    {k: v * 0.5 for k, v in mlp.items()}, version=2))
res['infer/tp_swapped'] = tp.infer(x).numpy()
res['infer/plain_half'] = serving.InferenceEngine(
    apply, {k: v * 0.5 for k, v in mlp.items()}, example, max_batch=16,
    device='cpu').infer(x).numpy()
'''


@functools.lru_cache(maxsize=None)
def _params(cfg_items, seed):
    jm = jmodels.TransformerLM(dtype=jnp.float32, **dict(cfg_items))
    return jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))['params'])


def _jax_pair():
    plan = JMeshPlan.create(tp=2)
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    return plan, jm, jm.clone(tp_axis=plan.model_axis), _params(
        tuple(CFG.items()), 0)


def _tokens():
    rng = np.random.RandomState(5)
    return (rng.randint(0, 64, size=(2, 9)).astype(np.int32),
            rng.randint(0, 64, size=(1, 14)).astype(np.int32))


def _jax_functions():
    """The JAX tp=2 functions under ``shard_map`` (the pins of
    ``tests/test_transformer.py``) on this module's tokens."""
    plan, oracle, model, params = _jax_pair()
    toks, toks_p = _tokens()
    specs = jmodels.tp_param_specs(params, plan.model_axis)
    pp = jax.device_put(params, plan.param_shardings(specs))
    out = {}
    cache = jmodels.init_kv_cache(model, n_slots=2)
    cspecs = jmodels.kv_cache_specs(cache, plan.model_axis)
    cd = jax.device_put(cache, plan.param_shardings(cspecs))
    pre = jax.jit(jax.shard_map(
        lambda p, c, t, n, s: jmodels.prefill(model, p, c, t, n, s),
        mesh=plan.mesh, in_specs=(specs, cspecs, P(), P(), P()),
        out_specs=(P(), cspecs), check_vma=False))
    dec = jax.jit(jax.shard_map(
        lambda p, c, t, pos: jmodels.decode_step(model, p, c, t, pos),
        mesh=plan.mesh, in_specs=(specs, cspecs, P(), P()),
        out_specs=(P(), cspecs), check_vma=False))
    for s in range(2):
        lg, cd = pre(pp, cd, jnp.asarray(toks[s:s + 1, :6]),
                     jnp.asarray(6), jnp.asarray(s))
        out['prefill/%d' % s] = np.asarray(lg)
    for p in range(6, 9):
        lg, cd = dec(pp, cd, jnp.asarray(toks[:, p]),
                     jnp.full((2,), p, jnp.int32))
        out['decode/%d' % p] = np.asarray(lg)
    cache = jmodels.init_paged_kv_cache(oracle, n_pages=4, page_size=PS,
                                        int8_kv=True)
    cspecs = jmodels.kv_cache_specs(cache, plan.model_axis)
    cd = jax.device_put(cache, plan.param_shardings(cspecs))
    pre = jax.jit(jax.shard_map(
        lambda p, c, t, n, tab, o: jmodels.prefill_paged(
            model, p, c, t, n, tab, o),
        mesh=plan.mesh, in_specs=(specs, cspecs, P(), P(), P(), P()),
        out_specs=(P(), cspecs), check_vma=False))
    dec = jax.jit(jax.shard_map(
        lambda p, c, t, pos, tab: jmodels.decode_step_paged(
            model, p, c, t, pos, tab),
        mesh=plan.mesh, in_specs=(specs, cspecs, P(), P(), P()),
        out_specs=(P(), cspecs), check_vma=False))
    table = np.array([2, 1, 3], np.int32)
    lg, cd = pre(pp, cd, jnp.asarray(toks_p[:, :9]), jnp.asarray(9),
                 jnp.asarray(table), jnp.asarray(0))
    out['paged/8'] = np.asarray(lg)
    for p in range(9, 14):
        lg, cd = dec(pp, cd, jnp.asarray(toks_p[:, p]),
                     jnp.full((1,), p, jnp.int32), jnp.asarray(table[None]))
        out['paged/%d' % p] = np.asarray(lg)[0]
    apply = jax.jit(oracle.apply)
    full = np.asarray(apply({'params': params}, jnp.asarray(toks)))
    full_p = np.asarray(apply({'params': params}, jnp.asarray(toks_p)))[0]
    return out, full, full_p


def _jax_serve(mode):
    """The JAX tp=2 engine's tokens and stats in one mode."""
    plan, _oracle, model, params = _jax_pair()
    kw = dict(ENGINE, **MODES[mode])
    if 'spec_tokens' in kw:
        kw.update(draft_model=jmodels.TransformerLM(dtype=jnp.float32,
                                                    **DRAFT),
                  draft_params=_params(tuple(DRAFT.items()), 1))
    eng = jserving.GenerationEngine(
        model, params, plan=plan,
        param_specs=jmodels.tp_param_specs(params, plan.model_axis), **kw)
    eng.warmup()
    q = jserving.GenerationQueue(max_prompt_len=eng.max_prompt_len,
                                 page_size=PS if eng.paged else None)
    reqs = [q.submit(p, N_NEW) for p in PROMPTS]
    for _ in range(400):
        if all(r.done() for r in reqs):
            break
        eng.step(q)
    return (np.array([np.asarray(r.result(timeout=0)) for r in reqs]),
            eng.stats())


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('tp_serving')
    _plan, _oracle, _model, params = _jax_pair()
    toks, toks_p = _tokens()
    save_tree(tmp / 'in.npz', {'params': params,
                               'draft': _params(tuple(DRAFT.items()), 1)},
              tokens=toks, tokens_paged=toks_p)
    return spawn(tmp, _BODY, 2, [tmp / 'in.npz', CFG, DRAFT, ENGINE,
                                 PROMPTS, MODES, N_NEW, PS], deadline=300)


@pytest.fixture(scope='module')
def jax_functions():
    return _jax_functions()


def test_each_process_holds_its_heads(ranks):
    """Two of the four heads a process, the int8 scales too; a decode
    step makes one all-reduce for the embedding, two a block and one for
    the head."""
    for r in ranks:
        assert int(r['cache_heads']) == CFG['n_heads'] // 2
        assert int(r['paged_scale_heads']) == CFG['n_heads'] // 2
        assert int(r['decode_all_reduces']) == 2 * CFG['n_layers'] + 2


@pytest.mark.parametrize('rank', [0, 1])
def test_tp_prefill_and_decode_match_jax(ranks, jax_functions, rank):
    """f32 slot cache: rtol/atol 1e-5 against the JAX tp functions, and
    against the unsharded full forward."""
    want, full, _ = jax_functions
    got = ranks[rank]
    for key in [k for k in want if not k.startswith('paged')]:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    for s in range(2):
        np.testing.assert_allclose(got['prefill/%d' % s], full[s, 5],
                                   rtol=1e-5, atol=1e-5)
    for p in range(6, 9):
        np.testing.assert_allclose(got['decode/%d' % p], full[:, p],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('rank', [0, 1])
def test_tp_int8_paged_match_jax(ranks, jax_functions, rank):
    """int8 pages sharded on their heads: 5e-2 against the JAX tp paged
    functions and the f32 full forward."""
    want, _, full_p = jax_functions
    got = ranks[rank]
    for p in range(8, 14):
        key = 'paged/%d' % p
        np.testing.assert_allclose(got[key], want[key], rtol=5e-2,
                                   atol=5e-2, err_msg=key)
        np.testing.assert_allclose(got[key], full_p[p], rtol=5e-2,
                                   atol=5e-2, err_msg=key)


@pytest.mark.parametrize('mode', list(MODES))
def test_tp_engine_streams_equal_jax(ranks, mode):
    """Greedy f32 streams of the port's tp=2 engine equal the JAX tp=2
    engine's token for token; both processes served the same streams and
    kept the same counters; the counters match the JAX engine's."""
    want, jstats = _jax_serve(mode)
    r0, r1 = ranks
    np.testing.assert_array_equal(r0['tokens/' + mode], want)
    np.testing.assert_array_equal(r1['tokens/' + mode], want)
    assert str(r0['stats/' + mode]) == str(r1['stats/' + mode])
    st = json.loads(str(r0['stats/' + mode]))
    assert st['tp'] == 2
    for key in STAT_KEYS:
        if key in jstats:
            assert st[key] == jstats[key], key
    if mode == 'paged_chunked':
        assert st['prefix_hits'] >= 1
    if mode == 'speculative':
        assert st['speculative']['verify_steps'] \
            == jstats['speculative']['verify_steps']
        assert st['speculative']['draft_accepted'] \
            == jstats['speculative']['draft_accepted']


def test_swap_params_under_a_plan(ranks):
    for r in ranks:
        assert int(r['swap/version']) == 7
        np.testing.assert_array_equal(r['swap/tokens'], r['swap/fresh'])
    assert not np.array_equal(ranks[0]['swap/tokens'],
                              ranks[0]['tokens/slot'])


def test_inference_engine_over_the_data_axis(ranks):
    """A ``(2, 1)`` plan: undivided buckets dropped, every process
    returns the whole batch, equal to the plain engine at 1e-5."""
    for r in ranks:
        assert list(r['infer/dp_edges']) == [2, 4, 8, 16]
        np.testing.assert_allclose(r['infer/dp16'], r['infer/plain16'],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r['infer/dp2'], r['infer/plain2'],
                                   rtol=1e-5, atol=1e-5)


def test_inference_engine_with_param_specs(ranks):
    """A ``(1, 2)`` plan: each process keeps its columns and rows of the
    MLP (cut by ``param_specs``), the ``apply_fn``'s row-parallel sum
    completes the product; equal to the plain engine at 1e-5, before and
    after a swap of the unsharded tree."""
    for r in ranks:
        assert int(r['infer/tp_w1_cols']) == 16
        np.testing.assert_allclose(r['infer/tp16'], r['infer/plain16'],
                                   rtol=1e-5, atol=1e-5)
        assert int(r['infer/tp_swap_version']) == 2
        np.testing.assert_allclose(r['infer/tp_swapped'],
                                   r['infer/plain_half'], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize('paged', [False, True])
@pytest.mark.parametrize('int8_kv', [False, True])
def test_kv_cache_specs_match_jax(paged, int8_kv):
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    tm = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    if paged:
        jc = jmodels.init_paged_kv_cache(jm, 4, PS, int8_kv=int8_kv)
        tc = models.init_paged_kv_cache(tm, 4, PS, int8_kv=int8_kv,
                                        device='cpu')
    else:
        jc = jmodels.init_kv_cache(jm, 2, max_len=16, int8_kv=int8_kv)
        tc = models.init_kv_cache(tm, 2, max_len=16, int8_kv=int8_kv,
                                  device='cpu')
    want = jmodels.kv_cache_specs(jc, 'model')
    got = models.kv_cache_specs(tc, 'model')
    assert set(got) == set(want)
    for key in want:
        assert got[key] == tuple(want[key]), key
        assert tuple(tc[key].shape) == tuple(jc[key].shape), key
    # the cut of the unsharded cache is what tp=2 builds
    for tp in (1, 2):
        local = (models.init_paged_kv_cache(tm, 4, PS, int8_kv=int8_kv,
                                            tp=tp, device='cpu') if paged
                 else models.init_kv_cache(tm, 2, max_len=16, tp=tp,
                                           int8_kv=int8_kv, device='cpu'))
        jl = (jmodels.init_paged_kv_cache(jm, 4, PS, int8_kv=int8_kv,
                                          tp=tp) if paged
              else jmodels.init_kv_cache(jm, 2, max_len=16, tp=tp,
                                         int8_kv=int8_kv))
        for key in jl:
            assert tuple(local[key].shape) == tuple(jl[key].shape)


def _tp_model(plan, **kw):
    with plan.bind():
        return models.TransformerLM(dtype=torch.float32, device='cpu',
                                    tp_axis='model', **dict(CFG, **kw))


def test_typed_refusals_as_jax():
    """The JAX engines' refusals (``tests/test_serving.py:382-392``,
    ``:791-803``, the draft's ``tp_axis``), raised by the port's with the
    same types."""
    plan = MeshPlan.create(tp=1, size=1)
    tpm = _tp_model(plan)
    params = jax.tree_util.tree_map(np.asarray, _params(tuple(CFG.items()),
                                                        0))
    specs = models.tp_param_specs(params)
    jplan, jm, jtp, jparams = _jax_pair()
    jspecs = jax.tree_util.tree_map(lambda _: P(), jparams)
    with pytest.raises(NotImplementedError):
        serving.GenerationEngine(tpm, params, n_slots=2, max_prompt_len=4,
                                 policy=precision.Int8Policy(), plan=plan,
                                 param_specs=specs, device='cpu')
    with pytest.raises(NotImplementedError):
        jserving.GenerationEngine(jtp, jparams, n_slots=2, max_prompt_len=4,
                                  policy=jprecision.Int8Policy(),
                                  plan=jplan, param_specs=jspecs)
    # int8 KV composes with tp
    assert serving.GenerationEngine(
        tpm, params, n_slots=2, max_prompt_len=4, int8_kv=True, plan=plan,
        param_specs=specs, device='cpu').stats()['int8_kv']
    example = np.zeros(48, np.float32)
    mlp = {'w': np.ones((48, 8), np.float32)}
    with pytest.raises(NotImplementedError):
        serving.InferenceEngine(lambda p, x: x @ p['w'], mlp, example,
                                max_batch=8, policy=precision.Int8Policy(),
                                plan=plan, param_specs={'w': ()},
                                device='cpu')
    draft = _tp_model(plan, n_layers=1)
    with pytest.raises(ValueError, match='without tp_axis'):
        serving.GenerationEngine(tpm, params, n_slots=2, max_prompt_len=4,
                                 draft_model=draft,
                                 draft_params=models.param_tree(draft),
                                 plan=plan, param_specs=specs, device='cpu')
    with pytest.raises(ValueError, match='over a plan'):
        serving.GenerationEngine(tpm, params, n_slots=2, max_prompt_len=4,
                                 device='cpu')
    with pytest.raises(ValueError, match='over a plan'):
        jserving.GenerationEngine(jtp, jparams, n_slots=2, max_prompt_len=4)


@pytest.mark.parametrize('mode', ['slot', 'paged_chunked'])
def test_one_process_plan_serves_the_plain_streams(mode):
    """``MeshPlan.create(tp=1)`` (what one card gives): the plan engine
    over a ``tp_axis`` model serves the plain engine's streams, and
    ``params=None`` takes the model's own weights."""
    plan = MeshPlan.create(tp=1, size=1)
    tpm = _tp_model(plan)
    plain = models.TransformerLM(dtype=torch.float32, device='cpu', **CFG)
    params = models.param_tree(plain)
    out = []
    for eng in (serving.GenerationEngine(plain, **ENGINE, **MODES[mode],
                                         device='cpu'),
                serving.GenerationEngine(
                    tpm, params, plan=plan,
                    param_specs=models.tp_param_specs(params),
                    device='cpu', **ENGINE, **MODES[mode]),
                serving.GenerationEngine(tpm, plan=plan, device='cpu',
                                         **ENGINE, **MODES[mode])):
        q = serving.GenerationQueue(max_prompt_len=16,
                                    page_size=PS if eng.paged else None)
        reqs = [q.submit(p, N_NEW) for p in PROMPTS]
        for _ in range(400):
            if all(r.done() for r in reqs):
                break
            eng.step(q)
        out.append([list(r.result(timeout=0)) for r in reqs])
    assert out[0] == out[1] == out[2]
