"""The port's parallel primitives against the JAX package's.

One spawn of four gloo processes runs, on ``(dp, sp)`` meshes of
processes (2, 2) and (1, 4), ring and Ulysses attention (causal and
not: the outputs and the gradients of ``sum(out ** 2)`` summed over the
ring), Ulysses' refusal of indivisible heads, and
``mapped_global_loss`` over a sequence-parallel ``TransformerLM`` (both
schemes; the mean form and the token-weighted sum form with uneven
padding, value and every gradient after ``sum_grads``); and, on
``(dp, tp)`` meshes (2, 2) and (1, 4), ``tp_mlp``, ``tp_attention`` and
``tp_transformer_block`` (values, and the gradients the JAX package
takes from outside ``shard_map``).  The JAX side runs the same functions
under ``shard_map`` on the host devices that ``conftest.py`` forces.

Tolerances: the JAX tests' own for these functions (``test_parallel.py``:
2e-4 on attention values, 1e-3 on its gradients) and rtol 1e-5 (atol
1e-6) on the model losses and gradients in f32.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import models as jmodels
from chainermn_tpu.parallel import (mapped_global_loss, ring_attention,
                                    tp_attention, tp_mlp,
                                    tp_transformer_block,
                                    ulysses_attention)

import torch
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

WORLD = 4
SIZES = [2, 4]
B, T, H, D = 2, 32, 8, 16
CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
LM_B, LM_T, PAD = 2, 16, 0
TP_B, TP_T, TP_H, TP_DH, TP_D, TP_FF = 2, 16, 8, 4, 32, 64

_BODY = r'''
from chainermn_tpu_torch import models
from chainermn_tpu_torch.parallel import (
    ProcessMesh, mapped_global_loss, ring_attention, sum_grads,
    tp_attention, tp_mlp, tp_transformer_block, ulysses_attention)
from chainermn_tpu_torch.parallel.sequence import share_sum

inp = dict(np.load(argv[0]))
params = load_tree(argv[0], 'params/')
cfg = eval(argv[1])
T = lambda k: torch.from_numpy(inp[k])


def put(key, t):
    res[key] = t.detach().numpy()


for sp in (2, 4):
    mesh = ProcessMesh((4 // sp, sp), ('dp', 'sp'))
    with mesh.bind():
        for scheme, fn in (('ring', ring_attention),
                           ('ulysses', ulysses_attention)):
            for causal in (0, 1):
                q, k, v = [mesh.local(T(n), (None, 'sp')).clone()
                           .requires_grad_() for n in 'qkv']
                out = fn(q, k, v, 'sp', causal=bool(causal))
                (out ** 2).sum().backward()
                key = 'attn/%s/%d/%d/' % (scheme, sp, causal)
                put(key + 'out', out)
                for name, t in zip('qkv', (q, k, v)):
                    put(key + 'd' + name, t.grad)
        x6 = torch.zeros(1, 4, 6, 8)
        try:
            ulysses_attention(x6, x6, x6, 'sp')
            res['indivisible/%d' % sp] = np.array('')
        except ValueError as e:
            res['indivisible/%d' % sp] = np.array(str(e))
    toks, tgts = T('lm_tokens'), T('lm_targets')
    for scheme in ('ring', 'ulysses'):
        model = models.TransformerLM(dtype=torch.float32, device='cpu',
                                     sequence_axis='sp', sp_scheme=scheme,
                                     **cfg)
        models.load_flax_variables(model, {'params': params})
        for weighted in (0, 1):
            if weighted:
                fn = models.lm_loss_sum(model, pad_id=0)
            else:
                fn = models.lm_loss(model)
            mapped = mapped_global_loss(fn, mesh, ('dp', 'sp'),
                                        token_weighted=bool(weighted))
            model.zero_grad(set_to_none=True)
            loss = mapped(toks, tgts)
            loss.backward()
            sum_grads(list(model.parameters()), mesh)
            key = 'lm/%s/%d/%d/' % (scheme, sp, weighted)
            put(key + 'loss', loss)
            for name, p in model.named_parameters():
                put(key + 'grad/' + name.replace('.', '/'), p.grad)

# tensor parallelism: the JAX package's "outside" gradients -- each
# process seeds its share (1/tp) of the replicated loss, and the
# replicated inputs' gradients are summed over the axis
SPECS = {'x': (), 'w_in': (None, 'tp'), 'b_in': ('tp',),
         'w_out': ('tp', None), 'b_out': (),
         'wqkv': (None, None, 'tp'), 'wo': ('tp', None), 'bo': (),
         'ln1_scale': (), 'ln1_bias': (), 'ln2_scale': (), 'ln2_bias': ()}
for tp in (2, 4):
    mesh = ProcessMesh((4 // tp, tp), ('dp', 'tp'))
    with mesh.bind():
        def run(name, fn, names, prefix):
            args = {n: mesh.local(T(prefix + n), SPECS[n]).clone()
                    .requires_grad_() for n in names}
            out = fn(args)
            loss = share_sum((out ** 2).sum(), 'tp') / tp
            loss.backward()
            sum_grads([args[n] for n in names if not SPECS[n]], mesh, 'tp')
            key = 'tp/%s/%d/' % (name, tp)
            put(key + 'out', out)
            for n in names:
                put(key + 'd' + n, args[n].grad)

        run('mlp', lambda a: tp_mlp(a['x'], a['w_in'], a['b_in'],
                                    a['w_out'], a['b_out'], 'tp'),
            ['x', 'w_in', 'b_in', 'w_out', 'b_out'], 'mlp/')
        for causal in (0, 1):
            run('attn%d' % causal, lambda a: tp_attention(
                a['x'], a['wqkv'], a['wo'], 'tp', n_heads=8,
                causal=bool(causal), bo=a['bo']),
                ['x', 'wqkv', 'wo', 'bo'], 'blk/')
        blk = ['x', 'ln1_scale', 'ln1_bias', 'wqkv', 'wo', 'bo',
               'ln2_scale', 'ln2_bias', 'w_in', 'b_in', 'w_out', 'b_out']
        run('block', lambda a: tp_transformer_block(
            a['x'], {k: v for k, v in a.items() if k != 'x'}, 'tp',
            n_heads=8), blk, 'blk/')
'''

TP_SPECS = {'x': P(), 'w_in': P(None, 'tp'), 'b_in': P('tp'),
            'w_out': P('tp', None), 'b_out': P(),
            'wqkv': P(None, None, 'tp'), 'wo': P('tp', None), 'bo': P(),
            'ln1_scale': P(), 'ln1_bias': P(), 'ln2_scale': P(),
            'ln2_bias': P()}
DIMS = {'w_in': 1, 'b_in': 0, 'w_out': 0, 'wqkv': 2, 'wo': 0}


def _inputs():
    rng = np.random.RandomState(0)
    out = {n: rng.randn(B, T, H, D).astype(np.float32) for n in 'qkv'}
    rng = np.random.RandomState(4)
    out.update({
        'mlp/x': rng.randn(5, 16).astype(np.float32),
        'mlp/w_in': (rng.randn(16, 32) * 0.3).astype(np.float32),
        'mlp/b_in': (rng.randn(32) * 0.1).astype(np.float32),
        'mlp/w_out': (rng.randn(32, 16) * 0.3).astype(np.float32),
        'mlp/b_out': (rng.randn(16) * 0.1).astype(np.float32)})
    rng = np.random.RandomState(2)
    d, ff, h, dh = TP_D, TP_FF, TP_H, TP_DH
    out.update({
        'blk/x': (rng.randn(TP_B, TP_T, d) * 0.5).astype(np.float32),
        'blk/ln1_scale': (1 + 0.1 * rng.randn(d)).astype(np.float32),
        'blk/ln1_bias': (0.1 * rng.randn(d)).astype(np.float32),
        'blk/wqkv': (rng.randn(d, 3, h, dh) * 0.2).astype(np.float32),
        'blk/wo': (rng.randn(h * dh, d) * 0.2).astype(np.float32),
        'blk/bo': (rng.randn(d) * 0.1).astype(np.float32),
        'blk/ln2_scale': (1 + 0.1 * rng.randn(d)).astype(np.float32),
        'blk/ln2_bias': (0.1 * rng.randn(d)).astype(np.float32),
        'blk/w_in': (rng.randn(d, ff) * 0.2).astype(np.float32),
        'blk/b_in': (rng.randn(ff) * 0.1).astype(np.float32),
        'blk/w_out': (rng.randn(ff, d) * 0.2).astype(np.float32),
        'blk/b_out': (rng.randn(d) * 0.1).astype(np.float32)})
    rng = np.random.RandomState(9)
    toks = rng.randint(1, CFG['vocab_size'], (LM_B, LM_T)).astype(np.int32)
    tgts = rng.randint(1, CFG['vocab_size'], (LM_B, LM_T)).astype(np.int32)
    tgts[0, 3:] = PAD            # uneven padding over the shards
    tgts[1, 13:] = PAD
    out.update(lm_tokens=toks, lm_targets=tgts)
    return out


@functools.lru_cache(maxsize=None)
def _lm_params():
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    return jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])


@pytest.fixture(scope='module')
def inputs():
    return _inputs()


@pytest.fixture(scope='module')
def ranks(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp('parallel')
    save_tree(tmp / 'inputs.npz', {'params': _lm_params()}, **inputs)
    return spawn(tmp, _BODY, WORLD, [tmp / 'inputs.npz', repr(CFG)])


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


def _gathered(ranks, key, sp, dim):
    """The sp ranks' shards of one row of the mesh, concatenated."""
    return np.concatenate([ranks[r][key] for r in range(sp)], axis=dim)


# ------------------------------------------------------------- attention
@pytest.mark.parametrize('causal', [0, 1])
@pytest.mark.parametrize('sp', SIZES)
@pytest.mark.parametrize('scheme', ['ring', 'ulysses'])
def test_sequence_attention_matches_jax(ranks, inputs, scheme, sp, causal):
    fn = {'ring': ring_attention, 'ulysses': ulysses_attention}[scheme]
    mesh = _mesh((sp,), ('sp',))
    q, k, v = (jnp.asarray(inputs[n]) for n in 'qkv')

    def mapped(q, k, v):
        def f(q, k, v):
            out = fn(q, k, v, 'sp', causal=bool(causal))
            return out, jax.lax.psum(jnp.sum(out ** 2), 'sp')
        return jax.shard_map(f, mesh=mesh, in_specs=(P(None, 'sp'),) * 3,
                             out_specs=(P(None, 'sp'), P()),
                             check_vma=False)(q, k, v)

    out, _ = jax.jit(mapped)(q, k, v)
    grads = jax.jit(jax.grad(lambda *a: mapped(*a)[1],
                             argnums=(0, 1, 2)))(q, k, v)
    key = 'attn/%s/%d/%d/' % (scheme, sp, causal)
    # every data row of the mesh computes the same thing
    for row in range(WORLD // sp):
        rows = ranks[row * sp:(row + 1) * sp]
        np.testing.assert_allclose(_gathered(rows, key + 'out', sp, 1),
                                   np.asarray(out), rtol=2e-4, atol=2e-4)
        for name, g in zip('qkv', grads):
            np.testing.assert_allclose(
                _gathered(rows, key + 'd' + name, sp, 1), np.asarray(g),
                rtol=1e-3, atol=1e-3, err_msg=name)
    # and the dense oracle
    scores = jnp.einsum('bqhd,bkhd->bhqk', q, k) * D ** -0.5
    if causal:
        scores = jnp.where(np.tril(np.ones((T, T), bool))[None, None],
                           scores, -1e30)
    ref = jnp.einsum('bhqk,bkhd->bqhd', jax.nn.softmax(scores, -1), v)
    np.testing.assert_allclose(_gathered(ranks, key + 'out', sp, 1),
                               np.asarray(ref), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize('sp', SIZES)
def test_ulysses_refuses_indivisible_heads(ranks, sp):
    """6 heads: 2 processes split them, 4 cannot (the JAX message)."""
    mesh = _mesh((sp,), ('sp',))
    x = jnp.zeros((1, 4 * sp, 6, 8), jnp.float32)
    jax_msg = ''
    try:
        jax.jit(jax.shard_map(
            lambda q, k, v: ulysses_attention(q, k, v, 'sp'), mesh=mesh,
            in_specs=(P(None, 'sp'),) * 3, out_specs=P(None, 'sp'),
            check_vma=False))(x, x, x)
    except ValueError as e:
        jax_msg = str(e)
    for res in ranks:
        got = str(res['indivisible/%d' % sp])
        assert got == jax_msg
        assert bool(got) == (sp == 4)
        if got:
            assert 'ring_attention instead' in got


# ------------------------------------------------------ the mapped loss
@pytest.mark.parametrize('weighted', [0, 1])
@pytest.mark.parametrize('sp', SIZES)
@pytest.mark.parametrize('scheme', ['ring', 'ulysses'])
def test_mapped_global_loss_matches_jax(ranks, inputs, scheme, sp,
                                        weighted):
    jm = jmodels.TransformerLM(dtype=jnp.float32, sequence_axis='sp',
                               sp_scheme=scheme, **CFG)
    apply_fn = functools.partial(lambda p, t: jm.apply({'params': p}, t))
    fn = (jmodels.lm_loss_sum(apply_fn, pad_id=PAD) if weighted
          else jmodels.lm_loss(apply_fn))
    mesh = _mesh((WORLD // sp, sp), ('dp', 'sp'))
    mapped = mapped_global_loss(fn, mesh, P('dp', 'sp'),
                                token_weighted=bool(weighted))
    toks = jnp.asarray(inputs['lm_tokens'])
    tgts = jnp.asarray(inputs['lm_targets'])
    loss, grads = jax.jit(jax.value_and_grad(mapped))(
        _lm_params(), toks, tgts)
    want = flat_tree(jax.device_get(grads))
    key = 'lm/%s/%d/%d/' % (scheme, sp, weighted)
    for res in ranks:
        np.testing.assert_allclose(res[key + 'loss'], float(loss),
                                   rtol=1e-5)
        got = {k[len(key + 'grad/'):]: v for k, v in res.items()
               if k.startswith(key + 'grad/')}
        assert sorted(got) == sorted(want)
        for name, g in got.items():
            np.testing.assert_allclose(g, want[name], rtol=1e-5, atol=1e-6,
                                       err_msg=name)
    if weighted:
        # the pmean of per-shard means would differ under this padding
        mean_of_means = mapped_global_loss(
            jmodels.lm_loss(apply_fn, pad_id=PAD), mesh, P('dp', 'sp'))
        assert abs(float(jax.jit(mean_of_means)(_lm_params(), toks, tgts))
                   - float(loss)) > 1e-3


# ---------------------------------------------------- tensor parallelism
def _jax_tp(name, inputs, tp):
    mesh = _mesh((tp,), ('tp',))
    if name == 'mlp':
        names = ['x', 'w_in', 'b_in', 'w_out', 'b_out']
        prefix = 'mlp/'

        def body(a):
            return tp_mlp(a['x'], a['w_in'], a['b_in'], a['w_out'],
                          a['b_out'], 'tp', activation=jnp.tanh)
    elif name.startswith('attn'):
        names, prefix = ['x', 'wqkv', 'wo', 'bo'], 'blk/'
        causal = name == 'attn1'

        def body(a):
            return tp_attention(a['x'], a['wqkv'], a['wo'], 'tp',
                                n_heads=TP_H, causal=causal, bo=a['bo'])
    else:
        names = ['x', 'ln1_scale', 'ln1_bias', 'wqkv', 'wo', 'bo',
                 'ln2_scale', 'ln2_bias', 'w_in', 'b_in', 'w_out', 'b_out']
        prefix = 'blk/'

        def body(a):
            return tp_transformer_block(
                a['x'], {k: v for k, v in a.items() if k != 'x'}, 'tp',
                n_heads=TP_H)
    args = {n: jnp.asarray(inputs[prefix + n]) for n in names}
    specs = {n: TP_SPECS[n] for n in names}

    def mapped(a):
        def f(a):
            out = body(a)
            return out, jnp.sum(out ** 2)
        return jax.shard_map(f, mesh=mesh, in_specs=(specs,),
                             out_specs=(P(), P()), check_vma=False)(a)

    out, _ = jax.jit(mapped)(args)
    grads = jax.jit(jax.grad(lambda a: mapped(a)[1]))(args)
    return np.asarray(out), {n: np.asarray(g) for n, g in grads.items()}


@pytest.mark.parametrize('tp', SIZES)
@pytest.mark.parametrize('name', ['mlp', 'attn0', 'attn1', 'block'])
def test_tensor_parallel_blocks_match_jax(ranks, inputs, name, tp):
    out, grads = _jax_tp(name, inputs, tp)
    key = 'tp/%s/%d/' % (name, tp)
    for row in range(WORLD // tp):
        rows = ranks[row * tp:(row + 1) * tp]
        for res in rows:
            np.testing.assert_allclose(res[key + 'out'], out, rtol=2e-4,
                                       atol=2e-4)
        for n, g in grads.items():
            if n in DIMS:            # sharded: the processes' blocks
                got = _gathered(rows, key + 'd' + n, tp, DIMS[n])
                np.testing.assert_allclose(got, g, rtol=1e-3, atol=1e-3,
                                           err_msg=n)
            else:                    # replicated: summed over the axis
                for res in rows:
                    np.testing.assert_allclose(res[key + 'd' + n], g,
                                               rtol=1e-3, atol=1e-3,
                                               err_msg=n)
