"""The port's ``TransformerLM`` on its parallel axes against the JAX
package, from the same flax weights and batches.

One spawn of two gloo processes runs:

- tp = 2: ``TransformerLM(tp_axis='model')`` against the JAX tp model
  under ``shard_map`` and its ``tp_oracle`` -- the logits, ``lm_loss``,
  ``lm_loss_sum`` with uneven padding, every gradient gathered, and one
  AdamW step (``torch.optim.AdamW`` against ``optax.adamw``); rtol 1e-5
  (atol 1e-6) in f32, 5e-2 in bf16;
- sp = 2 in bf16, both schemes, against JAX's ``mapped_global_loss`` at
  5e-2 (the f32 cases at 2 and 4 processes are
  ``test_torch_parallel.py``'s);
- the round trip of a full flax tree through ``shard_variables`` /
  ``gather_variables``, bit for bit, and the model's own shard of it;
- the ``train_lm`` twin's first losses (``--quick`` widths, ``--mesh
  1x2``, both schemes, f32) against the JAX example's loop run here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from chainermn_tpu import models as jmodels
from chainermn_tpu.parallel import mapped_global_loss
from torch_spawn import flat_tree, save_tree, spawn

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
B, T, PAD, LR = 2, 16, 0, 1e-3
TWIN = dict(vocab=512, d_model=256, n_heads=8, n_layers=2, seq_len=256,
            batchsize=4, lr=3e-4, steps=3)

_BODY = r'''
from chainermn_tpu_torch import models
from chainermn_tpu_torch.examples.lm import train_lm
from chainermn_tpu_torch.parallel import (
    MeshPlan, ProcessMesh, mapped_global_loss, sum_grads)

params = load_tree(argv[0], 'params/')
twin_params = load_tree(argv[0], 'twin/')
with np.load(argv[0]) as f:
    toks, tgts = torch.from_numpy(f['tokens']), torch.from_numpy(f['targets'])
cfg = eval(argv[1])
plan = MeshPlan.create(tp=2, device='cpu')
for dt in ('float32', 'bfloat16'):
    with plan.bind():
        model = models.TransformerLM(dtype=getattr(torch, dt), device='cpu',
                                     tp_axis='model', **cfg)
        models.load_flax_variables(model, {'params': params})
        logits = model(toks)
        (s, c), _ = models.lm_loss_sum(model, pad_id=0)(toks, tgts)
        loss, _ = models.lm_loss(model)(toks, tgts)
        loss.backward()
    res[dt + '/logits'] = logits.detach().float().numpy()
    res[dt + '/loss'] = loss.detach().numpy()
    res[dt + '/sum'] = np.array([float(s), float(c)])
    grads = {n: p.grad for n, p in model.named_parameters()}
    tree = {}
    for n, g in grads.items():
        node = tree
        for part in n.split('.')[:-1]:
            node = node.setdefault(part, {})
        node[n.split('.')[-1]] = g.numpy()
    for k, v in flat_tree(models.gather_variables(
            tree, model.param_specs, plan.mesh)).items():
        res[dt + '/grad/' + k] = v
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3, weight_decay=0.01)
    opt.step()
    full = models.gather_variables(models.to_flax_variables(model)['params'],
                                   model.param_specs, plan.mesh)
    for k, v in flat_tree(full).items():
        res[dt + '/step/' + k] = v.copy()
    if dt == 'float32':
        # the round trip of the full tree, and the model's own shard
        mine = models.shard_variables(params, model.param_specs, plan.mesh)
        back = models.gather_variables(mine, model.param_specs, plan.mesh)
        for k, v in flat_tree(back).items():
            res['roundtrip/' + k] = v
        own = model.shard_flax_variables({'params': params})['params']
        res['own_shard_equal'] = np.array(all(
            np.array_equal(a, b) for a, b in zip(
                flat_tree(own).values(), flat_tree(mine).values())))
        res['shard_shapes'] = np.array(
            [v.shape[0] for v in flat_tree(mine).values()] )

mesh = ProcessMesh((1, 2), ('dp', 'sp'))
for scheme in ('ring', 'ulysses'):
    model = models.TransformerLM(dtype=torch.bfloat16, device='cpu',
                                 sequence_axis='sp', sp_scheme=scheme, **cfg)
    models.load_flax_variables(model, {'params': params})
    mapped = mapped_global_loss(models.lm_loss(model), mesh, ('dp', 'sp'))
    loss = mapped(toks, tgts)
    loss.backward()
    sum_grads(list(model.parameters()), mesh)
    res['sp_bf16/%s/loss' % scheme] = loss.detach().float().numpy()
    for n, p in model.named_parameters():
        res['sp_bf16/%s/grad/%s' % (scheme, n.replace('.', '/'))] = \
            p.grad.float().numpy()
    twin = eval(argv[2])
    out = train_lm.main(
        ['--cpu', '--quick', '--mesh', '1x2', '--sp-scheme', scheme,
         '--dtype', 'float32', '--steps', str(twin['steps'])],
        params=twin_params)
    res['twin/%s' % scheme] = np.array(out['losses'])
'''


def _batch():
    rng = np.random.RandomState(9)
    toks = rng.randint(1, CFG['vocab_size'], (B, T)).astype(np.int32)
    tgts = rng.randint(1, CFG['vocab_size'], (B, T)).astype(np.int32)
    tgts[0, 5:] = PAD
    tgts[1, 14:] = PAD
    return toks, tgts


@functools.lru_cache(maxsize=None)
def _params():
    jm = jmodels.TransformerLM(dtype=jnp.float32, **CFG)
    return jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])


@functools.lru_cache(maxsize=None)
def _twin_params():
    t = TWIN
    jm = jmodels.TransformerLM(
        vocab_size=t['vocab'], d_model=t['d_model'], n_heads=t['n_heads'],
        n_layers=t['n_layers'], d_ff=4 * t['d_model'],
        max_len=max(t['seq_len'], 1024))
    x0 = jnp.zeros((1, min(t['seq_len'], 64)), jnp.int32)
    return jax.device_get(jm.init(jax.random.PRNGKey(0), x0)['params'])


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('lm_parallel')
    toks, tgts = _batch()
    flat = flat_tree({'twin': _twin_params()})
    save_tree(tmp / 'in.npz', {'params': _params()}, tokens=toks,
              targets=tgts, **flat)
    return spawn(tmp, _BODY, 2, [tmp / 'in.npz', repr(CFG), repr(TWIN)],
                 deadline=400)


def _mesh(shape, names):
    n = int(np.prod(shape))
    return Mesh(np.asarray(jax.devices()[:n]).reshape(shape), names)


TOL = {'float32': dict(rtol=1e-5, atol=1e-6),
       'bfloat16': dict(rtol=5e-2, atol=5e-2)}
JDT = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}


def _jax_tp(dtype):
    """The JAX tp model under shard_map on 2 host devices: logits,
    loss, and the gradients taken inside (the updaters' mode)."""
    params = _params()
    toks, tgts = (jnp.asarray(a) for a in _batch())
    model = jmodels.TransformerLM(dtype=JDT[dtype], tp_axis='model', **CFG)
    specs = jmodels.tp_param_specs(params, 'model')
    mesh = _mesh((1, 2), ('data', 'model'))
    loss_fn = jmodels.lm_loss(lambda p, t: model.apply({'params': p}, t))

    def f(p, t, y):
        logits = model.apply({'params': p}, t)
        (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(p, t, y)
        return logits, loss, g
    logits, loss, grads = jax.jit(jax.shard_map(
        f, mesh=mesh, in_specs=(specs, P(), P()),
        out_specs=(P(), P(), specs), check_vma=False))(params, toks, tgts)
    return np.asarray(logits), float(loss), flat_tree(jax.device_get(grads))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_tp_model_matches_the_jax_tp_model_and_its_oracle(ranks, dtype):
    logits, loss, grads = _jax_tp(dtype)
    params = _params()
    oracle = jmodels.tp_oracle(jmodels.TransformerLM(
        dtype=JDT[dtype], tp_axis='model', **CFG))
    toks, tgts = (jnp.asarray(a) for a in _batch())
    apply_fn = lambda p, t: oracle.apply({'params': p}, t)  # noqa: E731
    (oloss, _), ograds = jax.value_and_grad(
        jmodels.lm_loss(apply_fn), has_aux=True)(params, toks, tgts)
    (osum, ocount), _ = jmodels.lm_loss_sum(apply_fn, pad_id=PAD)(
        params, toks, tgts)
    ograds = flat_tree(jax.device_get(ograds))
    tol = TOL[dtype]
    for res in ranks:
        np.testing.assert_allclose(res[dtype + '/logits'],
                                   np.asarray(logits, np.float32), **tol)
        np.testing.assert_allclose(res[dtype + '/loss'], loss, **tol)
        np.testing.assert_allclose(res[dtype + '/loss'], float(oloss), **tol)
        np.testing.assert_allclose(res[dtype + '/sum'],
                                   [float(osum), float(ocount)], **tol)
        got = {k[len(dtype + '/grad/'):]: v for k, v in res.items()
               if k.startswith(dtype + '/grad/')}
        assert sorted(got) == sorted(grads) == sorted(ograds)
        for name in grads:
            # a leaf against its largest entry (the key bias cancels)
            scale = max(np.abs(ograds[name]).max(), 1e-6)
            for want in (grads[name], ograds[name]):
                np.testing.assert_allclose(
                    got[name] / scale, np.asarray(want, np.float32) / scale,
                    rtol=tol['rtol'], atol=max(tol['atol'], 1e-4)
                    if dtype == 'float32' else tol['atol'], err_msg=name)
    # one AdamW step against optax.adamw on the oracle's gradients
    if dtype == 'float32':
        tx = optax.adamw(LR, weight_decay=0.01)
        upd, _ = tx.update(jax.tree_util.tree_map(jnp.asarray, flat_tree(
            jax.device_get(jax.grad(lambda p: jmodels.lm_loss(apply_fn)(
                p, toks, tgts)[0])(params)))), tx.init(flat_tree(params)),
            flat_tree(params))
        new = optax.apply_updates(flat_tree(params), upd)
        for res in ranks:
            for name, want in new.items():
                if name.endswith('qkv/bias'):
                    continue   # its key slice's gradient is rounding noise
                np.testing.assert_allclose(res['float32/step/' + name],
                                           np.asarray(want), rtol=1e-5,
                                           atol=1e-6, err_msg=name)


def test_shard_and_gather_round_trip_bit_for_bit(ranks):
    want = flat_tree(_params())
    for res in ranks:
        got = {k[len('roundtrip/'):]: v for k, v in res.items()
               if k.startswith('roundtrip/')}
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name])
        assert bool(res['own_shard_equal'])
    # the embedding rows and the head's rows are halved
    assert CFG['vocab_size'] // 2 in ranks[0]['shard_shapes']


@pytest.mark.parametrize('scheme', ['ring', 'ulysses'])
def test_sequence_parallel_bf16_matches_jax(ranks, scheme):
    jm = jmodels.TransformerLM(dtype=jnp.bfloat16, sequence_axis='sp',
                               sp_scheme=scheme, **CFG)
    mapped = mapped_global_loss(
        jmodels.lm_loss(lambda p, t: jm.apply({'params': p}, t)),
        _mesh((1, 2), ('dp', 'sp')), P('dp', 'sp'))
    toks, tgts = (jnp.asarray(a) for a in _batch())
    loss, grads = jax.jit(jax.value_and_grad(mapped))(_params(), toks, tgts)
    grads = flat_tree(jax.device_get(grads))
    key = 'sp_bf16/%s/' % scheme
    for res in ranks:
        np.testing.assert_allclose(res[key + 'loss'], float(loss), rtol=5e-2)
        for name, want in grads.items():
            scale = max(np.abs(want).max(), 1e-6)
            np.testing.assert_allclose(
                res[key + 'grad/' + name] / scale,
                np.asarray(want, np.float32) / scale, rtol=5e-2, atol=5e-2,
                err_msg=name)


def _jax_twin_losses(scheme):
    """The JAX example's loop (``examples/lm/train_lm.py``) at --quick
    widths, --mesh 1x2, in f32, for the first steps."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        'jax_train_lm', Path(__file__).resolve().parent.parent
        / 'examples' / 'lm' / 'train_lm.py')
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    t = TWIN
    model = jmodels.TransformerLM(
        vocab_size=t['vocab'], d_model=t['d_model'], n_heads=t['n_heads'],
        n_layers=t['n_layers'], d_ff=4 * t['d_model'],
        max_len=max(t['seq_len'], 1024), sequence_axis='sp',
        sp_scheme=scheme, dtype=jnp.float32)
    rng = np.random.RandomState(0)
    corpus = example.synthetic_tokens(
        t['batchsize'] * (t['seq_len'] + 1) * 8, t['vocab'], rng)
    mesh = _mesh((1, 2), ('dp', 'sp'))
    loss_fn = jmodels.lm_loss(lambda p, x: model.apply({'params': p}, x))
    mapped = mapped_global_loss(loss_fn, mesh, P('dp', 'sp'))
    opt = optax.adamw(t['lr'], weight_decay=0.01)
    params = _twin_params()
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, grads = jax.value_and_grad(mapped)(params, x, y)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for s in range(t['steps']):
        n = t['batchsize'] * t['seq_len']
        i = (s * n) % (len(corpus) - t['batchsize'] * (t['seq_len'] + 1))
        w = corpus[i:i + t['batchsize'] * (t['seq_len'] + 1)].reshape(
            t['batchsize'], t['seq_len'] + 1)
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(w[:, :-1]),
                                       jnp.asarray(w[:, 1:]))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize('scheme', ['ring', 'ulysses'])
def test_train_lm_twin_first_losses_match_the_jax_example(ranks, scheme):
    want = _jax_twin_losses(scheme)
    for res in ranks:
        np.testing.assert_allclose(res['twin/%s' % scheme], want,
                                   rtol=1e-5)
    assert want[-1] < want[0]
