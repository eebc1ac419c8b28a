"""The port's seq2seq (``models.Seq2seq``, ``seq2seq_loss``,
``bucket_batches`` and the twin of ``examples/seq2seq/train_seq2seq.py``)
against the JAX package's.

From the same flax weights and a padded batch: the logits, the masked
loss and ``perp`` (f32 rtol 1e-5; bf16 5e-2) and every gradient (f32
rtol 1e-4 of each leaf's largest element; bf16 5e-2); the buckets are
bit-equal; the twin's ``--quick`` run in a world of one gives the JAX
twin's losses (its step on a one-device mesh, ``optax.adam(1e-3)``
under the multi-node wrapper, the same synthetic pairs and order), and
on 2 gloo ranks both ranks run the same steps to the same losses.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chainermn_tpu
from chainermn_tpu import training as jtraining
from chainermn_tpu.models import seq2seq as jseq2seq
from chainermn_tpu_torch import models
from chainermn_tpu_torch.examples.seq2seq import train_seq2seq

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
TOL = {'float32': (1e-5, 1e-4), 'bfloat16': (5e-2, 5e-2)}
KW = dict(n_layers=2, n_source_vocab=37, n_target_vocab=41, n_units=16)


def _jax_example():
    """``examples/seq2seq/train_seq2seq.py`` as a module (its helpers)."""
    path = REPO / 'examples' / 'seq2seq' / 'train_seq2seq.py'
    spec = importlib.util.spec_from_file_location('jax_train_seq2seq', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _batch():
    rng = np.random.RandomState(3)
    xs = rng.randint(4, 37, (3, 7)).astype(np.int32)
    yin = rng.randint(4, 41, (3, 6)).astype(np.int32)
    yout = rng.randint(4, 41, (3, 6)).astype(np.int32)
    xs[0, 5:] = 0              # pads the encoder runs over
    yin[1, 4:] = 0
    yout[1, 3:] = 0            # masked out of the loss
    return xs, yin, yout


def _tol(want, rtol):
    return dict(rtol=rtol, atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_logits_loss_and_gradients_match_jax(dtype):
    fwd_tol, grad_tol = TOL[dtype]
    xs, yin, yout = _batch()
    jmodel = jseq2seq.Seq2seq(dtype=getattr(jnp, dtype), **KW)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), xs, yin))
    loss_fn = jseq2seq.seq2seq_loss(
        lambda p, a, b: jmodel.apply({'params': p}, a, b))
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params['params'], xs, yin, yout)
    jlogits = np.asarray(jax.jit(jmodel.apply)(params, xs, yin))

    model = models.Seq2seq(dtype=getattr(torch, dtype), device='cpu', **KW)
    models.load_flax_variables(model, params)
    t = [torch.from_numpy(a) for a in (xs, yin, yout)]
    logits = model(t[0], t[1])
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.detach().numpy(), jlogits,
                               **_tol(jlogits, fwd_tol))
    loss, aux = models.seq2seq_loss(model)(*t)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=fwd_tol)
    np.testing.assert_allclose(aux['perp'].item(), float(jaux['perp']),
                               rtol=fwd_tol)
    loss.backward()
    grads = models.param_tree(model)
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jgrads)):
        keys = [p.key for p in path]
        node = grads
        for k in keys[:-1]:
            node = node[k]
        if keys[-1] in node:
            g = node[keys[-1]].grad.numpy()
        else:       # a Dense kernel: the transposed weight
            g = node['weight'].grad.numpy().T
        want = np.asarray(leaf)
        np.testing.assert_allclose(g, want, **_tol(want, grad_tol),
                                   err_msg='/'.join(keys))
        n += 1
    assert n == len(list(model.parameters()))


def test_flax_round_trip_and_layout():
    xs, yin, _ = _batch()
    jmodel = jseq2seq.Seq2seq(**KW)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(1), xs, yin))
    model = models.Seq2seq(device='cpu', **KW)
    models.load_flax_variables(model, params)
    back = dict(jax.tree_util.tree_leaves_with_path(
        models.to_flax_variables(model)['params']))
    want = dict(jax.tree_util.tree_leaves_with_path(params['params']))
    assert set(back) == set(want)
    for path, leaf in want.items():
        np.testing.assert_array_equal(back[path], np.asarray(leaf))
    # the gates: input kernels without bias, recurrent ones with bias
    cell = model.encoder_0.cell
    assert getattr(cell, 'if').bias is None and cell.hf.bias is not None


def test_bucket_batches_are_bit_equal():
    jex = _jax_example()
    pairs = jex.synthetic_pairs(300, 512, np.random.RandomState(42))
    mine = train_seq2seq.synthetic_pairs(300, 512,
                                         np.random.RandomState(42))
    for (a, b), (c, d) in zip(pairs, mine):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    for widths in ((8, 16, 32), (8, 16, 32, 64)):
        want = jseq2seq.bucket_batches(pairs, bucket_widths=widths)
        got = models.bucket_batches(mine, bucket_widths=widths)
        assert sorted(got) == sorted(want)
        for w in want:
            for a, b in zip(got[w], want[w]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


UNIT = 32


def _jax_twin_losses(params):
    """The JAX twin's ``--quick`` loop on a one-device mesh."""
    jex = _jax_example()
    comm = chainermn_tpu.create_communicator(
        'xla', mesh_shape=(1, 1), devices=jax.devices()[:1])
    pairs = jex.synthetic_pairs(512, 512, np.random.RandomState(42))
    buckets = jseq2seq.bucket_batches(pairs, bucket_widths=(8, 16, 32))
    model = jseq2seq.Seq2seq(n_layers=2, n_source_vocab=512,
                             n_target_vocab=512, n_units=UNIT)
    optimizer = chainermn_tpu.create_multi_node_optimizer(
        optax.adam(1e-3), comm)
    loss_fn = jseq2seq.seq2seq_loss(
        lambda p, a, b: model.apply({'params': p}, a, b))
    updater = jtraining.StandardUpdater(iter([]), optimizer, loss_fn,
                                        params, comm, has_aux=True)
    perm_rng = np.random.RandomState(0)
    losses = []
    for _, (xs, yin, yout) in sorted(buckets.items()):
        order = perm_rng.permutation(len(xs))
        for i in range(0, len(order) - 64 + 1, 64):
            sel = order[i:i + 64]
            arrays = comm.shard_batch((xs[sel], yin[sel], yout[sel]))
            losses.append(float(updater.update_core(arrays)['loss']))
    return losses


def test_twin_quick_run_gives_the_jax_twins_losses():
    xs0 = np.zeros((2, 8), np.int32)
    jmodel = jseq2seq.Seq2seq(n_layers=2, n_source_vocab=512,
                              n_target_vocab=512, n_units=UNIT)
    params = jax.device_get(jmodel.init(jax.random.PRNGKey(0), xs0, xs0))
    want = _jax_twin_losses(params['params'])
    run = train_seq2seq.main(['--cpu', '--quick', '--unit', str(UNIT)],
                             variables=params)
    try:
        assert len(run.losses) == len(want) >= 5
        # bf16 compute in both (the JAX twin's default)
        np.testing.assert_allclose(run.losses, want, rtol=5e-3)
        assert all(t > 0 for t in run.tokens)
        assert run.losses[-1] < run.losses[0]
    finally:
        run.comm.close()


_RANK_SCRIPT = r'''
import json
import sys
import torch
import torch.distributed as dist
from chainermn_tpu_torch.examples.seq2seq import train_seq2seq

torch.set_num_threads(1)
store, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
dist.init_process_group('gloo', store=dist.FileStore(store, 2), rank=rank,
                        world_size=2)
run = train_seq2seq.main(['--cpu', '--quick', '--unit', '16'])
with open(out, 'w') as f:
    json.dump({'losses': run.losses, 'tokens': run.tokens}, f)
dist.destroy_process_group()
'''


def test_twin_on_two_gloo_ranks(tmp_path):
    """Each rank buckets every pair and takes its half of each global
    batch: both run the same steps and report the same mean loss."""
    import json
    import os
    import subprocess
    import sys
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _RANK_SCRIPT, str(tmp_path / 'store'),
         str(r), str(tmp_path / ('r%d.json' % r))], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            assert p.returncode == 0, out.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    res = [json.loads((tmp_path / ('r%d.json' % r)).read_text())
           for r in range(2)]
    assert len(res[0]['losses']) >= 5
    assert res[0] == res[1]
    assert all(np.isfinite(v) for v in res[0]['losses'])
