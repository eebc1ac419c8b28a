"""The LM's dropout (flax ``nn.Dropout`` after each block's attention
projection and MLP) against the JAX package: eval mode equals JAX's
``train=False`` at 1e-5; train mode keeps ``1 - rate`` and scales by
``1 / (1 - rate)``; the masks are drawn from the updater's generator,
reproducible per (seed, iteration, rank), also across a resume."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import models as jmodels
from chainermn_tpu_torch import models, serializers, training

torch.set_num_threads(2)

CFG = dict(vocab_size=48, d_model=32, n_heads=4, n_layers=2, d_ff=64,
           max_len=64)
RATE = 0.25


@functools.lru_cache(maxsize=None)
def _params():
    jm = jmodels.TransformerLM(dtype=jnp.float32, dropout=RATE, **CFG)
    return jax.device_get(jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))['params'])


def _model(rate=RATE):
    tm = models.TransformerLM(dtype=torch.float32, device='cpu',
                              dropout=rate, **CFG)
    models.load_flax_variables(tm, {'params': _params()})
    return tm


def _tokens(seed=1, shape=(2, 16)):
    return np.random.RandomState(seed).randint(
        0, CFG['vocab_size'], size=shape).astype(np.int32)


def test_eval_mode_equals_jax_train_false():
    jm = jmodels.TransformerLM(dtype=jnp.float32, dropout=RATE, **CFG)
    toks = _tokens()
    want = np.asarray(jm.apply({'params': _params()}, jnp.asarray(toks),
                               train=False))
    tm = _model().eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(toks)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    tm.train()
    with torch.no_grad():
        dropped = tm(torch.from_numpy(toks)).numpy()
    assert not np.allclose(dropped, want, rtol=1e-3, atol=1e-3)


def test_train_mode_keep_rate_and_scale():
    """Every block drops its projection's and its MLP's output: two
    draws a block, each keeping ~``1 - rate`` scaled by ``1 / (1 -
    rate)``."""
    tm = _model()
    tm.train()
    seen = []

    def hook(module, args, out):
        seen.append((args[0].detach(), out.detach()))

    for i in range(CFG['n_layers']):
        getattr(tm, 'block_%d' % i).drop.register_forward_hook(hook)
    gen = torch.Generator().manual_seed(3)
    models.set_dropout_generator(tm, gen)
    with torch.no_grad():
        tm(torch.from_numpy(_tokens(shape=(16, 64))))
    assert len(seen) == 2 * CFG['n_layers']
    for x, y in seen:
        kept = y != 0
        assert abs(float(kept.float().mean()) - (1 - RATE)) < 0.01
        np.testing.assert_allclose(y[kept].numpy(),
                                   (x[kept] / (1 - RATE)).numpy(),
                                   rtol=1e-6)
    seen.clear()
    tm.eval()
    with torch.no_grad():
        tm(torch.from_numpy(_tokens(shape=(16, 64))))
    # in eval mode each drop hands its input through unchanged
    assert len(seen) == 2 * CFG['n_layers']
    assert all(torch.equal(x, y) for x, y in seen)


def test_pipeline_parts_refuses_dropout_as_jax():
    with pytest.raises(ValueError, match='without dropout'):
        models.pipeline_parts(_model(), n_stages=1)


class _Comm:
    size = 1

    def __init__(self, rank):
        self.rank = rank

    def allreduce(self, x, op='mean'):
        return x


def _run(rank=0, seed=0, steps=3, resume_from=None, save_at=None,
         tmp=None):
    """``steps`` updates of the LM through ``StandardUpdater``; returns
    the first block's attention-output masks of each update, the
    parameters after them and the snapshot's path.  ``save_at``: write
    a snapshot after that many updates; ``resume_from``: start from such
    a snapshot."""
    tm = _model()
    masks = []
    tm.block_0.drop.register_forward_hook(
        lambda m, a, out: masks.append(out.detach() != 0))
    opt = torch.optim.SGD(tm.parameters(), lr=0.05, momentum=0.9)
    up = training.StandardUpdater(iter([]), opt, models.lm_loss(tm), tm,
                                  _Comm(rank), rng=seed)
    assert tm.block_0.drop.generator is up.dropout_generator
    if resume_from is not None:
        serializers.resume_updater(resume_from, up)
    toks = torch.from_numpy(_tokens(seed=7, shape=(2, 16)))
    tgts = torch.roll(toks, -1, 1)
    path = None
    for _ in range(steps):
        up.update_core((toks, tgts))
        if save_at is not None and up.iteration == save_at:
            path = serializers.save_npz(str(tmp / 'snap'),
                                        serializers.updater_state(up))
    # two draws a forward (projection, MLP): keep the projection's
    params = [p.detach().clone() for p in tm.parameters()]
    return masks[::2], params, path


def test_masks_reproducible_per_rank_and_iteration_and_resume(tmp_path):
    a, pa, snap = _run(save_at=2, tmp=tmp_path)
    b, pb, _ = _run()
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert all(torch.equal(x, y) for x, y in zip(pa, pb))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a[0], _run(rank=1, steps=1)[0][0])
    assert not torch.equal(a[0], _run(seed=1, steps=1)[0][0])
    # resumed after two updates: the third update draws the third masks
    # and lands on the uninterrupted run's parameters
    c, pc, _ = _run(steps=1, resume_from=snap)
    assert torch.equal(c[0], a[2])
    assert all(torch.equal(x, y) for x, y in zip(pc, pa))
