"""The port's BN backward, split at its per-channel sums
(``_bwd_sums_ref`` + ``_bwd_apply_ref``, the plain versions of the
``bn_backward`` kernel), against ``jax.vjp`` of the JAX package's
``ops.batch_norm_act`` in its ``fallback`` (jnp) and ``interpret``
(Pallas kernels in the interpreter) modes; the op's backward with
unmaterialized zero cotangents against the transcription it replaced;
and the launch plan of the column-sum kernels (``bn_stats`` and
``bn_backward``), which must cover every row and channel exactly once.

Tolerances are ``tests/test_torch_batch_norm_act.py``'s ``GRAD_TOL``:
f32 1e-4 (the sums run in another order), bf16 5e-2 (one bf16 rounding
of dx or of the forward's output may land on either side), f16 1e-2 (the
same for f16's rounding).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu import ops as jops
from chainermn_tpu.ops import _common as jcommon
from chainermn_tpu_torch import ops

torch.set_num_threads(2)

# the module (ops.batch_norm_act is the function of the same name)
bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')

GRAD_TOL = {'float32': dict(rtol=1e-4, atol=1e-4),
            'bfloat16': dict(rtol=5e-2, atol=5e-2),
            'float16': dict(rtol=1e-2, atol=1e-2)}
TDTYPE = {'float32': torch.float32, 'bfloat16': torch.bfloat16,
          'float16': torch.float16}


@pytest.fixture(params=['fallback', 'interpret'])
def mode(request, monkeypatch):
    if request.param == 'interpret':
        monkeypatch.setenv('CHAINERMN_TPU_PALLAS_INTERPRET', '1')
    else:
        monkeypatch.delenv('CHAINERMN_TPU_PALLAS_INTERPRET', raising=False)
    assert jcommon.pallas_mode() == request.param
    return request.param


def _rounded(a, dtype):
    """numpy f32 values exactly representable in ``dtype``."""
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


def _inputs(shape, dtype, seed, residual):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = _rounded(rng.randn(*shape).astype(np.float32) * 2.0 + 0.5, dtype)
    res = (_rounded(rng.randn(*shape).astype(np.float32), dtype)
           if residual else None)
    scale = (rng.randn(c) * 0.5 + 1.0).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    g = _rounded(rng.randn(*shape).astype(np.float32), dtype)
    g_mean = rng.randn(c).astype(np.float32)
    g_var = rng.randn(c).astype(np.float32)
    return x, res, scale, bias, g, g_mean, g_var


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _plain_backward(x, res, scale, bias, g, g_mean, g_var, tdt, relu):
    """The port's forward and backward through the plain versions,
    step by step; returns ``(dx, dscale, dbias, dres)``."""
    c = x.shape[-1]
    x2d = torch.tensor(x, dtype=tdt).view(-1, c)
    r2d = (None if res is None
           else torch.tensor(res, dtype=tdt).view(-1, c))
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    mean, _, rstd = bn._batch_stats(x2d, 1e-5)
    out2d = bn._apply_ref(x2d, mean, rstd, s, b, r2d, relu)
    g2d = torch.tensor(g, dtype=tdt).view(-1, c)
    gm = None if g_mean is None else torch.from_numpy(g_mean)
    gv = None if g_var is None else torch.from_numpy(g_var)
    dbeta, dgamma = bn._bwd_sums_ref(x2d, g2d, out2d, mean, rstd, relu)
    dx, dres = bn._bwd_apply_ref(x2d, g2d, out2d, mean, rstd, s, dbeta,
                                 dgamma, gm, gv, relu, res is not None)
    assert dx.dtype == tdt and (dres is None) == (res is None)
    return (dx.view(x.shape), dgamma, dbeta,
            None if dres is None else dres.view(x.shape))


def _jax_vjp(x, res, scale, bias, g, g_mean, g_var, dtype, relu):
    jdt = jnp.dtype(dtype)
    args = (jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias),
            None if res is None else jnp.asarray(res, jdt))

    def fwd(x, scale, bias, res):
        return jops.batch_norm_act(x, scale, bias, residual=res, relu=relu)

    (out, mean, var), vjp = jax.vjp(fwd, *args)
    zeros = jnp.zeros_like(mean)
    cts = (jnp.asarray(g, out.dtype),
           zeros if g_mean is None else jnp.asarray(g_mean),
           zeros if g_var is None else jnp.asarray(g_var))
    return vjp(cts)


CASES = [((4, 6, 6, 16), 0), ((3, 10, 10, 8), 1)]   # 144 rows; 300 rows


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('relu', [True, False])
@pytest.mark.parametrize('stats_cts', [False, True])
@pytest.mark.parametrize('shape,seed', CASES)
def test_plain_backward_matches_jax_vjp(mode, dtype, residual, relu,
                                        stats_cts, shape, seed):
    x, res, scale, bias, g, g_mean, g_var = _inputs(shape, dtype, seed,
                                                    residual)
    if not stats_cts:
        g_mean = g_var = None
    want = _jax_vjp(x, res, scale, bias, g, g_mean, g_var, dtype, relu)
    got = _plain_backward(x, res, scale, bias, g, g_mean, g_var,
                          TDTYPE[dtype], relu)
    for name, a, b in zip(('dx', 'dscale', 'dbias', 'dres'), got, want):
        if b is None:
            assert a is None and name == 'dres'
            continue
        np.testing.assert_allclose(a.float().numpy(), _f32(b),
                                   err_msg=name, **GRAD_TOL[dtype])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16', 'float16'])
@pytest.mark.parametrize('only', ['g_mean', 'g_var'])
def test_op_backward_with_one_stats_cotangent_matches_jax(mode, dtype,
                                                          only):
    # autograd passes the op's backward the cotangent of the one
    # statistics output that reaches the loss, and None for the other
    shape = (2, 5, 5, 8)
    x, res, scale, bias, g, g_mean, g_var = _inputs(shape, dtype, 2, True)
    cts = dict(g_mean=g_mean, g_var=g_var)
    cts['g_var' if only == 'g_mean' else 'g_mean'] = None
    want = _jax_vjp(x, res, scale, bias, g, cts['g_mean'], cts['g_var'],
                    dtype, True)
    tdt = TDTYPE[dtype]
    tx = torch.tensor(x, dtype=tdt, requires_grad=True)
    tr = torch.tensor(res, dtype=tdt, requires_grad=True)
    ts = torch.tensor(scale, requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    out, mean, var = ops.batch_norm_act(tx, ts, tb, residual=tr)
    stat, ct = (mean, g_mean) if only == 'g_mean' else (var, g_var)
    torch.autograd.backward([out, stat], [torch.tensor(g, dtype=tdt),
                                          torch.from_numpy(ct)])
    for name, a, b in zip(('dx', 'dscale', 'dbias', 'dres'),
                          (tx.grad, ts.grad, tb.grad, tr.grad), want):
        np.testing.assert_allclose(a.float().numpy(), _f32(b),
                                   err_msg=name, **GRAD_TOL[dtype])


def _transcription_backward(x, scale, mean, rstd, out, g, g_mean, g_var,
                            relu, has_residual):
    """The op's backward as it was before the kernel: the JAX package's
    ``_bn_act_bwd`` in PyTorch ops, with the zero cotangents of the
    statistics outputs materialized by autograd."""
    shape = x.shape
    c = shape[-1]
    xf = bn._wide(x.reshape(-1, c))
    gf = bn._wide(g.reshape(-1, c))
    m = xf.shape[0]
    xhat = (xf - mean) * rstd
    gm = gf * (out.reshape(-1, c) > 0) if relu else gf
    scale_f = bn._wide(scale)
    dbeta = gm.sum(0)
    dgamma = (gm * xhat).sum(0)
    dx = (scale_f * rstd) * (gm - dbeta / m - xhat * (dgamma / m))
    gmf, gvf = bn._wide(g_mean), bn._wide(g_var)
    dx = dx + (gmf + 2.0 * (xf - mean) * gvf) / m
    dres = gm.to(x.dtype).reshape(shape) if has_residual else None
    return (dx.to(x.dtype).reshape(shape), dgamma.to(scale.dtype),
            dbeta.to(scale.dtype), dres)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize('residual', [False, True])
@pytest.mark.parametrize('relu', [True, False])
def test_op_backward_equals_the_transcription_it_replaced(
        monkeypatch, dtype, residual, relu):
    x, res, scale, bias, g, _, _ = _inputs((3, 7, 7, 24), 'float32', 3,
                                           residual)
    tx = torch.tensor(x, dtype=dtype, requires_grad=True)
    tr = (torch.tensor(res, dtype=dtype, requires_grad=True) if residual
          else None)
    ts = torch.tensor(scale, requires_grad=True)
    tb = torch.tensor(bias, requires_grad=True)
    seen = []
    plain = bn._bwd_apply_ref

    def spy(*args):
        seen.append(args[8:10])      # the statistics outputs' cotangents
        return plain(*args)

    monkeypatch.setattr(bn, '_bwd_apply_ref', spy)
    out, mean, var = ops.batch_norm_act(tx, ts, tb, residual=tr, relu=relu)
    tg = torch.tensor(g, dtype=dtype)
    out.backward(tg)
    # set_materialize_grads(False): the unused outputs' zero cotangents
    # arrive as None and cost nothing
    assert seen == [(None, None)]
    c = x.shape[-1]
    _, _, rstd = bn._batch_stats(tx.detach().view(-1, c), 1e-5)
    want = _transcription_backward(
        tx.detach(), ts.detach(), mean.detach(), rstd, out.detach(), tg,
        torch.zeros(c), torch.zeros(c), relu, residual)
    got = (tx.grad, ts.grad, tb.grad, None if tr is None else tr.grad)
    for name, a, b in zip(('dx', 'dscale', 'dbias', 'dres'), got, want):
        if b is None:
            assert a is None
            continue
        # the same values (adding the zero terms can only turn -0 to +0)
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _covered(plan, unroll):
    """Simulate the kernels' loops: how often each row and each channel
    is read, and how often each channel's sums are finished."""
    rows = np.zeros(plan.m, np.int64)
    for chunk in range(plan.n_chunks):
        r0 = chunk * plan.rows
        r1 = min(r0 + plan.rows, plan.m)
        for ty in range(plan.lanes):
            starts = np.arange(r0 + ty, r1, plan.lanes * unroll)
            rr = (starts[:, None]
                  + plan.lanes * np.arange(unroll)[None, :]).ravel()
            np.add.at(rows, rr[rr < r1], 1)
    chans = np.zeros(plan.c, np.int64)
    finished = np.zeros(plan.c, np.int64)
    tc = plan.tcv * plan.vec
    fl = plan.tcv * plan.lanes // tc
    for tile in range(plan.n_ctiles):
        for tx in range(plan.tcv):
            ch0 = (tile * plan.tcv + tx) * plan.vec
            if ch0 < plan.c:
                chans[ch0:ch0 + plan.vec] += 1
        for fch in range(tc):
            ch = tile * tc + fch
            if ch < plan.c:
                finished[ch] += 1
    # each lane of the finish walks the chunks k = lane, lane + fl, ...
    walked = np.zeros(plan.n_chunks, np.int64)
    for lane in range(fl):
        walked[lane::fl] += 1
    return rows, chans, finished, walked


@pytest.mark.parametrize('c', [3, 32, 96, 256, 352])
@pytest.mark.parametrize('m', [1, 7, 300, 3139, 20011])
@pytest.mark.parametrize('itemsize', [2, 4])
def test_plan_covers_every_row_and_channel_once(c, m, itemsize):
    for aligned in (True, False):
        for sms in (132, 3):
            plan = bn._plan(m, c, itemsize, aligned, sms)
            full = 16 // itemsize
            assert plan.vec == (full if aligned and c % full == 0 else 1)
            # the kernel's limits (plan_ok in the .cu source)
            assert 0 < plan.tcv <= bn._MAX_TILE_VEC
            assert plan.tcv * plan.lanes <= bn._THREADS
            assert plan.lanes >= plan.vec and plan.n_chunks < 65536
            assert (plan.n_ctiles - 1) * plan.tcv * plan.vec < c \
                <= plan.n_ctiles * plan.tcv * plan.vec
            assert (plan.n_chunks - 1) * plan.rows < m \
                <= plan.n_chunks * plan.rows
            # at most about _BLOCKS_PER_SM blocks per SM, and every chunk
            # but the only one reads at least _MIN_CHUNK_BYTES of its tile
            blocks = plan.n_ctiles * plan.n_chunks
            assert plan.n_chunks == 1 or blocks <= (
                bn._BLOCKS_PER_SM * sms + plan.n_ctiles)
            row_bytes = plan.tcv * plan.vec * itemsize
            assert plan.n_chunks == 1 or (
                plan.rows * row_bytes >= bn._MIN_CHUNK_BYTES)
            for unroll in (4, 2):   # the stats and the backward's sums
                rows, chans, finished, walked = _covered(plan, unroll)
                assert (rows == 1).all() and (chans == 1).all()
                assert (finished == 1).all() and (walked == 1).all()


def test_plan_reads_16_bytes_a_thread_at_the_main_paths_widths():
    # GoogLeNet-BN's narrowest interlude: four threads a row, a warp
    # reads 8 rows at once
    plan = bn._plan(50176, 32, 2, True, 132)
    assert (plan.vec, plan.tcv, plan.lanes, plan.n_ctiles) == (8, 4, 64, 1)
    # ResNet-50's stage-1 exit: 128-byte tiles, two blocks per SM
    plan = bn._plan(200704, 256, 2, True, 132)
    assert (plan.vec, plan.tcv, plan.n_ctiles) == (8, 8, 4)
    assert plan.n_ctiles * plan.n_chunks == 264


def test_bn_backward_takes_cuda_tensors_only():
    x = torch.zeros(4, 8)
    v = torch.zeros(8)
    with pytest.raises(ValueError, match='CUDA'):
        ops.bn_backward(x, x, x, v, v, v, None, None, True, False)
    assert ops.KERNELS['bn_backward'] is ops.bn_backward
    before = ops.launch_counts()
    tx = torch.zeros(4, 8, requires_grad=True)
    ops.batch_norm_act(tx, torch.ones(8), v)[0].sum().backward()
    assert ops.launch_counts() == before    # CPU: the plain versions
