#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one
NVIDIA GPU (written for an H100: the kernels are built for ``sm_90a``).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit;
2. build: every ``chainermn_tpu_torch/csrc/*.cu`` with ``nvcc`` (all at
   once) into ``build/chainermn_tpu_torch/``;
3. kernels against their plain PyTorch versions on the card, at shapes
   of the ResNet-50 training path, with kernel / plain / library times
   and the bytes bound;
4. one train-mode forward of full-width ResNet-50 (f32, TF32 off, batch
   2) on the card (kernels) against the same model on the CPU (plain
   versions);
5. the main path: ``create_communicator('xla')`` (NCCL, a world of one)
   -> ``ResNet50(fused_norm=True)`` (224 px, bf16 compute) +
   ``StatefulClassifier`` -> ``create_multi_node_optimizer(
   FusedMomentumSGD)`` -> ``StandardUpdater`` -> ``Trainer`` over the
   synthetic ImageNet set at batch 64, with the kernel launch counts of
   that run checked against the model's structure.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA device;
without one it exits non-zero and prints no result.
"""

import importlib
import json
import math
import os
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BATCH = 64
STEPS = 10
# per forward of ResNet-50: bn_init + 16 blocks x 3 + 4 projections
BN_PER_STEP = 53
PARAMS_PER_STEP = 161          # parameter tensors of ResNet-50


def _say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes, n_flops):
    """The least time for the work: bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def max_err(a, b):
    return float((a.float() - b.float()).abs().max())


def check_close(what, got, want, rtol, atol):
    import torch
    if not torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol):
        raise AssertionError('%s: max abs err %.3g beyond rtol %g atol %g'
                             % (what, max_err(got, want), rtol, atol))


def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    _say('device', '%s; nvidia-smi: %s; torch %s, CUDA %s' % (
        name, smi, torch.__version__, torch.version.cuda))
    return name, smi


def phase_build():
    from chainermn_tpu_torch.ops._build import BUILD_DIR, LIBRARIES
    t0 = time.perf_counter()
    times = LIBRARIES.build_all()
    _say('build', 'nvcc %s in %.1f s wall (per source: %s)' % (
        'ran' if times else 'cache hit', time.perf_counter() - t0,
        ', '.join('%s %.1f s' % kv for kv in times.items()) or '-'))
    for log in sorted(BUILD_DIR.glob('*.log')):
        for line in log.read_text(errors='replace').splitlines():
            if 'Used' in line or 'spill' in line:
                _say('build', '%s: %s' % (log.stem.split('-')[0],
                                          line.strip()))


def _bn_case(gen, m, c, dtype, residual, relu):
    """Kernel vs plain on one (M, C) interlude; returns errors."""
    import torch
    from chainermn_tpu_torch import ops
    # the module (ops.batch_norm_act is the function of the same name)
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    dev = torch.device('cuda')
    x = (torch.randn((m, c), generator=gen, device=dev) * 2 + 0.5).to(dtype)
    res = torch.randn((m, c), generator=gen, device=dev).to(dtype) \
        if residual else None
    scale = torch.randn(c, generator=gen, device=dev) * 0.5 + 1.0
    bias = torch.randn(c, generator=gen, device=dev)
    mean, var, rstd = ops.bn_stats(x, 1e-5)
    pmean, pvar, prstd = bn._batch_stats(x, 1e-5)
    # f32 sums over up to 2e5 rows in another order than torch's
    for what, a, b in (('mean', mean, pmean), ('var', var, pvar),
                       ('rstd', rstd, prstd)):
        check_close('bn_stats %s %s' % (what, (m, c)), a, b, 1e-4, 1e-5)
    out = ops.bn_apply(x, res, mean, rstd, scale, bias, relu)
    pout = bn._apply_ref(x, mean, rstd, scale, bias, res, relu)
    # same inputs, same rounding order: expected bit-equal
    check_close('bn_apply %s' % ((m, c),), out, pout, 0.0, 0.0)
    # the whole forward against the plain forward (own statistics):
    # one bf16 rounding may flip, one part in 2**8
    full, _, _ = ops.batch_norm_act(x, scale, bias, residual=res, relu=relu)
    ref = bn._apply_ref(x, pmean, prstd, scale, bias, res, relu)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    check_close('batch_norm_act %s' % ((m, c),), full, ref, tol, tol)
    stats_err = max(max_err(mean, pmean), max_err(var, pvar),
                    max_err(rstd, prstd))
    _say('kernels', 'bn %s %s res=%s relu=%s: stats err %.3g, apply err '
         '%.3g, forward err %.3g' % ((m, c), str(dtype).split('.')[-1],
                                     residual, relu, stats_err,
                                     max_err(out, pout), max_err(full, ref)))
    return x, res, scale, bias, stats_err, max_err(out, pout)


def phase_kernels():
    import torch
    from chainermn_tpu_torch import models, ops
    # the module (ops.batch_norm_act is the function of the same name)
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    sgd = importlib.import_module('chainermn_tpu_torch.ops.optimizer')
    gen = torch.Generator(device='cuda').manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(BATCH * 56 * 56, 256, bf16, True, True),    # stage 1 exit
             (BATCH * 7 * 7, 2048, bf16, True, True),     # stage 4 exit
             (BATCH * 112 * 112, 64, bf16, False, True),  # stem
             (BATCH * 28 * 28, 512, f32, False, False),   # an f32 proj_bn
             (3139, 100, bf16, True, False)]              # ragged M and C
    stats_err = apply_err = 0.0
    timed = None
    for m, c, dtype, residual, relu in cases:
        x, res, scale, bias, se, ae = _bn_case(gen, m, c, dtype, residual,
                                               relu)
        stats_err, apply_err = max(stats_err, se), max(apply_err, ae)
        if timed is None:
            timed = (x, res, scale, bias)
    records = []
    # times at the stage-1 exit interlude, bf16 (64*56*56, 256) + residual
    x, res, scale, bias = timed
    m, c = x.shape
    mean, var, rstd = ops.bn_stats(x, 1e-5)
    t_kernel = time_ms(lambda: ops.bn_stats(x, 1e-5))
    t_plain = time_ms(lambda: bn._batch_stats(x, 1e-5))
    t_lib = time_ms(lambda: torch.var_mean(x, 0, correction=0))
    b_ms, b_by = bound_ms(m * c * x.element_size() + 3 * c * 4, 3 * m * c)
    records.append(dict(
        name='bn_stats', route='cuda',
        source='chainermn_tpu_torch/csrc/batch_norm_act.cu',
        replaces='chainermn_tpu/ops/batch_norm_act.py:110',
        max_abs_err=stats_err, ms=t_kernel, plain_ms=t_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=t_lib))
    t_kernel = time_ms(lambda: ops.bn_apply(x, res, mean, rstd, scale, bias,
                                            True))
    t_plain = time_ms(lambda: bn._apply_ref(x, mean, rstd, scale, bias, res,
                                            True))
    b_ms, b_by = bound_ms(3 * m * c * x.element_size() + 4 * c * 4,
                          5 * m * c)
    records.append(dict(
        name='bn_apply', route='cuda',
        source='chainermn_tpu_torch/csrc/batch_norm_act.cu',
        replaces='chainermn_tpu/ops/batch_norm_act.py:161',
        max_abs_err=apply_err, ms=t_kernel, plain_ms=t_plain,
        bound_ms=b_ms, bound_by=b_by, library_ms=None))
    _say('kernels', 'bn times at %s bf16 + residual: stats %.4f ms (plain '
         '%.4f, var_mean %.4f), apply %.4f ms (plain %.4f)' % (
             (m, c), records[0]['ms'], records[0]['plain_ms'],
             records[0]['library_ms'], records[1]['ms'],
             records[1]['plain_ms']))

    # momentum SGD over the ResNet-50 parameter list, 3 steps
    shapes_model = models.ResNet50(device='cuda')
    params = [p.detach() for p in shapes_model.parameters()]
    if len(params) != PARAMS_PER_STEP:
        raise AssertionError('ResNet-50 has %d parameter tensors, expected '
                             '%d' % (len(params), PARAMS_PER_STEP))
    del shapes_model
    kp = [p.clone() for p in params]
    pp = [p.clone() for p in params]
    kv = [torch.zeros_like(p) for p in params]
    pv = [torch.zeros_like(p) for p in params]
    for _ in range(3):
        # the param's own strides, as autograd lays out its gradient
        grads = [torch.empty_like(p).normal_(generator=gen) for p in params]
        for p, g, v in zip(kp, grads, kv):
            ops.sgd_update(p, g, v, 0.1, 0.9)
        for p, g, v in zip(pp, grads, pv):
            sgd._sgd_update_ref(p, g, v, 0.1, 0.9)
    sgd_err = max(max_err(a, b) for a, b in zip(kp + kv, pp + pv))
    # same two products and sums in the same order: expected bit-equal
    if sgd_err != 0.0:
        raise AssertionError('momentum_sgd: max abs err %.3g, expected 0'
                             % sgd_err)
    # the bf16-gradient instantiation (v stays f32)
    p1, v1 = torch.ones(4096, device='cuda'), torch.zeros(4096,
                                                         device='cuda')
    p2, v2 = p1.clone(), v1.clone()
    g16 = torch.randn(4096, generator=gen, device='cuda').to(bf16)
    ops.sgd_update(p1, g16, v1, 0.1, 0.9)
    sgd._sgd_update_ref(p2, g16, v2, 0.1, 0.9)
    check_close('momentum_sgd bf16 grads', p1, p2, 0.0, 0.0)
    check_close('momentum_sgd bf16 grads velocity', v1, v2, 0.0, 0.0)
    n = sum(p.numel() for p in params)
    t_kernel = time_ms(lambda: [ops.sgd_update(p, g, v, 0.1, 0.9)
                                for p, g, v in zip(kp, grads, kv)])
    t_plain = time_ms(lambda: [sgd._sgd_update_ref(p, g, v, 0.1, 0.9)
                               for p, g, v in zip(pp, grads, pv)])
    lp = [torch.nn.Parameter(p.clone()) for p in params]
    for p, g in zip(lp, grads):
        p.grad = g.clone()
    lib_opt = torch.optim.SGD(lp, lr=0.1, momentum=0.9, fused=True)
    t_lib = time_ms(lib_opt.step)
    b_ms, b_by = bound_ms(20 * n, 4 * n)
    records.append(dict(
        name='momentum_sgd', route='cuda',
        source='chainermn_tpu_torch/csrc/momentum_sgd.cu',
        replaces='chainermn_tpu/ops/optimizer.py:56',
        max_abs_err=sgd_err, ms=t_kernel, plain_ms=t_plain, bound_ms=b_ms,
        bound_by=b_by, library_ms=t_lib))
    _say('kernels', 'momentum_sgd over %d ResNet-50 tensors (%d f32 '
         'elements), one step: %.4f ms (plain %.4f, SGD(fused=True) %.4f)'
         % (len(params), n, t_kernel, t_plain, t_lib))
    return records


def phase_model_check():
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import models
    torch.backends.cudnn.allow_tf32 = False          # full f32 convs
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator().manual_seed(1)
        x = torch.randn((2, 224, 224, 3), generator=gen)
        y = torch.tensor([3, 777])
        outs = {}
        for dev in ('cuda', 'cpu'):
            model = models.ResNet50(dtype=torch.float32, fused_norm=True,
                                    device=dev,
                                    generator=torch.Generator().manual_seed(2))
            model.train()
            logits = model(x.to(dev))
            loss = F.cross_entropy(logits, y.to(dev))
            outs[dev] = (logits.detach().cpu(), loss.detach().cpu(),
                         models.to_flax_variables(model)['batch_stats'])
            del model
    finally:
        torch.backends.cudnn.allow_tf32 = True
    (gl, gloss, gstats), (cl, closs, cstats) = outs['cuda'], outs['cpu']
    # f32 with TF32 off: cuDNN and the CPU sum each convolution in another
    # order, and 53 BatchNorms renormalize along the way
    tol = 1e-3
    check_close('logits', gl, cl, tol, tol)
    check_close('loss', gloss, closs, tol, tol)
    worst = 0.0
    for block, leaves in _flat(gstats):
        want = dict(_flat(cstats))[block]
        check_close('running stats ' + block, torch.from_numpy(leaves),
                    torch.from_numpy(want), tol, tol)
        worst = max(worst, float(abs(leaves - want).max()))
    _say('model', 'ResNet-50 f32 batch 2, card vs CPU: logits err %.3g, '
         'loss %.6f vs %.6f, running-stats err %.3g (tolerance %g)' % (
             max_err(gl, cl), float(gloss), float(closs), worst, tol))


def _flat(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + '/')
        else:
            yield prefix + k, v


# kernel-name fragments of each group in the profile breakdown
_GROUPS = (('ported kernels', ('stats_partial', 'stats_finalize',
                               'apply_kernel', 'momentum_sgd')),
           ('convolutions', ('conv', 'cudnn', 'xmma', 'gemm', 'grad',
                             'fprop', 'implicit', 'cutlass')),
           ('nccl', ('nccl',)),
           ('copies and casts', ('memcpy', 'memset', 'copy')))


def profile_steps(updater, n=3):
    """Device time by kernel group over ``n`` more steps of the main
    path (``torch.profiler``), and the device busy share of that
    window's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            updater.update()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = {}
    for evt in prof.key_averages():
        # user annotations (e.g. Optimizer.step) span kernels already
        # counted: skip them
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, 'is_user_annotation', False)
                and not evt.key.startswith('Optimizer.')):
            kernels[evt.key] = kernels.get(evt.key, 0.0) \
                + evt.self_device_time_total
    busy = sum(kernels.values())
    if busy == 0:
        _say('profile', 'the profiler recorded no device time')
        return
    groups = {}
    for key, us in kernels.items():
        low = key.lower()
        group = next((g for g, frags in _GROUPS
                      if any(f in low for f in frags)), 'other')
        groups[group] = groups.get(group, 0.0) + us
    _say('profile', '%d steps: wall %.1f ms, device busy %.1f ms (%.1f%%, '
         'idle %.1f%%)' % (n, wall_us / 1e3, busy / 1e3,
                           100 * busy / wall_us, 100 - 100 * busy / wall_us))
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        _say('profile', '  %-16s %8.2f ms/step  %5.1f%% of device time'
             % (group, us / n / 1e3, 100 * us / busy))
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        _say('profile', '  %8.2f ms/step  %s' % (us / n / 1e3, key[:90]))


def phase_main_path():
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, ops, training
    from chainermn_tpu_torch.datasets import imagenet
    comm = cmt.create_communicator('xla')
    try:
        model = models.ResNet50(fused_norm=True)
        clf = models.StatefulClassifier(model)
        opt = cmt.create_multi_node_optimizer(
            ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
        raw, _ = imagenet.get_imagenet(BATCH, 8, size=256)
        mean = imagenet.compute_mean(raw, limit=BATCH)
        train = cmt.scatter_dataset(
            imagenet.PreprocessedDataset(raw, mean, 224, random=False), comm)
        train = [train[i] for i in range(len(train))]   # set-up, once
        updater = training.StandardUpdater(
            training.SerialIterator(train, BATCH, shuffle=False), opt,
            clf.loss, model, comm)
        trainer = training.Trainer(updater, (STEPS, 'iteration'))
        marks, losses = [], []

        def record(tr):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            losses.append(tr.observation['loss'])

        trainer.extend(record)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        profile_steps(updater)
    finally:
        comm.close()
    want = {'bn_stats': BN_PER_STEP * STEPS, 'bn_apply': BN_PER_STEP * STEPS,
            'momentum_sgd': PARAMS_PER_STEP * (STEPS - 1)}
    if counts != want:
        raise AssertionError('launch counts %s, expected %s' % (counts,
                                                                want))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('non-finite loss: %s' % losses)
    # the same batch at steps 0 and 1, and step 0 broadcasts instead of
    # stepping: equal up to cuDNN's choice of algorithm
    if abs(losses[0] - losses[1]) > 1e-3 * max(1.0, abs(losses[0])):
        raise AssertionError('loss at step 0 %r != step 1 %r'
                             % (losses[0], losses[1]))
    steps = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    timed = sorted(steps[2:])
    p50 = timed[len(timed) // 2]
    _say('main', 'losses %s' % ', '.join('%.4f' % v for v in losses))
    _say('main', 'launches %s over %d steps (per step: %d stats, %d apply, '
         '%d sgd after step 0)' % (counts, STEPS, BN_PER_STEP, BN_PER_STEP,
                                   PARAMS_PER_STEP))
    _say('main', 'step times ms %s; p50 of steps 2..%d %.2f ms = %.1f '
         'images/s at batch %d; peak memory %.2f GiB' % (
             ', '.join('%.1f' % (1e3 * s) for s in steps), STEPS - 1,
             1e3 * p50, BATCH / p50, BATCH,
             torch.cuda.max_memory_allocated() / 2 ** 30))
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chainermn_tpu_torch  # noqa: F401  (fails alone, as it should)
    name, smi = phase_device()
    phase_build()
    records = phase_kernels()
    phase_model_check()
    counts = phase_main_path()
    for rec in records:
        rec['launches'] = counts[rec['name']]
    print(json.dumps({'kernels': records}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
