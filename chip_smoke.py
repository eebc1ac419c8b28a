#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``chainermn_tpu_torch``) on one
NVIDIA GPU (written for an H100: the kernels are built for ``sm_90a``).

    python3 chip_smoke.py

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit;
2. build: every ``chainermn_tpu_torch/csrc/*.cu`` with ``nvcc`` (all at
   once) into ``build/chainermn_tpu_torch/``, each kernel's registers and
   spills from ``-Xptxas -v`` (a tensor-core, dq or decode kernel that
   spills fails);
3. kernels against their plain PyTorch versions on the card, at shapes
   of the ResNet-50 training path and of the full-width TransformerLM
   serving paths (LayerNorm, flash forward, decode attention and paged
   decode attention in bf16, f32 and int8, at lengths on both sides of
   the decode kernels' split boundaries, each bit-equal across two runs,
   timed also at the serve profile's lengths; paged decode also
   bit-equal to decode over the same pages gathered, with shuffled
   pages and dead table entries outside the pool; the flash forward's bf16
   tensor-core route at every head width, ragged, non-causal against
   more keys and with misaligned rows, its f32 scalar route; momentum
   SGD over ResNet-50's 161 tensors and over the MNIST MLP's 6 in one
   launch a step, bit-equal to its plain version over three steps, and
   with bf16 gradients; both BN kernels at four of GoogLeNet-BN's
   interludes, ``GBN_SHAPES``, bf16 + relu, the whole forward within
   ``BF16_TOL``, each timed under the row's ``googlenetbn_shapes``; the
   statistics within ``STATS_TOL`` of their plain version and bit-equal
   across two runs; the BN backward kernel over ``BWD_CASES`` (every
   distinct interlude of ResNet-50, ``RESNET50_BN``, in bf16; f32; with
   and without residual and relu, the statistics outputs' cotangents,
   ragged C, misaligned rows) and at ``GBN_SHAPES``, the statistics of
   each case held as above: its
   elementwise pass bit-equal to ``_bwd_apply_ref`` fed the kernel's own
   sums, dbeta and dgamma within ``BWD_SUM_EPS`` eps sum|term| of f64 sums
   and within twice the plain version's error, every output bit-equal
   across two runs, timed against the plain version and, without relu
   and residual, against ``aten.native_batch_norm_backward``), with
   kernel / plain / library times and the bound;
4. one train-mode forward of full-width ResNet-50 (f32, TF32 off, batch
   2) on the card (kernels) against the same model on the CPU (plain
   versions);
4a. the communicators (``comm``): each of the nine strategies on NCCL
   in a world of one, ``allreduce_grad`` of ResNet-50's 161 gradient
   tensors bit-equal to its input (and, with ``reduce_dtype`` bf16, to
   the bf16 round trip), its time a call (packing only: no wire), a
   bounded barrier and an object sent to this rank and back;
5. the training main path: ``create_communicator('xla')`` (NCCL, a
   world of one) -> ``ResNet50(fused_norm=True)`` (224 px, bf16
   compute) + ``StatefulClassifier`` -> ``create_multi_node_optimizer(
   FusedMomentumSGD)`` -> ``StandardUpdater`` -> ``Trainer`` over the
   synthetic ImageNet set at batch 64, with the kernel launch counts of
   that run checked against the model's structure (one ``bn_stats``,
   ``bn_apply`` and ``bn_backward`` per interlude a step, 53; one SGD
   launch a step for all 161 tensors); one more forward and backward
   holds each of the 53 interludes against the oracle on its own input,
   residual and output gradient, as in 5c (with a residual the oracle is
   the fused op's plain version: flax rounds before the add);
5a. the MNIST main path (``mnist``): the reference's convergence gate
   (``MLP(100)``, ``FusedMomentumSGD(0.1, 0.9)``, the hard stand-in, a
   batch of 104, 5 epochs, ``create_multi_node_evaluator`` every epoch,
   ``create_communicator('xla')`` on NCCL) reaches 0.95, launches
   ``momentum_sgd`` once a step after the broadcast call and no other
   kernel, and its first 5 losses, and every parameter and velocity
   after iteration 5, agree with the same run on the CPU; then the
   example ``train_mnist.main`` at full width (``MLP(1000)``, Adam, the
   classic stand-in, batch 100, 2 epochs): images/s from the p50 of the
   synchronized ``update()`` calls and over the whole window, the
   update p50/p99, the evaluator's time an epoch, the device busy share
   over 3 profiled steps, and its log and snapshots;
5b. the ImageNet main path (``imagenet``): the twin of
   ``examples/imagenet/train_imagenet.py`` (``train_imagenet.main``) with
   ``--communicator hierarchical --arch resnet50 --batchsize 64 --epoch
   1`` at insize 224 on the synthetic 1280 / 128 set: the
   ``distributed_sgd_schedule`` rate on ``FusedMomentumSGD``, a
   ``MultiprocessIterator`` under the updater's ``device_prefetch``
   (pinned batches, checked), the multi-node evaluator, a snapshot;
   ``momentum_sgd`` once an update after the broadcast call and no other
   kernel, finite losses, images/s from the p50 of the synchronized
   ``update()`` calls and over the whole window, the device busy share
   over 3 profiled steps, peak memory;
5c. the conv zoo (``zoo``): GoogLeNet-BN ``fused_norm=True`` against
   ``fused_norm=False`` on the card (f32, TF32 off, batch 4, 224 px:
   logits, loss and running averages against each other; every
   interlude on its own input and output gradient against the flax
   oracle (the fused route's backward is the ``bn_backward`` kernel);
   every gradient against the f64 model on the CPU, the fused
   path's relative L2 error within twice the larger of the unfused
   path's on the card and on the CPU); then its main path,
   ``GoogLeNetBN(fused_norm=True)`` (bf16, 224 px, batch 64) trained 6
   steps through ``StandardUpdater`` with ``FusedMomentumSGD``, one
   ``bn_stats``, one ``bn_apply`` and one ``bn_backward`` per interlude
   (68 a step, counted from the model) and two SGD launches a step (206
   tensors; a launch's table holds 200), checked, images/s, the device
   busy share and peak memory; one more step's forward and backward
   holds each of the 68 interludes, at the shapes and in the dtype of
   the main path, against the oracle on the same input and output
   gradient (the output within ``BF16_TOL``, the statistics within
   ``STATS_TOL``, the gradients within ``GRAD_TOL``, dx within
   ``BF16_TOL``'s rtol), and the whole
   model against unfused copies with the same weights (the loss within
   5e-2 of the bf16 copy's; the gradients' relative L2 distance from an
   f32 copy's within twice the bf16 copy's);
   then the ImageNet twin
   (``hierarchical``, batch 64, one epoch) for ``vgg16`` and
   ``googlenetbn`` at 224 px and ``alex``, ``nin`` and ``googlenet`` at
   ``--quick``: ``momentum_sgd`` once an update (twice for GoogLeNet-BN's
   206 tensors) and no other kernel,
   finite losses, images/s, peak memory;
5d. the model-parallel MNIST twin (``model_parallel``):
   ``train_mnist_model_parallel`` (``MultiNodeChainList(spmd=True)`` over
   ``MLP(200, 200)`` and ``MLP(200, 10)``, Adam 1e-3, batch 100) in a
   world of one: 5 iterations on the CPU (gloo) and on the card (NCCL)
   give the same losses and parameters (rtol 1e-4; parameters also
   atol 1e-4, a tenth of Adam's lr), then the whole run
   (5 epochs) on the card, timed, no kernel launched;
   ``pseudo_connect`` and a self-edge ``send`` on CUDA tensors;
5e. seq2seq (``seq2seq``): the twin of ``examples/seq2seq/train_seq2seq.py``
   at its defaults (2 x 256 LSTM, vocabulary 512, batch 64, buckets 8 /
   16 / 32, bf16) for one epoch of 8192 pairs: finite losses falling in
   every bucket, target tokens/s, no kernel launched; then
   ``Seq2seq()`` at its class defaults (2 x 512, vocabulary 8000) in
   f32, card against CPU on one padded 16 x 16 batch;
6. serving check: two f32 ``GenerationEngine``s at full width and depth
   2 from the same numpy-seeded weights, one on the card and one on the
   CPU, give the same greedy tokens for 8 prompts;
7. the serving main path: ``GenerationEngine`` over the full-width
   ``TransformerLM`` of the repo's serving benchmark (32000 vocab, d
   512, 8 heads, 6 layers, d_ff 2048) under ``Policy.bf16()``, 32
   slots, 64 prompts of 4..128 tokens, 32 new tokens each, with the
   launch counts checked against the structure, tokens/s, TTFT, the
   decode step, a profile of decode steps, a replay of the same
   requests with every step's logits checked finite, and an int8-KV
   engine;
7a. paged check: at full width, depth 2, f32, from phase 6's weights,
   the paged engine (whole prompts; chunks of 8; a shared-prefix set
   that hits the radix index and copies on write) and the speculative
   engine (a depth-1 draft; paged and not) on the card give the CPU's
   greedy tokens, and each speculative engine its plain twin's;
7b. the paged serving main path: ``GenerationEngine(paged=True,
   page_size=16)`` over phase 7's model and prompts, every stream equal
   to the slot engine's, launch counts checked (6 paged decode launches
   a decode step, 6 flash forwards a prefill chunk), metrics, pages in
   use and a decode profile; then ``prefill_chunk=32``; then one
   120-token leader and 31 followers sharing it (31 prefix hits, 31
   copies on write), with and without prefix sharing;
7c. the speculative main path: the same target with a 3-layer draft
   from another seed, ``spec_tokens=4``, paged, the 64 prompts; every
   request finishes, launch counts checked, the acceptance rate;
8. the training kernels against their plain versions on the card: the
   fused cross-entropy forward at the LM's ``(8192, 32000)`` f32 logits,
   and the two flash-attention backward kernels (dq with ``delta``; dk
   and dv) at the LM's ``(8, 1024, 8, 64)`` bf16 causal shape, ragged
   lengths, every head width, strided views, an expanded gradient and
   misaligned rows, each run twice for bit-equal results (in bf16 on the
   tensor-core kernels, in f32 on the scalar ones), the dq kernel's
   ``delta`` against ``rowsum(g * out)``, and dq + dk/dv timed together
   against SDPA's whole backward;
9. LM check: a depth-2 f32 full-width ``TransformerLM`` from
   numpy-seeded weights, ``lm_loss`` and every leaf's gradient on the
   card (kernels) against the CPU (plain versions);
10. the LM training main path: ``create_communicator('xla')`` ->
    ``TransformerLM`` (32000 vocab, d 512, 8 heads, 6 layers, d_ff 2048,
    max_len 1024; bf16 compute, f32 masters) ->
    ``create_multi_node_optimizer(torch.optim.Adam(lr=1e-3))`` ->
    ``StandardUpdater(lm_loss(model))`` -> ``Trainer`` on one fixed batch
    of 8 x 1024 tokens, with the launch counts checked against the
    structure, tokens/s, step times, peak memory and a profile.

A kernel row's ``ms``, ``plain_ms`` and ``library_ms`` are times per
call between CUDA events, launches included; ``device_ms``,
``plain_device_ms`` and ``library_device_ms`` sum only the kernels'
own device time from ``torch.profiler``, and are null when the tracer
recorded no device event in any of its tries (the script does not fail
for a lost trace: every check and every time of the contract comes from
the kernels' results and from CUDA events).

No PyTorch call computes the ``bn_apply`` row's case (+ residual,
+ relu), so its ``library_ms`` is null.  ``F.batch_norm(training=False)``
on the same statistics computes the kernel's no-residual, no-relu case:
the ``no_residual_*`` keys time the kernel and that call in that case,
with ``no_residual_bound_ms`` its bound.  Likewise the ``bn_backward``
row (ResNet-50's + residual + relu; GoogLeNet-BN's + relu) has a null
``library_ms``, and its ``no_relu_*`` keys time the kernel and
``aten.native_batch_norm_backward`` without relu and residual.  It
replaces no Pallas kernel: ``replaces`` names the reference's ``jnp``
backward.

A kernel row's ``launches`` sums the main paths that run it
(``launches_by_path`` splits them); each path is driven with the counts
set to 0 just before it and read just after.  The rows of the kernels
with a tensor-core route (bf16 ``flash_fwd``, ``flash_bwd_dq`` and
``flash_bwd_dkv``) add ``tc_launches``: every launch of theirs on a main
path took it (each path asserts so), their times are the tensor-core
kernel's at the LM shape, and ``scalar_f32_ms`` / ``scalar_f32_device_ms``
time the scalar kernel on f32 operands of that shape in the same call.
The ``momentum_sgd`` row times ``FusedMomentumSGD.step`` over the 161
tensors against ``torch.optim.SGD(fused=True).step``, and
``per_tensor_ms`` / ``per_tensor_device_ms`` the same kernel launched
once a tensor (``sgd_update``, a table of one), in the same call.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.  Needs one CUDA device;
without one it exits non-zero and prints no result.
"""

import gc
import importlib
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12   # H100 SXM bf16 dense tensor cores
BATCH = 64
STEPS = 10
# per forward of ResNet-50: bn_init + 16 blocks x 3 + 4 projections
BN_PER_STEP = 53
PARAMS_PER_STEP = 161          # parameter tensors of ResNet-50
# the serving benchmark's model and engine (bench.py --serve --generate)
SERVE_CFG = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
                 d_ff=2048, max_len=512)
SERVE_SLOTS = 32
SERVE_PROMPT = 128
SERVE_NEW = 32
SERVE_REQUESTS = 64
# (rtol, atol) of a serving kernel's bf16 output against its plain
# version: both compute in f32 and round once, so they differ by f32
# sums in another order (about 1e-6 on outputs of size 1) and at most
# one bf16 rounding flip, which is one unit in the last place: at most
# 2 ** -7 of the value
BF16_TOL = (2 ** -7, 1e-5)
# (rtol, atol) of the BN statistics against their plain version or the
# oracle's: f32 sums of the same values over up to 8e5 rows in another
# order
STATS_TOL = (1e-4, 1e-5)
# the LM training benchmark's model and batch (bench.py, the transformer
# model): 8 sequences of 1024 tokens, Adam at 1e-3
LM_CFG = dict(vocab_size=32000, d_model=512, n_heads=8, n_layers=6,
              d_ff=2048, max_len=1024)
LM_BATCH = 8
LM_SEQ = 1024
LM_STEPS = 10


def _say(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


def time_ms(fn, iters=20, warmup=3):
    """Mean time per call of ``fn`` over ``iters`` calls back to back,
    between two CUDA events: its kernels and the gaps in which the card
    waits for the host to launch them."""
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


# how often a profiled reading is taken again when its trace holds no
# device event: the tracer now and then loses a whole session
PROFILE_TRIES = 3


def device_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` per call: the time of every kernel it
    launches, summed from ``torch.profiler`` -- the launch gaps that
    ``time_ms`` counts are left out.  A trace without device events is
    taken again; ``None`` (not measured) when every try came back empty,
    since a lost trace says nothing about the kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(_kernel_times(prof).values())
        if us > 0:
            return us / iters / 1e3
        _say('profile', 'a trace held no device event')
    return None


def timings(kernel, plain, library, iters=20, plain_iters=None):
    """The times of one kernel row, each as ``time_ms`` (``ms``,
    ``plain_ms``, ``library_ms``: per call, launches included) and as
    ``device_ms`` (the ``*device_ms`` keys: kernels only)."""
    plain_iters = plain_iters or iters
    out = dict(ms=time_ms(kernel, iters), device_ms=device_ms(kernel, iters),
               plain_ms=time_ms(plain, plain_iters),
               plain_device_ms=device_ms(plain, plain_iters),
               library_ms=None, library_device_ms=None)
    if library is not None:
        out.update(library_ms=time_ms(library, iters),
                   library_device_ms=device_ms(library, iters))
    return out


def _ms(t):
    return '%.5f' % t if t is not None else 'not measured'


def _fmt(t):
    """A row's times for a log line."""
    return ('per call %.5f ms (plain %.5f, library %s); device only %s '
            'ms (plain %s, library %s)' % (
                t['ms'], t['plain_ms'], '%.5f' % t['library_ms']
                if t['library_ms'] is not None else '-', _ms(t['device_ms']),
                _ms(t['plain_device_ms']), _ms(t['library_device_ms'])
                if t['library_ms'] is not None else '-'))


def bound_ms(n_bytes, n_flops, flops_per_s=F32_FLOPS_PER_S):
    """The least time for the work: bytes over the memory rate or
    operations over their peak rate (float32 outside the tensor cores
    unless given), whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
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


def _entry_name(mangled):
    """A kernel's name and the rest of its mangled name (the template
    arguments and parameters), from the length-prefixed identifiers of
    an Itanium-mangled ``_ZN...`` name."""
    if not mangled.startswith('_ZN'):
        return mangled
    i, name = 3, mangled
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        name, i = mangled[j:j + int(mangled[i:j])], j + int(mangled[i:j])
    return '%s[%s]' % (name, mangled[i:]) if i < len(mangled) else name


def ptxas_report(text):
    """``(kernel, registers, spill-store bytes)`` for each entry function
    of an ``nvcc -Xptxas -v`` log."""
    out, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = _entry_name(m.group(1)), 0
            continue
        m = re.search(r'(\d+) bytes spill stores', line)
        if m:
            spill = int(m.group(1))
        m = re.search(r'Used (\d+) registers', line)
        if m and name is not None:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


def phase_build():
    from chainermn_tpu_torch.ops._build import BUILD_DIR, LIBRARIES
    t0 = time.perf_counter()
    times = LIBRARIES.build_all()
    _say('build', 'nvcc %s in %.1f s wall (per source: %s)' % (
        'ran' if times else 'cache hit', time.perf_counter() - t0,
        ', '.join('%s %.1f s' % kv for kv in times.items()) or '-'))
    spilled = []
    for log in sorted(BUILD_DIR.glob('*.log')):
        for name, regs, spill in ptxas_report(
                log.read_text(errors='replace')):
            _say('build', '%s: %s: %d registers, %d bytes spill stores' % (
                log.stem.split('-')[0], name, regs, spill))
            if spill:
                spilled.append(name)
    _say('build', 'kernels that spill: %s' % (', '.join(spilled) or 'none'))
    # the tensor-core kernels, every dq instantiation and every decode
    # instantiation are laid out to keep everything in registers
    bad = [name for name in spilled
           if '_tc_kernel' in name or 'flash_bwd_dq' in name
           or 'flash_decode' in name]
    if bad:
        raise AssertionError('a tensor-core, dq or decode kernel spills: %s'
                             % bad)


def _hold_stats(x):
    """``bn_stats`` on ``x`` within ``STATS_TOL`` of its plain version
    and bit-equal across two runs; returns both results."""
    import torch
    from chainermn_tpu_torch import ops
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    shape = tuple(x.shape)
    got = ops.bn_stats(x, 1e-5)
    plain = bn._batch_stats(x, 1e-5)
    # f32 sums over up to 8e5 rows in another order than torch's
    for what, a, b in zip(('mean', 'var', 'rstd'), got, plain):
        check_close('bn_stats %s %s' % (what, shape), a, b, *STATS_TOL)
    # a fixed order of sums, whichever block finishes last
    for what, a, b in zip(('mean', 'var', 'rstd'), got,
                          ops.bn_stats(x, 1e-5)):
        if not torch.equal(a, b):
            raise AssertionError('bn_stats %s %s differs between two runs'
                                 % (what, shape))
    return got, plain


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
    (mean, var, rstd), (pmean, pvar, prstd) = _hold_stats(x)
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


# GoogLeNet-BN's interludes at batch 64 and 224 px, (rows, channels): the
# stem's 112 x 112 x 64, two branch widths at 28 x 28 and the last stage's
# 352 channels at 7 x 7 (every channel count of the model is a multiple of
# the stats kernel's 32-channel tile; the ragged case above covers the
# partial tile)
GBN_SHAPES = ((BATCH * 112 * 112, 64), (BATCH * 28 * 28, 96),
              (BATCH * 28 * 28, 32), (BATCH * 7 * 7, 352))


def _googlenetbn_bn_rows(gen):
    """Both BN kernels at ``GBN_SHAPES`` in bf16 (relu, no residual, as
    every GoogLeNet-BN interlude): held to their plain versions (the
    whole forward within ``BF16_TOL``) and timed with their bounds;
    returns the ``googlenetbn_shapes`` entries of the two rows."""
    import torch
    from chainermn_tpu_torch import ops
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    stats_rows, apply_rows = [], []
    for m, c in GBN_SHAPES:
        x, _, scale, bias, se, ae = _bn_case(gen, m, c, torch.bfloat16,
                                             False, True)
        full, _, _ = ops.batch_norm_act(x, scale, bias, relu=True)
        pmean, _, prstd = bn._batch_stats(x, 1e-5)
        ref = bn._apply_ref(x, pmean, prstd, scale, bias, None, True)
        check_close('batch_norm_act at GoogLeNet-BN %s' % ((m, c),), full,
                    ref, *BF16_TOL)
        mean, _, rstd = ops.bn_stats(x, 1e-5)
        t = timings(lambda: ops.bn_stats(x, 1e-5),
                    lambda: bn._batch_stats(x, 1e-5),
                    lambda: torch.var_mean(x, 0, correction=0), iters=10)
        b_ms, b_by = bound_ms(m * c * 2 + 3 * c * 4, 3 * m * c)
        stats_rows.append(dict(shape=[m, c], max_abs_err=se, bound_ms=b_ms,
                               bound_by=b_by, **t))
        _say('kernels', 'bn_stats at GoogLeNet-BN %s bf16: %s; bound %.5f '
             'ms by %s' % ((m, c), _fmt(t), b_ms, b_by))
        t = timings(
            lambda: ops.bn_apply(x, None, mean, rstd, scale, bias, True),
            lambda: bn._apply_ref(x, mean, rstd, scale, bias, None, True),
            None, iters=10)
        b_ms, b_by = bound_ms(2 * m * c * 2 + 4 * c * 4, 4 * m * c)
        apply_rows.append(dict(shape=[m, c], max_abs_err=ae, bound_ms=b_ms,
                               bound_by=b_by, forward_err=max_err(full, ref),
                               **t))
        _say('kernels', 'bn_apply at GoogLeNet-BN %s bf16 + relu: %s; bound '
             '%.5f ms by %s' % ((m, c), _fmt(t), b_ms, b_by))
    return stats_rows, apply_rows


# float32's eps.  A compensated sum of n f32 terms is within (2u + O(n
# u^2)) sum |term| of the exact sum (Kahan's bound, u = eps / 2), and the
# trees that merge such sums with TwoSum and the final rounding add about
# u more: about 1.5 eps sum |term| in all.  bn_backward's dbeta and dgamma
# are held per channel to BWD_SUM_EPS eps sum |term| of f64 sums of the
# same f32 terms, and their worst channel to twice the plain version's
# worst (torch's sums) plus one eps of the largest sum (the result is an
# f32).
F32_EPS = 2.0 ** -23
BWD_SUM_EPS = 2.0

# ResNet-50's interludes at batch 64 and 224 px, each (rows, channels,
# residual, relu) once: the stem, then each stage's bottleneck BNs, the
# exit with the shortcut added and the projection (no relu).  The main
# path runs them in bf16; the first is the row's timed case
RESNET50_BN = ((BATCH * 56 * 56, 256, True, True),
               (BATCH * 112 * 112, 64, False, True),
               (BATCH * 56 * 56, 64, False, True),
               (BATCH * 56 * 56, 128, False, True),
               (BATCH * 56 * 56, 256, False, False),
               (BATCH * 28 * 28, 128, False, True),
               (BATCH * 28 * 28, 256, False, True),
               (BATCH * 28 * 28, 512, True, True),
               (BATCH * 28 * 28, 512, False, False),
               (BATCH * 14 * 14, 256, False, True),
               (BATCH * 14 * 14, 512, False, True),
               (BATCH * 14 * 14, 1024, True, True),
               (BATCH * 14 * 14, 1024, False, False),
               (BATCH * 7 * 7, 512, False, True),
               (BATCH * 7 * 7, 2048, True, True),
               (BATCH * 7 * 7, 2048, False, False))

# bn_backward's cases (rows, channels, dtype, residual, relu, statistics
# cotangents, misalignment in elements): every ResNet-50 interlude in bf16,
# an f32 projection, ragged C (2-byte loads), f32 with the statistics
# outputs' cotangents, misaligned rows (scalar loads)
BWD_CASES = tuple((m, c, 'bfloat16', res, relu, False, 0)
                  for m, c, res, relu in RESNET50_BN) + (
    (BATCH * 28 * 28, 512, 'float32', False, True, False, 0),
    (3139, 100, 'bfloat16', True, False, False, 0),
    (3139, 100, 'float32', True, True, True, 0),
    (3136, 352, 'bfloat16', False, True, False, 1))


def _bwd_case(gen, m, c, dtype, residual, relu, stats_cts=False, offset=0):
    """``bn_backward`` on one (M, C) case: the elementwise pass bit-equal
    to ``_bwd_apply_ref`` fed the kernel's own sums, dbeta and dgamma
    against f64 sums of the same f32 terms (``BWD_SUM_EPS``), every
    output bit-equal across two runs; the forward's statistics held by
    :func:`_hold_stats`.  Returns the operands (the forward's, through
    the BN kernels) and the readings."""
    import torch
    from chainermn_tpu_torch import ops
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    dev = torch.device('cuda')
    dtype = getattr(torch, dtype)

    def act(shift):
        buf = torch.randn(m * c + offset, generator=gen, device=dev)
        return (buf * 2 + shift).to(dtype)[offset:].view(m, c)

    x, g = act(0.5), act(0.0)
    res = act(0.0) if residual else None
    scale = torch.randn(c, generator=gen, device=dev) * 0.5 + 1.0
    bias = torch.randn(c, generator=gen, device=dev)
    (mean, _, rstd), _ = _hold_stats(x)
    out = ops.bn_apply(x, res, mean, rstd, scale, bias, relu)
    g_mean, g_var = ((torch.randn(c, generator=gen, device=dev),
                      torch.randn(c, generator=gen, device=dev))
                     if stats_cts else (None, None))
    args = (x, g, out, mean, rstd, scale, g_mean, g_var, relu, residual)
    what = 'bn_backward %s %s res=%s relu=%s%s%s' % (
        (m, c), str(dtype).split('.')[-1], residual, relu,
        ' with statistics cotangents' if stats_cts else '',
        ' misaligned' if offset else '')
    got = ops.bn_backward(*args)
    for name, a, b in zip(('dx', 'dgamma', 'dbeta', 'dres'), got,
                          ops.bn_backward(*args)):
        if a is not None and not torch.equal(a, b):
            raise AssertionError('%s: %s differs between two runs'
                                 % (what, name))
    dx, dgamma, dbeta, dres = got
    # the elementwise pass: the plain version's rounding order on the
    # kernel's own sums, expected bit-equal
    pdx, pdres = bn._bwd_apply_ref(x, g, out, mean, rstd, scale, dbeta,
                                   dgamma, g_mean, g_var, relu, residual)
    check_close(what + ' dx', dx, pdx, 0.0, 0.0)
    if residual:
        check_close(what + ' dres', dres, pdres, 0.0, 0.0)
    # the sums against f64 sums of the same f32 terms
    _, gm, xhat = bn._bwd_terms(x, g, out, mean, rstd, relu)
    plain = bn._bwd_sums_ref(x, g, out, mean, rstd, relu)
    units, errs = 0.0, {}
    for name, kernel, ref, terms in zip(('dbeta', 'dgamma'),
                                        (dbeta, dgamma), plain,
                                        (gm, gm * xhat)):
        exact = terms.double().sum(0)
        bound = BWD_SUM_EPS * F32_EPS * terms.double().abs().sum(0)
        err = (kernel.double() - exact).abs()
        perr = float((ref.double() - exact).abs().max())
        if not bool((err <= bound).all()):
            raise AssertionError(
                '%s %s: %.3g from the f64 sum, beyond %g eps sum|term|'
                % (what, name, float(err.max()), BWD_SUM_EPS))
        floor = F32_EPS * float(exact.abs().max())
        if float(err.max()) > 2 * perr + floor:
            raise AssertionError(
                '%s %s: %.3g from the f64 sum, the plain version %.3g'
                % (what, name, float(err.max()), perr))
        units = max(units, float((err / bound.clamp_min(1e-30)).max()))
        errs[name] = (float(err.max()), perr)
    full = bn._bwd_apply_ref(x, g, out, mean, rstd, scale, *plain, g_mean,
                             g_var, relu, residual)[0]
    _say('kernels', '%s: dx bit-equal to the plain pass on the kernel\'s '
         'sums; against f64 sums, kernel / plain: dbeta %.3g / %.3g, '
         'dgamma %.3g / %.3g (%.3g of the bound); dx against the whole '
         'plain backward %.3g' % (what, *errs['dbeta'], *errs['dgamma'],
                                  units, max_err(dx, full)))
    return args, dict(sums_units=units, max_abs_err=max(
        max_err(dx, full), max_err(dbeta, plain[0]),
        max_err(dgamma, plain[1])))


def _bwd_timings(args):
    """The times of ``bn_backward`` on ``args`` against its plain
    versions, with the bound; and, in the case a library call computes
    (no relu, no residual), the kernel against
    ``aten.native_batch_norm_backward`` on the same operands under the
    ``no_relu_*`` keys."""
    import torch
    from chainermn_tpu_torch import ops
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    x, g, out, mean, rstd, scale, _, _, relu, residual = args
    m, c = x.shape
    size = x.element_size()

    def plain():
        sums = bn._bwd_sums_ref(x, g, out, mean, rstd, relu)
        return bn._bwd_apply_ref(x, g, out, mean, rstd, scale, *sums, None,
                                 None, relu, residual)

    t = timings(lambda: ops.bn_backward(*args), plain, None, iters=10)
    # read x, g (and out under the relu); write dx (and dres); ~20 f32
    # operations an element over the two passes
    t['bound_ms'], t['bound_by'] = bound_ms(
        (3 + relu + residual) * m * c * size + 4 * c * 4, 20 * m * c)
    bare = (x, g, out, mean, rstd, scale, None, None, False, False)

    def library():
        return torch.ops.aten.native_batch_norm_backward(
            g, x, scale, None, None, mean, rstd, True, 1e-5,
            [True, True, True])

    want, got = library(), ops.bn_backward(*bare)
    tol = 1e-4 if x.dtype == torch.float32 else 2e-2
    check_close('native_batch_norm_backward vs bn_backward dx %s'
                % ((m, c),), want[0], got[0], tol, tol)
    for name, a, b in (('dgamma', want[1], got[1]),
                       ('dbeta', want[2], got[2])):
        check_close('native_batch_norm_backward vs bn_backward %s %s'
                    % (name, (m, c)), a, b, 1e-3, 1e-3 * float(
                        b.abs().max()))
    t.update(no_relu_case='no relu, no residual: aten.'
             'native_batch_norm_backward(g, x, scale, None, None, mean, '
             'rstd, True, eps, [True] * 3)',
             no_relu_ms=time_ms(lambda: ops.bn_backward(*bare), 10),
             no_relu_device_ms=device_ms(lambda: ops.bn_backward(*bare), 10),
             no_relu_library_ms=time_ms(library, 10),
             no_relu_library_device_ms=device_ms(library, 10),
             no_relu_bound_ms=bound_ms(3 * m * c * size + 4 * c * 4,
                                       20 * m * c)[0])
    return t


def _say_bwd(what, t):
    _say('kernels', 'bn_backward at %s: %s; bound %.5f ms by %s; no relu, '
         'no residual: kernel per call %.5f ms (native_batch_norm_backward '
         '%.5f), device only %s ms (library %s); bound %.5f ms' % (
             what, _fmt(t), t['bound_ms'], t['bound_by'], t['no_relu_ms'],
             t['no_relu_library_ms'], _ms(t['no_relu_device_ms']),
             _ms(t['no_relu_library_device_ms']), t['no_relu_bound_ms']))


def _bn_backward_record(gen):
    """``bn_backward``'s row: every case of ``BWD_CASES`` checked, the
    ResNet-50 case and GoogLeNet-BN's shapes (bf16 + relu, as its
    interludes) checked and timed."""
    timed, worst, units = None, 0.0, 0.0
    for m, c, dtype, residual, relu, cts, offset in BWD_CASES:
        args, r = _bwd_case(gen, m, c, dtype, residual, relu, cts, offset)
        worst, units = max(worst, r['max_abs_err']), max(units,
                                                         r['sums_units'])
        if timed is None:
            timed = args
    gbn = []
    for m, c in GBN_SHAPES:
        args, r = _bwd_case(gen, m, c, 'bfloat16', False, True)
        t = _bwd_timings(args)
        gbn.append(dict(shape=[m, c], **r, **t))
        _say_bwd('GoogLeNet-BN %s bf16 + relu' % ((m, c),), t)
        worst, units = max(worst, r['max_abs_err']), max(units,
                                                         r['sums_units'])
    t = _bwd_timings(timed)
    m, c = timed[0].shape
    _say_bwd('%s bf16 + residual + relu' % ((m, c),), t)
    return dict(
        name='bn_backward', route='cuda',
        source='chainermn_tpu_torch/csrc/batch_norm_act.cu',
        replaces='chainermn_tpu/ops/batch_norm_act.py:221',
        replaces_note='_bn_act_bwd, jnp in the reference (beyond the ten '
        'Pallas kernels)', max_abs_err=worst, sums_units=units,
        googlenetbn_shapes=gbn, **t)


def phase_kernels():
    import torch
    import torch.nn.functional as F
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
    gbn_stats, gbn_apply = _googlenetbn_bn_rows(gen)
    records = []
    # times at the stage-1 exit interlude, bf16 (64*56*56, 256) + residual
    x, res, scale, bias = timed
    m, c = x.shape
    mean, var, rstd = ops.bn_stats(x, 1e-5)
    t = timings(lambda: ops.bn_stats(x, 1e-5),
                lambda: bn._batch_stats(x, 1e-5),
                lambda: torch.var_mean(x, 0, correction=0))
    b_ms, b_by = bound_ms(m * c * x.element_size() + 3 * c * 4, 3 * m * c)
    records.append(dict(
        name='bn_stats', route='cuda',
        source='chainermn_tpu_torch/csrc/batch_norm_act.cu',
        replaces='chainermn_tpu/ops/batch_norm_act.py:110',
        max_abs_err=stats_err, bound_ms=b_ms, bound_by=b_by,
        googlenetbn_shapes=gbn_stats, **t))
    _say('kernels', 'bn_stats at %s bf16: %s (var_mean)' % ((m, c), _fmt(t)))
    # F.batch_norm in inference form, from the same statistics, computes
    # the kernel's no-residual, no-relu case: checked to agree
    def library():
        return F.batch_norm(x, mean, var, scale, bias, training=False,
                            eps=1e-5)

    def kernel_alone():
        return ops.bn_apply(x, None, mean, rstd, scale, bias, False)

    check_close('F.batch_norm vs bn_apply %s' % ((m, c),), library(),
                kernel_alone(), 2e-2, 2e-2)
    # no PyTorch call computes the row's case (+ residual, + relu), so
    # its library_ms is null; the library's own case is timed under the
    # ``no_residual_*`` keys, kernel and library side by side
    t = timings(lambda: ops.bn_apply(x, res, mean, rstd, scale, bias, True),
                lambda: bn._apply_ref(x, mean, rstd, scale, bias, res, True),
                None)
    nr_bound, nr_by = bound_ms(2 * m * c * x.element_size() + 4 * c * 4,
                               4 * m * c)
    t.update(no_residual_case='no residual, no relu: F.batch_norm(x, '
             'mean, var, scale, bias, training=False)',
             no_residual_ms=time_ms(kernel_alone),
             no_residual_device_ms=device_ms(kernel_alone),
             no_residual_library_ms=time_ms(library),
             no_residual_library_device_ms=device_ms(library),
             no_residual_bound_ms=nr_bound)
    b_ms, b_by = bound_ms(3 * m * c * x.element_size() + 4 * c * 4,
                          5 * m * c)
    records.append(dict(
        name='bn_apply', route='cuda',
        source='chainermn_tpu_torch/csrc/batch_norm_act.cu',
        replaces='chainermn_tpu/ops/batch_norm_act.py:161',
        max_abs_err=apply_err, bound_ms=b_ms, bound_by=b_by,
        googlenetbn_shapes=gbn_apply, **t))
    _say('kernels', 'bn_apply at %s bf16 + residual + relu: %s; without '
         'residual and relu: kernel per call %.5f ms (F.batch_norm %.5f), '
         'device only %s ms (F.batch_norm %s); bound %.5f ms by %s' % (
             (m, c), _fmt(t), t['no_residual_ms'],
             t['no_residual_library_ms'], _ms(t['no_residual_device_ms']),
             _ms(t['no_residual_library_device_ms']), nr_bound, nr_by))
    records.append(_bn_backward_record(gen))

    # momentum SGD over the ResNet-50 parameter list, 3 steps, one launch
    # a step for all 161 tensors
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
        before = (ops.momentum_sgd.launches, ops.momentum_sgd.tensors)
        ops.momentum_sgd(kp, grads, kv, 0.1, 0.9)
        made = (ops.momentum_sgd.launches - before[0],
                ops.momentum_sgd.tensors - before[1])
        if made != (1, PARAMS_PER_STEP):
            raise AssertionError('momentum_sgd: %d launches for %d tensors, '
                                 'expected 1 for %d' % (*made,
                                                        PARAMS_PER_STEP))
        for p, g, v in zip(pp, grads, pv):
            sgd._sgd_update_ref(p, g, v, 0.1, 0.9)
    sgd_err = max(max_err(a, b) for a, b in zip(kp + kv, pp + pv))
    # same two products and sums in the same order: expected bit-equal
    if sgd_err != 0.0:
        raise AssertionError('momentum_sgd: max abs err %.3g, expected 0'
                             % sgd_err)
    # the MNIST MLP's six tensors (MLP(100)), as the gate steps them: one
    # launch a step, bit-equal too
    mlp = [(100, 784), (100,), (100, 100), (100,), (10, 100), (10,)]
    mp = [torch.empty(s, device='cuda').normal_(generator=gen) for s in mlp]
    mv = [torch.zeros_like(p) for p in mp]
    rp, rv = [p.clone() for p in mp], [v.clone() for v in mv]
    for _ in range(3):
        mg = [torch.empty_like(p).normal_(generator=gen) for p in mp]
        before = ops.momentum_sgd.launches
        ops.momentum_sgd(mp, mg, mv, 0.1, 0.9)
        if ops.momentum_sgd.launches - before != 1:
            raise AssertionError('momentum_sgd: the MLP\'s tensors took %d '
                                 'launches' % (ops.momentum_sgd.launches
                                               - before))
        for p, g, v in zip(rp, mg, rv):
            sgd._sgd_update_ref(p, g, v, 0.1, 0.9)
    mlp_err = max(max_err(a, b) for a, b in zip(mp + mv, rp + rv))
    if mlp_err != 0.0:
        raise AssertionError('momentum_sgd at the MLP\'s shapes: max abs '
                             'err %.3g, expected 0' % mlp_err)
    # the bf16-gradient instantiation (v stays f32), in one table with a
    # tensor of another dtype pair: one launch each
    p1 = [torch.ones(4096, device='cuda'), torch.ones(999, device='cuda')]
    v1 = [torch.zeros_like(p) for p in p1]
    p2, v2 = [p.clone() for p in p1], [v.clone() for v in v1]
    g16 = [torch.randn(4096, generator=gen, device='cuda').to(bf16),
           torch.randn(999, generator=gen, device='cuda')]
    before = ops.momentum_sgd.launches
    ops.momentum_sgd(p1, g16, v1, 0.1, 0.9)
    if ops.momentum_sgd.launches - before != 2:
        raise AssertionError('momentum_sgd: two dtype pairs took %d launches'
                             % (ops.momentum_sgd.launches - before))
    for p, g, v in zip(p2, g16, v2):
        sgd._sgd_update_ref(p, g, v, 0.1, 0.9)
    for a, b in zip(p1 + v1, p2 + v2):
        check_close('momentum_sgd bf16 grads', a, b, 0.0, 0.0)
    # the one-tensor wrapper is the same kernel with a table of one
    p3, v3 = kp[0].clone(), kv[0].clone()
    ops.sgd_update(p3, grads[0], v3, 0.1, 0.9)
    sgd._sgd_update_ref(pp[0], grads[0], pv[0], 0.1, 0.9)
    check_close('sgd_update', p3, pp[0], 0.0, 0.0)
    n = sum(p.numel() for p in params)
    # the optimizers as a training step calls them: ours (a layout check
    # per grad and one launch) against PyTorch's fused multi-tensor SGD
    fp = [torch.nn.Parameter(p.clone()) for p in params]
    lp = [torch.nn.Parameter(p.clone()) for p in params]
    for a, b, g in zip(fp, lp, grads):
        a.grad, b.grad = g.clone(), g.clone()
    opt = ops.FusedMomentumSGD(fp, 0.1, 0.9)
    lib_opt = torch.optim.SGD(lp, lr=0.1, momentum=0.9, fused=True)
    t = timings(opt.step,
                lambda: [sgd._sgd_update_ref(p, g, v, 0.1, 0.9)
                         for p, g, v in zip(pp, grads, pv)],
                lib_opt.step, iters=10)
    # the same kernel launched once a tensor (a table of one each), in
    # the same call
    t.update(per_tensor_ms=time_ms(lambda: [
        ops.sgd_update(p, g, v, 0.1, 0.9)
        for p, g, v in zip(kp, grads, kv)], 10), per_tensor_device_ms=(
        device_ms(lambda: [ops.sgd_update(p, g, v, 0.1, 0.9)
                           for p, g, v in zip(kp, grads, kv)], 10)))
    b_ms, b_by = bound_ms(20 * n, 4 * n)
    records.append(dict(
        name='momentum_sgd', route='cuda',
        source='chainermn_tpu_torch/csrc/momentum_sgd.cu',
        replaces='chainermn_tpu/ops/optimizer.py:56',
        max_abs_err=sgd_err, bound_ms=b_ms, bound_by=b_by, **t))
    _say('kernels', 'momentum_sgd over %d ResNet-50 tensors (%d f32 '
         'elements), one launch, FusedMomentumSGD.step: %s '
         '(SGD(fused=True).step); the same kernel once a tensor: per call '
         '%.5f ms, device only %s ms; bound %.5f ms by %s'
         % (len(params), n, _fmt(t), t['per_tensor_ms'],
            _ms(t['per_tensor_device_ms']), b_ms, b_by))
    return records


def _strided_qkv(gen, lead, h, d, dtype):
    """q, k, v as the model hands them over: strided views of one fused
    ``(*lead, 3, H, D)`` projection."""
    import torch
    qkv = torch.randn(lead + (3, h, d), generator=gen, device='cuda')
    qkv = qkv.to(dtype)
    idx = len(lead)
    return tuple(qkv.select(idx, i) for i in range(3))


def _ln_cases(gen):
    """LayerNorm kernel vs plain at the serving shapes and at the LM
    training shape (bf16 rows, f32 ``gamma`` / ``beta``: the f32 master
    parameters); returns the record and the max error."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    bf16, f32 = torch.bfloat16, torch.float32
    err = {f32: 0.0, bf16: 0.0}
    # f32 statistics in another order: 2e-5; bf16 output: BF16_TOL
    tol = {f32: (2e-5, 2e-5), bf16: BF16_TOL}
    timed = {}
    for n, dtype, g_dtype in ((128, bf16, bf16), (32, bf16, bf16),
                              (100, f32, f32), (1, bf16, bf16),
                              (32, bf16, f32), (100, f32, bf16),
                              (LM_BATCH * LM_SEQ, bf16, f32)):
        x = (torch.randn((n, 512), generator=gen, device='cuda') * 3
             + 1).to(dtype)
        g = (torch.randn(512, generator=gen, device='cuda') * 0.5
             + 1).to(g_dtype)
        b = torch.randn(512, generator=gen, device='cuda').to(g_dtype)
        got = ops.ln_forward(x, g, b)
        torch.cuda.synchronize()
        want = ops.layer_norm_reference(x, g, b)
        check_close('layer_norm %s x %s gamma %s' % ((n, 512), dtype, g_dtype),
                    got, want, *tol[dtype])
        err[dtype] = max(err[dtype], max_err(got, want))
        timed[(n, g_dtype)] = (x, g, b)
    records = {}
    for key in ((32, bf16), (LM_BATCH * LM_SEQ, f32)):
        x, g, b = timed[key]
        n, d = x.shape
        # the library call takes one dtype: gamma and beta rounded to x's
        # beforehand, outside the timed call
        lg, lb = g.to(x.dtype), b.to(x.dtype)
        t = timings(lambda: ops.ln_forward(x, g, b),
                    lambda: ops.layer_norm_reference(x, g, b),
                    lambda: F.layer_norm(x, (d,), lg, lb, 1e-6),
                    iters=200 if n == 32 else 20)
        b_ms, b_by = bound_ms(2 * n * d * x.element_size()
                              + 2 * d * g.element_size(), 8 * n * d)
        records[key] = dict(bound_ms=b_ms, bound_by=b_by, **t)
        _say('kernels', 'layer_norm at %s bf16, gamma %s: %s (F.layer_norm); '
             'bound %.5f ms by %s' % ((n, d), str(g.dtype).split('.')[-1],
                                      _fmt(t), b_ms, b_by))
    _say('kernels', 'layer_norm max err f32 %.3g, bf16 %.3g over %d cases '
         '(rtol, atol: %s, %s)' % (err[f32], err[bf16], len(timed), tol[f32],
                                   tol[bf16]))
    return dict(name='layer_norm', route='cuda',
                source='chainermn_tpu_torch/csrc/layer_norm.cu',
                replaces='chainermn_tpu/ops/layer_norm.py:40',
                max_abs_err=max(err.values()), **records[(32, bf16)])


def _flash_fwd_cost(b, t, h, d, itemsize):
    """Bytes (q, k, v read once, out written once, lse) and operations
    (two products over the causal half) of one causal forward."""
    pairs = t * (t + 1) // 2
    return (4 * b * t * h * d * itemsize + 4 * b * h * t,
            4 * b * h * pairs * d)


def _misaligned(x):
    """A copy of ``x`` whose rows start 2 bytes past a 16-byte boundary:
    the tensor-core wrappers hand the kernel a contiguous copy of it."""
    import torch
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = flat[1:].view(x.shape)
    y.copy_(x)
    return y


def _tc_count(name):
    from chainermn_tpu_torch import ops
    return ops.tc_launch_counts()[name]


def _flash_cases(gen):
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')
    bf16, f32 = torch.bfloat16, torch.float32
    # out: f32 sums in another order, 1e-5; bf16: BF16_TOL.  lse (f32 in
    # both): rtol 1e-5, atol 1e-4 (the log of a sum of up to 2048 terms)
    tol = {f32: (1e-5, 1e-5), bf16: BF16_TOL}
    errs = []
    lm_shape = (LM_BATCH, LM_SEQ, LM_CFG['n_heads'],
                LM_CFG['d_model'] // LM_CFG['n_heads'])
    # (32, 4, 8, 64): the speculative verify window (bucket rows of
    # spec_tokens rows each); (1, 32, 8, 64): a 32-row prefill chunk.
    # bf16 takes the tensor-core kernel, f32 the scalar one; the last
    # three bf16 cases: every head width ragged across the 64-row tile
    cases = [((1, 128, 8, 64), bf16), ((1, 100, 8, 64), f32),
             ((2, 2048, 8, 64), bf16), ((1, 37, 4, 32), bf16),
             ((1, 70, 2, 128), f32), (lm_shape, bf16),
             ((32, 4, 8, 64), bf16), ((1, 32, 8, 64), bf16),
             ((2, 130, 4, 32), bf16), ((2, 65, 4, 64), bf16),
             ((1, 130, 2, 128), bf16)]
    timed = {}
    for (b, t, h, d), dtype in cases:
        q, k, v = _strided_qkv(gen, (b, t), h, d, dtype)
        tc0 = _tc_count('flash_fwd')
        out, lse = ops.flash_fwd(q, k, v, True, d ** -0.5)
        if _tc_count('flash_fwd') - tc0 != (dtype == bf16):
            raise AssertionError('flash_fwd %s: the tensor-core kernel runs '
                                 'for bf16 and only for bf16' % dtype)
        pout, plse = fa._fwd_plain(q, k, v, True, d ** -0.5)
        check_close('flash_fwd out %s %s' % ((b, t, h, d), dtype), out, pout,
                    *tol[dtype])
        check_close('flash_fwd lse %s' % ((b, t, h, d),), lse, plse,
                    1e-5, 1e-4)
        # contiguous operands give the same numbers as the strided views
        cout, _ = ops.flash_fwd(q.contiguous(), k.contiguous(),
                                v.contiguous(), True, d ** -0.5)
        check_close('flash_fwd strided vs contiguous', out, cout, 0.0, 0.0)
        errs.append(max_err(out, pout))
        timed[(b, t, h, d)] = (q, k, v)
    # non-causal calls (the kv_len mask alone), t_q == t_kv in f32, t_q !=
    # t_kv in bf16
    q, k, v = _strided_qkv(gen, (2, 77), 8, 64, f32)
    out, lse = ops.flash_fwd(q, k, v, False, 0.125)
    pout, plse = fa._fwd_plain(q, k, v, False, 0.125)
    check_close('flash_fwd non-causal', out, pout, 1e-5, 1e-5)
    errs.append(max_err(out, pout))
    for (b, t, h, d), t_kv in (((2, 77, 8, 64), 150), ((1, 40, 2, 128), 90)):
        q, _, _ = _strided_qkv(gen, (b, t), h, d, bf16)
        _, k, v = _strided_qkv(gen, (b, t_kv), h, d, bf16)
        out, lse = ops.flash_fwd(q, k, v, False, d ** -0.5)
        pout, plse = fa._fwd_plain(q, k, v, False, d ** -0.5)
        what = 'flash_fwd non-causal %s against %d keys bf16' % ((b, t, h, d),
                                                                t_kv)
        check_close(what, out, pout, *BF16_TOL)
        check_close(what + ' lse', lse, plse, 1e-5, 1e-4)
        errs.append(max_err(out, pout))
    # rows that are not 16-byte aligned: the wrapper hands the kernel a
    # contiguous copy, which gives the aligned operands' bits
    q, k, v = timed[(1, 128, 8, 64)]
    mq = _misaligned(q)
    if fa._aligned16(mq) or not fa._aligned16(q):
        raise AssertionError('expected a misaligned copy of aligned rows')
    out, _ = ops.flash_fwd(mq, k, v, True, 0.125)
    want, _ = ops.flash_fwd(q, k, v, True, 0.125)
    check_close('flash_fwd misaligned q', out, want, 0.0, 0.0)
    records = {}
    for shape in ((1, 128, 8, 64), (2, 2048, 8, 64), lm_shape):
        q, k, v = timed[shape]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        t = timings(lambda: ops.flash_fwd(q, k, v, True, 0.125),
                    lambda: fa._fwd_plain(q, k, v, True, 0.125),
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True),
                    iters=50 if shape[1] == 128 else 10, plain_iters=3)
        n_bytes, n_ops = _flash_fwd_cost(*shape, 2)
        b_ms, b_by = bound_ms(n_bytes, n_ops, BF16_TC_FLOPS_PER_S)
        records[shape] = dict(bound_ms=b_ms, bound_by=b_by, **t)
        _say('kernels', 'flash_fwd causal %s bf16 (tensor cores): %s (SDPA); '
             'bound %.5f ms by %s' % (shape, _fmt(t), b_ms, b_by))
    # the scalar kernel (the f32 route, the design the tensor-core kernel
    # replaced for bf16) at the LM shape, in the same call
    qf, kf, vf = (x.float() for x in timed[lm_shape])
    scalar = dict(scalar_f32_ms=time_ms(
        lambda: ops.flash_fwd(qf, kf, vf, True, 0.125), 10),
        scalar_f32_device_ms=device_ms(
            lambda: ops.flash_fwd(qf, kf, vf, True, 0.125), 10))
    _say('kernels', 'flash_fwd causal %s f32 (scalar kernel): per call %.5f '
         'ms, device only %s ms' % (lm_shape, scalar['scalar_f32_ms'],
                                    _ms(scalar['scalar_f32_device_ms'])))
    _say('kernels', 'flash_fwd max err %.3g over %d cases (bf16 rtol, atol: '
         '%s)' % (max(errs), len(errs), BF16_TOL))
    return dict(name='flash_fwd', route='cuda',
                source='chainermn_tpu_torch/csrc/flash_attention.cu',
                replaces='chainermn_tpu/ops/flash_attention.py:144',
                max_abs_err=max(errs), shape=list(lm_shape),
                other_shapes={str(sh): records[sh] for sh in
                              ((1, 128, 8, 64), (2, 2048, 8, 64))},
                **scalar, **records[lm_shape])


def _decode_inputs(gen, rows, n_slots, s, h, d, dtype, lengths=None):
    import torch
    q, _, _ = _strided_qkv(gen, (rows,), h, d, dtype)
    k = torch.randn((n_slots, s, h, d), generator=gen, device='cuda')
    v = torch.randn((n_slots, s, h, d), generator=gen, device='cuda')
    if lengths is None:
        lengths = torch.randint(1, s + 1, (rows,), generator=gen,
                                device='cuda', dtype=torch.int32)
        lengths[0], lengths[-1] = 1, s
    else:
        lengths = torch.tensor(lengths, dtype=torch.int32, device='cuda')
    return q, k.to(dtype), v.to(dtype), lengths


def _split_lengths(s):
    """Lengths on both sides of the decode kernels' split boundaries (the
    splits are ``DECODE_SPLIT`` positions): 1, kSplit - 1, kSplit, kSplit
    + 1, two splits and one more, three splits, S - 1 and S (those up to
    S)."""
    fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')
    n = fa.DECODE_SPLIT
    return [x for x in (1, n - 1, n, n + 1, 2 * n, 2 * n + 1, 3 * n)
            if x < s - 1] + [s - 1, s]


def _serve_lengths(gen, rows=SERVE_SLOTS):
    """The live lengths of the serve profile's decode steps: 64-token
    prompts a few steps in, 65-96."""
    import torch
    return torch.randint(65, 97, (rows,), generator=gen, device='cuda',
                         dtype=torch.int32)


def _decode_bytes(lengths, h, d, itemsize, scales=False):
    """The live K/V read once (with their f32 scales for int8), q read and
    out written (bf16)."""
    live = int(lengths.sum())
    per_pos = 2 * h * (d * itemsize + (4 if scales else 0))
    return live * per_pos + 2 * lengths.numel() * h * d * 2, live


def _decode_row(kernel, plain, library, lengths, h, d, itemsize, extra=0):
    """Times and bound of one decode shape (bf16 K/V)."""
    t = timings(kernel, plain, library, iters=200, plain_iters=5)
    n_bytes, live = _decode_bytes(lengths, h, d, itemsize)
    b_ms, b_by = bound_ms(n_bytes + extra, 4 * live * h * d)
    return dict(bound_ms=b_ms, bound_by=b_by, live_positions=live, **t)


def _decode_cases(gen):
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.precision import quantize_kv
    fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')
    bf16, f32 = torch.bfloat16, torch.float32
    # f32 sums in another order, 1e-5; bf16 out: BF16_TOL; int8: the same
    # dequantized values, the scales applied to the score and to p in the
    # kernel and to k and v in the plain version (the same f32 products
    # in another order)
    tol = {f32: (1e-5, 1e-5), bf16: BF16_TOL}
    errs = []
    timed = {}
    # the last three: lengths on both sides of the split boundaries, at
    # every head width
    for rows, n_slots, s, h, d, dtype, lens in (
            (32, 32, 512, 8, 64, bf16, None),
            (32, 32, 512, 8, 64, f32, None),
            (5, 9, 300, 4, 128, f32, None),
            (7, 7, 33, 2, 32, bf16, None),
            (9, 12, 512, 8, 64, bf16, _split_lengths(512)),
            (9, 9, 300, 4, 128, bf16, _split_lengths(300)),
            (9, 11, 400, 2, 32, f32, _split_lengths(400))):
        rows = rows if lens is None else len(lens)
        q, k, v, lengths = _decode_inputs(gen, rows, n_slots, s, h, d, dtype,
                                          lens)
        slots = torch.randperm(n_slots, generator=gen, device='cuda')[:rows]
        slots = slots.to(torch.int32)
        for kind in ('float', 'int8'):
            if kind == 'int8':
                kq, ks = quantize_kv(k)
                vq, vs = quantize_kv(v)
                args = (kq, vq, dict(k_scale=ks, v_scale=vs))
            else:
                args = (k, v, {})
            for sl in ((None, slots) if rows == n_slots else (slots,)):
                what = 'flash_decode %s %s %s slots=%s' % (
                    (rows, n_slots, s, h, d), dtype, kind, sl is not None)
                got = ops.flash_decode(q, args[0], args[1], lengths,
                                       d ** -0.5, slots=sl, **args[2])
                want = fa._decode_plain(q, args[0], args[1], lengths,
                                        d ** -0.5, args[2].get('k_scale'),
                                        args[2].get('v_scale'), sl)
                check_close(what, got, want, *tol[dtype])
                errs.append(max_err(got, want))
                again = ops.flash_decode(q, args[0], args[1], lengths,
                                         d ** -0.5, slots=sl, **args[2])
                if not torch.equal(again, got):
                    raise AssertionError(what + ': two runs differ')
            if (rows, s, dtype, lens) == (32, 512, bf16, None):
                timed[kind] = (q, args, lengths)
    q, (k, v, _), lengths = timed['float']
    rows, h, d = q.shape

    def row(lengths):
        mask = (torch.arange(k.shape[1], device='cuda')[None, :]
                < lengths[:, None])[:, None, None, :]
        # (rows, H, 1, D) queries against (rows, H, S, D) views of the cache
        qt, kt, vt = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        return _decode_row(
            lambda: ops.flash_decode(q, k, v, lengths, 0.125),
            lambda: fa._decode_plain(q, k, v, lengths, 0.125, None, None,
                                     None),
            lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                   attn_mask=mask),
            lengths, h, d, k.element_size())

    rec = row(lengths)
    serve_lengths = _serve_lengths(gen)
    serve = row(serve_lengths)
    qi, (ki, vi, sc), _ = timed['int8']
    t_int8 = device_ms(lambda: ops.flash_decode(qi, ki, vi, lengths, 0.125,
                                                **sc))
    i8_ms, _ = bound_ms(_decode_bytes(lengths, h, d, 1, True)[0], 0)
    for what, r in (('S 512, uniform lengths', rec),
                    ('S 512, the serve profile\'s lengths 65-96', serve)):
        _say('kernels', 'flash_decode 32 rows, %s, %d live positions, bf16: '
             '%s (SDPA with a length mask); bound %.5f ms' % (
                 what, r['live_positions'], _fmt(r), r['bound_ms']))
    _say('kernels', 'flash_decode max err %.3g over %d cases (bf16 rtol, '
         'atol: %s), bit-equal between two runs in every case; int8 at S '
         '512, uniform lengths: device only %s ms (bound %.5f)' % (
             max(errs), len(errs), BF16_TOL, _ms(t_int8), i8_ms))
    rec.update(int8_device_ms=t_int8, int8_bound_ms=i8_ms)
    return dict(name='flash_decode', route='cuda',
                source='chainermn_tpu_torch/csrc/flash_attention.cu',
                replaces='chainermn_tpu/ops/flash_attention.py:650',
                max_abs_err=max(errs), shape=[rows, k.shape[1], h, d],
                other_shapes={'serve lengths 65-96': serve},
                **rec), (lengths, serve_lengths)


def _paged_pool(gen, lengths, s, h, d, ps, dtype, n_pages=None):
    """A page pool ``(P, ps, H, D)`` with the rows' pages drawn in a
    shuffled order (so pages are not in position order), their tables
    with every dead entry set to a page id outside the pool, and the
    same tables with dead entries at page 0 (for gathering)."""
    import torch
    rows, n_max = lengths.numel(), -(-s // ps)
    n_pages = n_pages or 1 + rows * n_max
    perm = torch.randperm(n_pages - 1, generator=gen, device='cuda') + 1
    pages = perm[:rows * n_max].reshape(rows, n_max).to(torch.int32)
    live = (torch.arange(n_max, device='cuda')[None, :] * ps
            < lengths[:, None])
    tables = torch.where(live, pages, n_pages + 1000).to(torch.int32)
    safe = torch.where(live, pages, 0).to(torch.int32)
    k = torch.randn((n_pages, ps, h, d), generator=gen, device='cuda')
    v = torch.randn((n_pages, ps, h, d), generator=gen, device='cuda')
    return k.to(dtype), v.to(dtype), tables.contiguous(), safe


def _paged_decode_cases(gen, lengths_by_shape):
    """The paged decode kernel against its plain version, against itself
    (two runs) and against the slot decode kernel over the same cache
    gathered into a contiguous copy (bit-equal); timed at the serving
    shape with the slot decode row's live lengths, and with the serve
    profile's."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.precision import quantize_kv
    fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')
    bf16, f32 = torch.bfloat16, torch.float32
    # f32 sums in another order, 1e-5; bf16 out: BF16_TOL; int8 as in the
    # slot decode (the scale applied to p in the kernel, to v in the plain)
    tol = {f32: (1e-5, 1e-5), bf16: BF16_TOL}
    errs = []
    timed = {}
    serve_lengths, profile_lengths = lengths_by_shape
    ragged = lambda n, s: torch.randint(  # noqa: E731
        1, s + 1, (n,), generator=gen, device='cuda', dtype=torch.int32)
    split = lambda s: torch.tensor(  # noqa: E731
        _split_lengths(s), dtype=torch.int32, device='cuda')
    # the last three: lengths on both sides of the split boundaries, with
    # pages that do and do not divide the split
    cases = [(serve_lengths, 512, 8, 64, 16, bf16, 1 + 32 * 32),
             (serve_lengths, 512, 8, 64, 16, f32, None),
             (ragged(9, 512), 512, 4, 128, 8, f32, None),
             (ragged(7, 300), 300, 2, 32, 32, bf16, None),
             (ragged(5, 77), 77, 8, 64, 8, bf16, None),
             (torch.ones(3, dtype=torch.int32, device='cuda'), 16, 8, 64, 16,
              bf16, None),
             (split(512), 512, 8, 64, 16, bf16, None),
             (split(300), 300, 4, 128, 24, bf16, None),
             (split(400), 400, 2, 32, 5, f32, None)]
    for lengths, s, h, d, ps, dtype, n_pages in cases:
        lengths = lengths.clone()
        lengths[0] = 1                  # a pad row: one position of a page
        rows = lengths.numel()
        k, v, tables, safe = _paged_pool(gen, lengths, s, h, d, ps, dtype,
                                         n_pages)
        q, _, _ = _strided_qkv(gen, (rows,), h, d, dtype)
        for kind in ('float', 'int8'):
            scales = {}
            kk, vv = k, v
            if kind == 'int8':
                kk, ks = quantize_kv(k)
                vv, vs = quantize_kv(v)
                scales = dict(k_scale=ks, v_scale=vs)
            what = 'flash_decode_paged %s ps %d %s %s' % (
                (rows, s, h, d), ps, str(dtype).split('.')[-1], kind)
            got = ops.flash_decode_paged(q, kk, vv, tables, lengths,
                                         d ** -0.5, **scales)
            torch.cuda.synchronize()
            want = fa._decode_paged_plain(q, kk, vv, safe, lengths,
                                          d ** -0.5, scales.get('k_scale'),
                                          scales.get('v_scale'))
            check_close(what, got, want, *tol[dtype])
            errs.append(max_err(got, want))
            again = ops.flash_decode_paged(q, kk, vv, tables, lengths,
                                           d ** -0.5, **scales)
            if not torch.equal(again, got):
                raise AssertionError(what + ': two runs differ')
            gathered = {key: fa._gather_pages(val, safe)
                        for key, val in scales.items()}
            slot = ops.flash_decode(q, fa._gather_pages(kk, safe),
                                    fa._gather_pages(vv, safe), lengths,
                                    d ** -0.5, **gathered)
            if not torch.equal(slot, got):
                raise AssertionError(
                    what + ': not bit-equal to flash_decode over the '
                    'gathered cache (max diff %.3g)' % max_err(slot, got))
            if n_pages is not None:
                timed[kind] = (q, kk, vv, tables, safe, lengths, scales)
    q, k, v, tables, safe, lengths, _ = timed['float']
    rows, h, d = q.shape
    ps = k.shape[1]
    s = safe.shape[1] * ps

    def row(k, v, tables, safe, lengths):
        mask = (torch.arange(s, device='cuda')[None, :]
                < lengths[:, None])[:, None, None, :]

        def library():
            # the gather into the contiguous layout is part of the call
            kt = fa._gather_pages(k, safe).transpose(1, 2)
            vt = fa._gather_pages(v, safe).transpose(1, 2)
            return F.scaled_dot_product_attention(q[:, :, None], kt, vt,
                                                  attn_mask=mask)

        n_live_pages = int((-(-lengths // ps)).sum())
        # beside the slot kernel's bytes: the live table entries and the
        # lengths
        r = _decode_row(
            lambda: ops.flash_decode_paged(q, k, v, tables, lengths, 0.125),
            lambda: fa._decode_paged_plain(q, k, v, safe, lengths, 0.125),
            library, lengths, h, d, k.element_size(),
            extra=4 * n_live_pages + 4 * rows)
        r['live_pages'] = n_live_pages
        return r

    rec = row(k, v, tables, safe, lengths)
    # the serve profile's lengths (the slot row's), on a pool of the
    # same shape
    sl = profile_lengths
    serve = row(*_paged_pool(gen, sl, s, h, d, ps, k.dtype, k.shape[0]), sl)
    qi, ki, vi, ti, _, _, sc = timed['int8']
    t_int8 = device_ms(lambda: ops.flash_decode_paged(qi, ki, vi, ti,
                                                      lengths, 0.125, **sc))
    for what, r in (('uniform lengths', rec),
                    ('the serve profile\'s lengths 65-96', serve)):
        _say('kernels', 'flash_decode_paged 32 rows, pool %s, ps %d, %s, %d '
             'live positions on %d shuffled pages, bf16: %s (SDPA with a '
             'length mask, the gather of the pages included); bound %.5f ms '
             'by %s' % (tuple(k.shape), ps, what, r['live_positions'],
                        r['live_pages'], _fmt(r), r['bound_ms'],
                        r['bound_by']))
    _say('kernels', 'flash_decode_paged max err %.3g over %d cases (bf16 '
         'rtol, atol: %s); bit-equal to flash_decode over the gathered cache '
         'and between two runs in every case; int8 at uniform lengths: '
         'device only %s ms' % (max(errs), len(errs), BF16_TOL,
                                _ms(t_int8)))
    rec.update(int8_device_ms=t_int8)
    return dict(name='flash_decode_paged', route='cuda',
                source='chainermn_tpu_torch/csrc/flash_attention.cu',
                replaces='chainermn_tpu/ops/flash_attention.py:953',
                max_abs_err=max(errs), shape=[rows, s, h, d, ps],
                other_shapes={'serve lengths 65-96': serve}, **rec)


def phase_serving_kernels():
    """The serving paths' kernels against their plain versions on the
    card, at the shapes of the full-width TransformerLM."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(3)
    records = [_ln_cases(gen), _flash_cases(gen)]
    decode, lengths_by_shape = _decode_cases(gen)
    return records + [decode, _paged_decode_cases(gen, lengths_by_shape)]


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
_GROUPS = (('ported kernels', ('bn_reduce_kernel', 'apply_kernel',
                               'momentum_sgd')),
           ('convolutions', ('conv', 'cudnn', 'xmma', 'gemm', 'grad',
                             'fprop', 'implicit', 'cutlass')),
           ('nccl', ('nccl',)),
           ('copies and casts', ('memcpy', 'memset', 'copy')))


def _kernel_times(prof):
    """Device time (us) by kernel name from a ``torch.profiler`` run.
    User annotations (e.g. ``Optimizer.step``) span kernels already
    counted and are left out."""
    import torch
    kernels = {}
    for evt in prof.key_averages():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, 'is_user_annotation', False)
                and not evt.key.startswith('Optimizer.')):
            kernels[evt.key] = kernels.get(evt.key, 0.0) \
                + evt.self_device_time_total
    return kernels


def profiled(step, n):
    """``n`` calls of ``step`` under ``torch.profiler``: the run, its
    device time by kernel name and its wall time (us).  A trace without
    device events is taken again with ``n`` more calls; after
    ``PROFILE_TRIES`` empty traces the times come back empty and the
    caller reports the breakdown as not measured."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = _kernel_times(prof)
        if sum(kernels.values()) > 0:
            return prof, kernels, wall_us
        _say('profile', 'a trace held no device event')
    return prof, {}, wall_us


def _by_group(kernels, groups):
    """Sum ``kernels`` (name -> us) into the first group whose fragment
    the lowered name holds, else ``other PyTorch kernels``."""
    out = {}
    for key, us in kernels.items():
        low = key.lower()
        group = next((g for g, frags in groups
                      if any(f in low for f in frags)),
                     'other PyTorch kernels')
        out[group] = out.get(group, 0.0) + us
    return out


# kernel-name fragments of the BN kernels in a profile
_BN_KERNELS = (('bn_stats', ('StatsOp',)),
               ('bn_apply', (')::apply_kernel<',)),
               ('bn_backward', ('BwdSumOp', 'bn_bwd_apply_kernel')))


def bn_shapes(model):
    """Hooks on every ``NormAct`` of ``model`` that record, for each, the
    shape of its last call: ``(elements, channels, bytes an element,
    residual, relu)``.  Returns ``(shapes, remove)``: shapes by module
    name and a function that removes the hooks."""
    from chainermn_tpu_torch.models import NormAct
    shapes, handles = {}, []

    def watch(name):
        def hook(mod, args, kwargs):
            x = args[0]
            res = args[1] if len(args) > 1 else kwargs.get('residual')
            shapes[name] = (x.numel(), x.shape[-1], x.element_size(),
                            res is not None, mod.relu)
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, NormAct):
            handles.append(mod.register_forward_pre_hook(
                watch(name), with_kwargs=True))
    return shapes, lambda: [h.remove() for h in handles]


def bn_bounds(shapes):
    """The bound (ms) of each BN kernel over one step, from the shapes
    of :func:`bn_shapes` (each interlude once a step): each interlude's
    input read once and output written once, over the memory rate."""
    n_bytes = dict.fromkeys(('bn_stats', 'bn_apply', 'bn_backward'), 0)
    for n, c, size, res, relu in shapes.values():
        n_bytes['bn_stats'] += n * size + 3 * c * 4
        n_bytes['bn_apply'] += (2 + res) * n * size + 4 * c * 4
        n_bytes['bn_backward'] += (3 + relu + res) * n * size + 5 * c * 4
    return {k: v / HBM_BYTES_PER_S * 1e3 for k, v in n_bytes.items()}


def profile_steps(updater, n=3, groups=_GROUPS, model=None):
    """Device time by kernel group over ``n`` more steps of the main
    path (``torch.profiler``), and, given the ``model``, each BN kernel's
    device time a step against its bound a step (:func:`bn_bounds` of
    the shapes its interludes see in those steps); returns the device
    busy share of that window's wall time (None when no trace held a
    device event)."""
    import torch
    shapes, unhook = (bn_shapes(model) if model is not None
                      else ({}, lambda: None))
    try:
        prof, kernels, wall_us = profiled(updater.update, n)
    finally:
        unhook()
    bounds = bn_bounds(shapes) if shapes else None
    busy = sum(kernels.values())
    if busy == 0:
        _say('profile', 'no device event in %d traces: not measured'
             % PROFILE_TRIES)
        return None
    # the optimizer's step: its host span under the profiler, and the
    # device time of the SGD kernel by name (the tracer does not tie a
    # launch from the kernel libraries to the span that made it)
    sgd_us = sum(us for key, us in kernels.items() if 'momentum_sgd' in key)
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CPU
                and e.key.startswith('Optimizer.step#')):
            _say('profile', '  op %s: host %.3f ms/step under the profiler, '
                 '%d calls/step; momentum_sgd_kernel %.4f ms/step on the '
                 'device' % (e.key, e.cpu_time_total / n / 1e3,
                             e.count // n, sgd_us / n / 1e3))
    by_group = _by_group(kernels, groups)
    _say('profile', '%d steps: wall %.1f ms, device busy %.1f ms (%.1f%%, '
         'idle %.1f%%)' % (n, wall_us / 1e3, busy / 1e3,
                           100 * busy / wall_us, 100 - 100 * busy / wall_us))
    for group, us in sorted(by_group.items(), key=lambda kv: -kv[1]):
        _say('profile', '  %-16s %8.2f ms/step  %5.1f%% of device time'
             % (group, us / n / 1e3, 100 * us / busy))
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:12]:
        _say('profile', '  %8.2f ms/step  %s' % (us / n / 1e3, key[:90]))
    for name, frags in _BN_KERNELS if bounds else ():
        dev = sum(us for key, us in kernels.items()
                  if any(f in key for f in frags)) / n / 1e3
        _say('profile', '  %s: device %.3f ms/step, bound %.3f ms/step '
             '(%.0f%%), device - bound %.3f ms/step' % (
                 name, dev, bounds[name], 100 * bounds[name] / dev
                 if dev else 0.0, dev - bounds[name]))
    return busy / wall_us


def with_tc(what, counts, tc):
    """A main path's launch counts with each tensor-core route's count
    beside them (``<name>.tc``), after checking that every launch of a
    kernel with such a route took it: the main paths run bf16 only."""
    for name, n in tc.items():
        if n != counts[name]:
            raise AssertionError('%s: %d of %d %s launches took the '
                                 'tensor-core kernel' % (what, n,
                                                         counts[name], name))
    out = dict(counts)
    out.update(('%s.tc' % name, n) for name, n in tc.items())
    return out


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
        trainer = training.Trainer(updater, (STEPS, 'iteration'), out=None)
        marks, losses = [], []

        def record(tr):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            losses.append(tr.observation['loss'])

        trainer.extend(record, trigger=(1, 'iteration'))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        counts, tc = ops.launch_counts(), ops.tc_launch_counts()
        sgd_tensors = ops.momentum_sgd.tensors
        profile_steps(updater, model=model)
        _hold_main_path_interludes('main', 'ResNet-50', model, clf,
                                   updater.shard_batch(train[:BATCH]),
                                   BN_PER_STEP)
    finally:
        comm.close()
    # one SGD launch a step updates all 161 tensors
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(bn_stats=BN_PER_STEP * STEPS, bn_apply=BN_PER_STEP * STEPS,
                bn_backward=BN_PER_STEP * STEPS,
                momentum_sgd=STEPS - 1)
    if counts != want:
        raise AssertionError('launch counts %s, expected %s' % (counts,
                                                                want))
    if sgd_tensors != PARAMS_PER_STEP * (STEPS - 1):
        raise AssertionError('momentum_sgd updated %d tensors, expected %d'
                             % (sgd_tensors, PARAMS_PER_STEP * (STEPS - 1)))
    counts = with_tc('ResNet-50 training', counts, tc)
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
         '%d backward, 1 sgd for %d tensors after step 0)' % (
             counts, STEPS, BN_PER_STEP, BN_PER_STEP, BN_PER_STEP,
             PARAMS_PER_STEP))
    _say('main', 'step times ms %s; p50 of steps 2..%d %.2f ms = %.1f '
         'images/s at batch %d; peak memory %.2f GiB' % (
             ', '.join('%.1f' % (1e3 * s) for s in steps), STEPS - 1,
             1e3 * p50, BATCH / p50, BATCH,
             torch.cuda.max_memory_allocated() / 2 ** 30))
    return counts


# the communicator strategies, in the JAX package's table order
COMM_NAMES = ('xla', 'hierarchical', 'two_dimensional', 'flat', 'naive',
              'single_node', 'non_cuda_aware', 'dummy', 'bucketed')


def phase_communicators():
    """Every strategy on NCCL in a world of one: ``allreduce_grad`` of
    ResNet-50's 161 gradient tensors gives them back bit for bit (the
    mean over one), and with ``reduce_dtype=bfloat16`` their bf16 round
    trip; its time a call is the strategy's packing cost (no wire in a
    world of one).  Then a bounded barrier and an object sent to this
    rank and received back."""
    import numpy as np
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models
    model = models.ResNet50()
    torch.manual_seed(0)
    grads = [torch.randn_like(p) for p in model.parameters()]
    del model
    if len(grads) != PARAMS_PER_STEP:
        raise AssertionError('%d gradient tensors' % len(grads))
    times = {}
    for name in COMM_NAMES:
        for reduce_dtype in (None, torch.bfloat16):
            comm = cmt.create_communicator(name, reduce_dtype=reduce_dtype)
            try:
                work = [g.clone() for g in grads]
                comm.allreduce_grad(work)
                torch.cuda.synchronize()
                for i, (got, g) in enumerate(zip(work, grads)):
                    want = g if reduce_dtype is None else \
                        g.to(reduce_dtype).to(g.dtype)
                    if not torch.equal(got, want):
                        raise AssertionError(
                            '%s (reduce_dtype %s): tensor %d is not its '
                            'input: max abs err %.3g' % (
                                name, reduce_dtype, i, max_err(got, want)))
                times[name, reduce_dtype] = time_ms(
                    lambda: comm.allreduce_grad(work), iters=10, warmup=2)
                if name == 'hierarchical' and reduce_dtype is None:
                    comm.barrier(timeout=5)
                    obj = {'step': 3, 'x': np.arange(4.0)}
                    comm.send_obj(obj, dest=comm.rank, tag='self')
                    back = comm.recv_obj(comm.rank, tag='self', timeout=5)
                    if back['step'] != 3 or back['x'].tolist() != [
                            0.0, 1.0, 2.0, 3.0]:
                        raise AssertionError('send_obj / recv_obj: %r'
                                             % (back,))
            finally:
                comm.close()
    _say('comm', '%d strategies, NCCL, a world of one: allreduce_grad of '
         "ResNet-50's %d gradient tensors bit-equal to the input (f32) "
         'and to its bf16 round trip (reduce_dtype bf16); barrier(5 s) '
         'returned; send_obj / recv_obj to this rank round-tripped'
         % (len(COMM_NAMES), PARAMS_PER_STEP))
    for name in COMM_NAMES:
        _say('comm', '  %-16s %8.3f ms a call f32, %8.3f ms bf16 (packing '
             'cost in a world of one, not wire time)'
             % (name, times[name, None], times[name, torch.bfloat16]))


# the ImageNet example's run (examples/imagenet: the synthetic 1280 / 128
# set, insize 224, hierarchical), one epoch at a global batch of 64
IMAGENET_ARGV = ['--communicator', 'hierarchical', '--arch', 'resnet50',
                 '--batchsize', '64', '--epoch', '1']
IMAGENET_BATCH = 64


def _imagenet_example(out, argv=IMAGENET_ARGV):
    """``train_imagenet.main(argv)`` with each update timed
    (synchronized before and after, its loss kept) and the prefetcher's
    host batches checked for pinned memory; returns ``(trainer, update
    ms, losses, pinned flags, window s)``."""
    import torch
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.examples.imagenet import train_imagenet
    update = training.StandardUpdater.update
    collate = training.StandardUpdater.collate_pinned
    update_ms, losses, pinned, starts = [], [], [], []

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        starts.append(t0)
        result = update(self)
        torch.cuda.synchronize()
        update_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(result['loss'])
        return result

    def checked(self, batch):
        host = collate(self, batch)
        pinned.append(all(t.is_pinned() for t in host))
        return host

    training.StandardUpdater.update = timed
    training.StandardUpdater.collate_pinned = checked
    try:
        trainer = train_imagenet.main(argv + ['--out', out])
        torch.cuda.synchronize()
        window_s = time.perf_counter() - starts[0]
    finally:
        training.StandardUpdater.update = update
        training.StandardUpdater.collate_pinned = collate
    return trainer, update_ms, losses, pinned, window_s


def phase_imagenet():
    import shutil
    import tempfile
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.examples.imagenet import train_imagenet
    out = tempfile.mkdtemp(prefix='imagenet_example_')
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        trainer, update_ms, losses, pinned, window_s = _imagenet_example(out)
        counts = ops.launch_counts()
        sgd_tensors = ops.momentum_sgd.tensors
        peak = torch.cuda.max_memory_allocated()
        iterations = trainer.updater.iteration   # before the profiling
        obs = dict(trainer.observation)
        try:
            busy = profile_steps(trainer.updater)
        finally:
            train_imagenet.close(trainer)
        snapshots = sorted(n for n in os.listdir(out)
                           if n.startswith('snapshot_iter_'))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(momentum_sgd=iterations - 1)   # the first call broadcasts
    if counts != want:
        raise AssertionError('ImageNet example: launch counts %s, expected '
                             '%s' % (counts, want))
    if sgd_tensors != PARAMS_PER_STEP * (iterations - 1):
        raise AssertionError('momentum_sgd updated %d tensors, expected %d'
                             % (sgd_tensors,
                                PARAMS_PER_STEP * (iterations - 1)))
    if len(losses) != iterations or not all(math.isfinite(v)
                                            for v in losses):
        raise AssertionError('ImageNet example: losses %s' % losses)
    acc = obs.get('validation/main/accuracy')
    if acc is None or not 0.0 <= acc <= 1.0:
        raise AssertionError('ImageNet example: validation accuracy %r'
                             % acc)
    if snapshots != ['snapshot_iter_%d.npz' % iterations]:
        raise AssertionError('ImageNet example: snapshots %s' % snapshots)
    if not pinned or not all(pinned):
        raise AssertionError('ImageNet example: %d of %d prefetched batches '
                             'pinned' % (sum(pinned), len(pinned)))
    timed = sorted(update_ms[2:])   # after the broadcast call and a step
    p50 = timed[len(timed) // 2]
    p99 = timed[min(len(timed) - 1, int(math.ceil(0.99 * len(timed))) - 1)]
    _say('imagenet', 'example (ResNet-50, hierarchical on NCCL, insize 224, '
         'bf16, the synthetic 1280 / 128 set, global batch %d, 1 epoch, '
         'device_prefetch 2): %d iterations, %d momentum_sgd launches and '
         'no other kernel; %.1f train images/s from the p50 of the '
         'synchronized update() calls, %.3f ms (p99 %.3f ms, %d updates '
         'after 2 warm-up); %.1f images/s over the whole window (%d images '
         'in %.3f s from the first update to the end of the run, '
         'evaluation and snapshot included); device busy %s over 3 '
         'profiled steps; peak memory %.2f GiB; loss %.4f -> %.4f; '
         'validation accuracy %.4f; %d of %d prefetched batches pinned' % (
             IMAGENET_BATCH, iterations, counts['momentum_sgd'],
             IMAGENET_BATCH / (p50 / 1e3), p50, p99, len(timed),
             IMAGENET_BATCH * iterations / window_s,
             IMAGENET_BATCH * iterations, window_s,
             'not measured' if busy is None else '%.1f%%' % (100 * busy),
             peak / 2 ** 30, losses[0], losses[-1], acc, sum(pinned),
             len(pinned)))
    return counts


# the MNIST gate's configuration (tests/test_mnist.py, the reference's CI
# gate): MLP(100), momentum SGD 0.1 / 0.9, the hard stand-in, a global
# batch of 104, 5 epochs
MNIST_UNITS = 100
MNIST_BATCH = 104
MNIST_EPOCHS = 5
MNIST_PARAMS = 6               # the MLP's parameter tensors
MNIST_CHECK_ITER = 5           # the card run is held to the CPU run here
# kernel-name fragments of the MNIST example's profile breakdown
_MNIST_GROUPS = (('matmuls', ('gemm', 'cutlass', 'xmma', 'sm90')),
                 ('adam', ('adam',)),
                 ('nccl', ('nccl',)),
                 ('copies and casts', ('memcpy', 'memset', 'copy')))


def _sgd_state(updater):
    """The model's parameters and ``FusedMomentumSGD``'s velocities, in
    parameter order, copied to the host."""
    opt = updater.optimizer.actual_optimizer
    params = list(updater.model.parameters())
    return [t.detach().cpu().clone() for t in params + [
        opt.state[p]['velocity'] for p in params]]


def _mnist_gate(device, stop, losses, states):
    """The gate's trainer on ``device`` with the 'xla' communicator (a
    world of one), stopped at ``stop``; each step's loss goes to
    ``losses``, and the parameters and velocities after iteration
    ``MNIST_CHECK_ITER`` go to ``states``.  Returns ``(trainer, log)``."""
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, ops, training
    from chainermn_tpu_torch.datasets import mnist
    comm = cmt.create_communicator('xla', device=device)
    model = models.MLP(n_units=MNIST_UNITS, device=comm.device)
    clf = models.Classifier(model)
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
    train, test = mnist.get_mnist(variant='hard')
    updater = training.StandardUpdater(
        training.SerialIterator(train, MNIST_BATCH), opt, clf, model, comm)
    trainer = training.Trainer(updater, stop, out=None)
    trainer.extend(cmt.create_multi_node_evaluator(training.Evaluator(
        training.SerialIterator(test, MNIST_BATCH, repeat=False,
                                shuffle=False), clf.eval_metrics, comm),
        comm))
    log = training.extensions.LogReport()
    trainer.extend(log)
    trainer.extend(lambda tr: losses.append(tr.observation['loss']),
                   trigger=(1, 'iteration'))
    def capture(tr):
        if tr.updater.iteration == MNIST_CHECK_ITER:
            states.extend(_sgd_state(tr.updater))

    trainer.extend(capture, trigger=(1, 'iteration'))
    return trainer, log


def _mnist_example(out):
    """``train_mnist.main`` at full width on the card, each update timed
    (synchronized before and after) and each evaluation timed; returns
    ``(trainer, update ms, evaluation ms, window s)``, the window running
    from the first update's start to the end of the run, extensions
    included."""
    import torch
    from chainermn_tpu_torch import training
    from chainermn_tpu_torch.examples.mnist import train_mnist
    update, evaluate = training.StandardUpdater.update, \
        training.Evaluator.evaluate
    update_ms, eval_ms, starts = [], [], []

    def timed(fn, into):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            starts.append(t0)
            result = fn(*args, **kw)
            torch.cuda.synchronize()
            into.append(1e3 * (time.perf_counter() - t0))
            return result
        return call

    training.StandardUpdater.update = timed(update, update_ms)
    training.Evaluator.evaluate = timed(evaluate, eval_ms)
    try:
        trainer = train_mnist.main(['--unit', '1000', '--epoch', '2',
                                    '--out', out])
        torch.cuda.synchronize()
        window_s = time.perf_counter() - starts[0]
    finally:
        training.StandardUpdater.update = update
        training.Evaluator.evaluate = evaluate
    return trainer, update_ms, eval_ms, window_s


def phase_mnist():
    import shutil
    import tempfile
    import torch
    from chainermn_tpu_torch import ops
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('expected full-f32 matmuls (allow_tf32 False)')
    # 1. the gate: first the same configuration on the CPU (gloo), five
    # iterations, then the whole run on the card (NCCL)
    cpu_losses, losses, cpu_states, states = [], [], [], []
    trainer, _ = _mnist_gate('cpu', (MNIST_CHECK_ITER, 'iteration'),
                             cpu_losses, cpu_states)
    trainer.run()
    trainer.updater.comm.close()
    trainer, log = _mnist_gate(None, (MNIST_EPOCHS, 'epoch'), losses, states)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        trainer.run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        sgd_tensors = ops.momentum_sgd.tensors
    finally:
        trainer.updater.comm.close()
    gate_s = time.perf_counter() - t0
    iterations = trainer.updater.iteration
    acc = trainer.observation['validation/main/accuracy']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(momentum_sgd=iterations - 1)   # the first call broadcasts
    if counts != want:
        raise AssertionError('MNIST gate: launch counts %s, expected %s'
                             % (counts, want))
    if sgd_tensors != MNIST_PARAMS * (iterations - 1):
        raise AssertionError('momentum_sgd updated %d tensors, expected %d'
                             % (sgd_tensors, MNIST_PARAMS * (iterations - 1)))
    if trainer.updater.epoch != MNIST_EPOCHS or len(log.log) != MNIST_EPOCHS:
        raise AssertionError('MNIST gate: %d epochs, %d log entries'
                             % (trainer.updater.epoch, len(log.log)))
    for i, (a, b) in enumerate(zip(losses, cpu_losses)):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError('MNIST gate: loss %d card %r vs CPU %r'
                                 % (i, a, b))
    if len(cpu_losses) != MNIST_CHECK_ITER:
        raise AssertionError('MNIST gate: %d CPU steps' % len(cpu_losses))
    # after the broadcast call and 4 steps, every parameter and velocity
    # of the card run against the CPU run's (the f32 parity tolerance):
    # the momentum_sgd kernel at the MLP's six shapes, on the path
    if len(states) != len(cpu_states) or len(states) != 2 * MNIST_PARAMS:
        raise AssertionError('MNIST gate: %d card, %d CPU state tensors'
                             % (len(states), len(cpu_states)))
    names = ['param %d' % i for i in range(MNIST_PARAMS)] + [
        'velocity %d' % i for i in range(MNIST_PARAMS)]
    for name, a, b in zip(names, states, cpu_states):
        check_close('MNIST gate %s at iteration %d' % (name,
                                                       MNIST_CHECK_ITER),
                    a, b, 1e-5, 1e-6)
    state_err = max(max_err(a, b) for a, b in zip(states, cpu_states))
    if acc < 0.95:
        raise AssertionError('MNIST gate: validation accuracy %.4f < 0.95'
                             % acc)
    _say('mnist', 'gate (MLP(%d), FusedMomentumSGD(0.1, 0.9), hard stand-in, '
         'batch %d, %d epochs, xla on NCCL): validation accuracy %.4f, %d '
         'iterations, %.1f s; first losses card %s, CPU %s; parameters '
         'and velocities after iteration %d: max abs err %.3g; launches %s'
         % (MNIST_UNITS, MNIST_BATCH, MNIST_EPOCHS, acc, iterations, gate_s,
            ', '.join('%.6f' % v for v in losses[:5]),
            ', '.join('%.6f' % v for v in cpu_losses), MNIST_CHECK_ITER,
            state_err, counts))
    # 2. the example at full width: Adam, the classic stand-in, batch 100
    out = tempfile.mkdtemp(prefix='mnist_example_')
    try:
        ops.reset_launch_counts()
        trainer, update_ms, eval_ms, window_s = _mnist_example(out)
        example_counts = ops.launch_counts()
        example_iters = trainer.updater.iteration   # before the profiling
        try:
            busy = profile_steps(trainer.updater, groups=_MNIST_GROUPS)
        finally:
            trainer.updater.comm.close()
        with open(os.path.join(out, 'log')) as f:
            entries = json.load(f)
        snapshots = sorted(n for n in os.listdir(out)
                           if n.startswith('snapshot_iter_'))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if any(example_counts.values()):
        # Adam, dense products and F.cross_entropy: no port kernel
        raise AssertionError('MNIST example launched %s' % example_counts)
    if [e['epoch'] for e in entries] != [1, 2] or snapshots != [
            'snapshot_iter_120.npz', 'snapshot_iter_60.npz']:
        raise AssertionError('MNIST example: log %s, snapshots %s'
                             % (entries, snapshots))
    if not entries[1]['loss'] < entries[0]['loss']:
        raise AssertionError('MNIST example: the loss did not fall: %s'
                             % entries)
    timed = sorted(update_ms[2:])   # after the broadcast call and a step
    p50 = timed[len(timed) // 2]
    p99 = timed[min(len(timed) - 1, int(math.ceil(0.99 * len(timed))) - 1)]
    _say('mnist', 'example (MLP(1000), Adam 1e-3, classic stand-in, batch '
         '100, 2 epochs): %.1f train images/s from the p50 of the '
         'synchronized update() calls, %.3f ms (p99 %.3f ms, %d updates '
         'after 2 warm-up); %.1f images/s over the whole window (%d '
         'images in %.3f s from the first update to the end of the run, '
         'extensions and evaluation included); evaluator %s ms an '
         'epoch; device busy %s over 3 profiled steps; loss %.4f -> %.4f; '
         'final validation accuracy %.4f' % (
             100 / (p50 / 1e3), p50, p99, len(timed),
             100 * example_iters / window_s, 100 * example_iters, window_s,
             ', '.join('%.2f' % t for t in eval_ms),
             'not measured' if busy is None else '%.1f%%' % (100 * busy),
             entries[0]['loss'], entries[1]['loss'],
             entries[1]['validation/main/accuracy']))
    return counts


# the conv zoo's main path: GoogLeNet-BN with the fused BN kernels at full
# width, then the ImageNet twin over the other BASELINE.json models
ZOO_STEPS = 6
SGD_TABLE = 200                # tensors a momentum_sgd launch takes
                               # (kMaxTensors, csrc/momentum_sgd.cu)
ZOO_CHECK_BATCH = 4            # the fused / unfused check on the card, f32
# (arch, quick): vgg16 and googlenetbn at their insize (224), the others
# at the JAX script's --quick size (64; 96 for alex and nin)
ZOO_TWINS = (('vgg16', False), ('googlenetbn', False), ('alex', True),
             ('nin', True), ('googlenet', True))


def _capture_interludes(model):
    """Hooks on every ``NormAct`` of ``model``: a train-mode forward
    records each interlude's input and residual (None without one), and
    the backward after it the gradient of its output.  Returns
    ``(records, remove)``: records by module name (``{'x': ..., 'res':
    ..., 'g': ...}``) and a function that removes the hooks."""
    from chainermn_tpu_torch.models import NormAct
    records, handles = {}, []

    def pre(name):
        def hook(mod, args, kwargs):
            res = args[1] if len(args) > 1 else kwargs.get('residual')
            records[name] = {'x': args[0].detach(), 'res': None if res is
                             None else res.detach()}
        return hook

    def post(name):
        def hook(mod, args, out):
            out.register_hook(
                lambda g: records[name].__setitem__('g', g.detach()))
        return hook

    for name, mod in model.named_modules():
        if isinstance(mod, NormAct):
            handles.append(mod.register_forward_pre_hook(
                pre(name), with_kwargs=True))
            handles.append(mod.register_forward_hook(post(name)))
    return records, lambda: [h.remove() for h in handles]


def _rel_l2(a, b):
    return float((a.double() - b.double()).norm()
                 / (b.double().norm() + 1e-30))


def _units(got, want, rtol, atol):
    """The largest ``|got - want| / (atol + rtol |want|)``: at most 1 is
    within the tolerance."""
    want = want.double()
    return float(((got.double() - want).abs()
                  / (atol + rtol * want.abs())).max())


def _interlude_readings(mod, x, g, res=None):
    """One BN interlude on its real input ``x``, residual ``res`` and
    output gradient ``g`` through three routes: the fused op (the BN
    kernels, ``bn_backward`` included), the flax oracle in ``x.dtype``
    (``fused_norm=False``: plain PyTorch, autograd; with a residual, the
    fused op's plain version, which adds it before rounding) and the
    oracle in float64 (the truth).

    The forward runs as the layer does (with its relu): the fused output
    and statistics against the oracle's, in units of ``BF16_TOL`` and
    ``STATS_TOL``.  The backward runs without the relu on ``g`` masked by
    the truth's relu: the relu's gradient is a step, and an output within
    rounding of zero on the other side (a relu flip; the forward's
    tolerance covers it) would move one element's gradient from ``g`` to
    0.  Each route's dx, dscale and dbias (and the residual's gradient,
    ``dres``) against the truth, and the fused ones against the
    oracle's, as relative L2 errors."""
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.models._norm import _flax_batch_norm
    eps = mod.epsilon
    if res is None:
        def oracle(a, s, b, r, relu):
            return _flax_batch_norm(a, s, b, eps, r, relu)
    else:
        # flax rounds the normalized value to x.dtype and then adds the
        # residual; the fused op, as the reference's, adds it in f32 and
        # rounds once (in bf16 the two differ where the sum cancels).
        # With a residual the oracle is the fused op's plain version
        def oracle(a, s, b, r, relu):
            return ops.batch_norm_act_reference(a, s, b, eps, residual=r,
                                                relu=relu)
    routes = {
        'fused': (lambda a, s, b, r, relu: ops.batch_norm_act(
            a, s, b, eps, residual=r, relu=relu), x.dtype),
        'oracle': (oracle, x.dtype),
        'truth': (oracle, torch.float64)}
    fwd, bwd = {}, {}
    with torch.no_grad():
        for route, (fn, dtype) in routes.items():
            out, mean, var = fn(x.to(dtype), mod.scale, mod.bias,
                                None if res is None else res.to(dtype),
                                mod.relu)
            fwd[route] = dict(out=out, mean=mean, var=var)
    gm = g * (fwd['truth']['out'] > 0) if mod.relu else g
    for route, (fn, dtype) in routes.items():
        xin = x.to(dtype).detach().requires_grad_(True)
        rin = None if res is None else \
            res.to(dtype).detach().requires_grad_(True)
        scale = mod.scale.detach().clone().requires_grad_(True)
        bias = mod.bias.detach().clone().requires_grad_(True)
        out, _, _ = fn(xin, scale, bias, rin, False)
        out.backward(gm.to(out.dtype))
        bwd[route] = dict(dx=xin.grad, dscale=scale.grad, dbias=bias.grad)
        if rin is not None:
            bwd[route]['dres'] = rin.grad
    f, o, t = fwd['fused'], fwd['oracle'], fwd['truth']
    rstd_t = torch.rsqrt(t['var'] + eps)
    xd = x.double().reshape(-1, x.shape[-1])
    grads = ('dx', 'dscale', 'dbias') + (() if res is None else ('dres',))
    return dict(
        shape=(xd.shape[0], xd.shape[1]),
        out_units=_units(f['out'], o['out'], *BF16_TOL),
        stats_units=max(_units(f[k], o[k], *STATS_TOL)
                        for k in ('mean', 'var')),
        # how ill-conditioned the fast variance E[x^2] - E[x]^2 is: the
        # largest E[x^2] / (var + eps) over channels
        cond=float(((xd * xd).mean(0) / (t['var'] + eps)).max()),
        # outputs on the other side of the relu from the truth's
        flips={r: int(((fwd[r]['out'] > 0) != (t['out'] > 0)).sum())
               for r in ('fused', 'oracle')},
        rstd={r: float(((torch.rsqrt(fwd[r]['var'].double() + eps) - rstd_t)
                        .abs() / rstd_t).max()) for r in ('fused', 'oracle')},
        truth={r: {k: _rel_l2(bwd[r][k], bwd['truth'][k]) for k in grads}
               for r in ('fused', 'oracle')},
        vs_oracle={k: _rel_l2(bwd['fused'][k], bwd['oracle'][k])
                   for k in grads})


def _interlude_report(model, records):
    """:func:`_interlude_readings` for every interlude ``records`` holds
    (taking each record out as it goes), in forward order."""
    rows = []
    mods = dict(model.named_modules())
    for name in list(records):
        rec = records.pop(name)
        rows.append(dict(_interlude_readings(mods[name], rec['x'],
                                             rec['g'], rec['res']),
                         name=name))
    return rows


def _say_interludes(phase, what, rows, n=8):
    """Log the ``n`` interludes whose fused dx is furthest from the
    oracle's."""
    for r in sorted(rows, key=lambda r: -r['vs_oracle']['dx'])[:n]:
        f, o, v = r['truth']['fused'], r['truth']['oracle'], r['vs_oracle']
        _say(phase, '%s %s %s: cond %.3g; out %.3g of BF16_TOL, stats %.3g '
             'of STATS_TOL; against f64, fused / oracle: rstd %.3g / %.3g, '
             'relu flips %d / %d, dx %.3g / %.3g, dscale %.3g / %.3g, dbias '
             '%.3g / %.3g; fused against oracle: dx %.3g, dscale %.3g, dbias '
             '%.3g' % (what, r['name'], r['shape'], r['cond'],
                       r['out_units'], r['stats_units'], r['rstd']['fused'],
                       r['rstd']['oracle'], r['flips']['fused'],
                       r['flips']['oracle'], f['dx'], o['dx'], f['dscale'],
                       o['dscale'], f['dbias'], o['dbias'], v['dx'],
                       v['dscale'], v['dbias']))


def _say_worst(phase, what, rows):
    """Log the worst of each reading over ``rows``."""
    with_res = [r for r in rows if 'dres' in r['vs_oracle']]
    if with_res:
        _say(phase, '%s, %d interludes with a residual at worst: its '
             'gradient fused against oracle %.3g; against f64, fused / '
             'oracle %.3g / %.3g' % (
                 what, len(with_res), _worst(with_res, 'vs_oracle', 'dres'),
                 _worst(with_res, 'truth', 'fused', 'dres'),
                 _worst(with_res, 'truth', 'oracle', 'dres')))
    _say(phase, '%s, %d interludes at worst: out %.3g of BF16_TOL, stats '
         '%.3g of STATS_TOL, cond %.3g, relu flips fused / oracle %d / %d; '
         'fused against oracle: dx %.3g, dscale %.3g, dbias %.3g; against '
         'f64, fused / oracle: rstd %.3g / %.3g, dx %.3g / %.3g, dscale '
         '%.3g / %.3g, dbias %.3g / %.3g' % (
             what, len(rows), _worst(rows, 'out_units'),
             _worst(rows, 'stats_units'), _worst(rows, 'cond'),
             _worst(rows, 'flips', 'fused'), _worst(rows, 'flips', 'oracle'),
             *(_worst(rows, 'vs_oracle', k) for k in ('dx', 'dscale',
                                                      'dbias')),
             _worst(rows, 'rstd', 'fused'), _worst(rows, 'rstd', 'oracle'),
             *(_worst(rows, 'truth', r, k) for k in ('dx', 'dscale', 'dbias')
               for r in ('fused', 'oracle'))))


# an interlude's dscale and dbias (f32 sums over its rows) against the
# oracle's, relative L2: the gradient tolerance of the parity tests
GRAD_TOL = 1e-4


def _hold_interludes(what, rows, dtype):
    """Fail unless every interlude's fused forward and backward agree
    with the oracle's: the output within ``BF16_TOL``, the statistics
    within ``STATS_TOL``, dscale and dbias within ``GRAD_TOL`` and dx
    within ``GRAD_TOL`` in f32 or, in bf16 (both round once to bf16),
    within ``BF16_TOL``'s rtol, and so the residual's gradient."""
    import torch
    dx_tol = BF16_TOL[0] if dtype == torch.bfloat16 else GRAD_TOL
    for r in rows:
        v = r['vs_oracle']
        bad = [k for k, got, tol in (
            ('out', r['out_units'], 1.0), ('stats', r['stats_units'], 1.0),
            ('dx', v['dx'], dx_tol), ('dscale', v['dscale'], GRAD_TOL),
            ('dbias', v['dbias'], GRAD_TOL),
            ('dres', v.get('dres', 0.0), dx_tol)) if not got <= tol]
        if bad:
            raise AssertionError('%s interlude %s %s: fused against the '
                                 'oracle beyond its tolerance in %s: %s'
                                 % (what, r['name'], r['shape'], bad, r))


def _worst(rows, *keys):
    """The largest reading under ``keys`` over ``rows``."""
    def get(r):
        for k in keys:
            r = r[k]
        return r
    return max(get(r) for r in rows)


def _zoo_fused_check():
    """GoogLeNet-BN ``fused_norm=True`` (the BN kernels) against
    ``fused_norm=False`` (plain PyTorch BatchNorm) on the card, f32 with
    TF32 off, from the same seed and batch: train-mode logits, loss and
    running averages against each other; every interlude of the fused
    model on its own input and output gradient against the oracle
    (:func:`_interlude_readings`); every gradient against the float64
    model on the CPU, beside the errors of ``fused_norm=False`` on the
    card and on the CPU (f32 under two other summation orders)."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import models
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    what = 'f32 batch %d' % ZOO_CHECK_BATCH
    try:
        gen = torch.Generator().manual_seed(4)
        x = torch.randn((ZOO_CHECK_BATCH, 224, 224, 3), generator=gen)
        y = torch.randint(0, 1000, (ZOO_CHECK_BATCH,), generator=gen)
        outs = {}
        for name, fused, dev, dtype in (
                ('fused', True, 'cuda', torch.float32),
                ('unfused', False, 'cuda', torch.float32),
                ('unfused_cpu', False, 'cpu', torch.float32),
                ('f64', False, 'cpu', torch.float64)):
            model = models.GoogLeNetBN(
                dtype=dtype, fused_norm=fused, device=dev,
                generator=torch.Generator().manual_seed(5)).to(dtype)
            model.train()
            if fused:
                records, unhook = _capture_interludes(model)
            logits = model(x.to(dev, dtype))
            loss = F.cross_entropy(logits, y.to(dev))
            loss.backward()
            if fused:
                unhook()
                interludes = _interlude_report(model, records)
            outs[name] = (logits.detach().cpu().double(),
                          loss.detach().cpu().double(),
                          models.to_flax_variables(model)['batch_stats'],
                          {k: p.grad.detach().cpu().double()
                           for k, p in model.named_parameters()})
            del model
    finally:
        torch.backends.cudnn.allow_tf32 = True
    _say_interludes('zoo', what, interludes, n=4)
    _say_worst('zoo', what, interludes)
    _hold_interludes('GoogLeNet-BN ' + what, interludes, torch.float32)
    (fl, floss, fstats, fgrads), (ul, uloss, ustats, ugrads) = \
        outs['fused'], outs['unfused']
    tloss, tgrads = outs['f64'][1], outs['f64'][3]
    # the two differ in the statistics' summation order and the
    # backward's op order (about 1e-6 relative), renormalized 68 times
    tol = 1e-3
    check_close('GoogLeNet-BN fused vs unfused logits', fl, ul, tol, tol)
    check_close('GoogLeNet-BN fused vs unfused loss', floss, uloss, tol, tol)
    want_stats = dict(_flat(ustats))
    for key, leaf in _flat(fstats):
        check_close('GoogLeNet-BN running stats ' + key,
                    torch.from_numpy(leaf), torch.from_numpy(want_stats[key]),
                    tol, tol)
    # gradients against the f64 model.  In f32 the whole model's
    # gradient is not a smooth function of the rounding: a max pool
    # routes a near-tie's gradient to another element and a relu output
    # within rounding of zero flips, and each moves a whole element's
    # gradient, so one tensor's error moves by orders of magnitude with
    # the forward's rounding (InceptionBN_9.Conv_1.weight: 4.34e-05
    # unfused on an H100, 4.11e-04 unfused on the CPU).  The fused path
    # is held to f32 under the two other summation orders:
    # each tensor, and the worst, within twice the larger of the two
    # unfused errors
    others = (('unfused', ugrads), ('unfused_cpu', outs['unfused_cpu'][3]))
    errs = {}
    for key, truth in tgrads.items():
        norm = float(truth.norm()) or 1.0
        errs[key] = {name: float((grads[key] - truth).norm()) / norm
                     for name, grads in (('fused', fgrads),) + others}
    worst = {name: max(e[name] for e in errs.values())
             for name in ('fused', 'unfused', 'unfused_cpu')}

    def limit(e):
        return 2 * max(e['unfused'], e['unfused_cpu'])

    for key in sorted(errs, key=lambda k: -errs[k]['fused']
                      / max(limit(errs[k]), 1e-30))[:4]:
        _say('zoo', '%s gradient %s: relative L2 error against f64 %.3g '
             'fused, %.3g unfused, %.3g unfused on the CPU' % (
                 what, key, errs[key]['fused'], errs[key]['unfused'],
                 errs[key]['unfused_cpu']))
    for key, e in errs.items():
        if e['fused'] > limit(e):
            raise AssertionError(
                'GoogLeNet-BN gradient %s: relative L2 error against f64 '
                '%.3g fused, %.3g unfused, %.3g unfused on the CPU'
                % (key, e['fused'], e['unfused'], e['unfused_cpu']))
    if worst['fused'] > limit(worst):
        raise AssertionError('GoogLeNet-BN gradients: worst relative L2 '
                             'error against f64 %.3g fused, %.3g unfused, '
                             '%.3g unfused on the CPU' % (
                                 worst['fused'], worst['unfused'],
                                 worst['unfused_cpu']))
    _say('zoo', 'GoogLeNet-BN %s, fused_norm True vs False on the card: '
         'logits err %.3g, loss %.6f vs %.6f (f64 on the CPU %.6f); %d '
         'gradient tensors, worst relative L2 error against the f64 model '
         '%.3g fused, %.3g unfused, %.3g unfused on the CPU (bound: each '
         'tensor and the worst within twice the larger unfused error)' % (
             what, max_err(fl, ul), float(floss), float(uloss), float(tloss),
             len(fgrads), worst['fused'], worst['unfused'],
             worst['unfused_cpu']))


def _hold_main_path_interludes(phase, name, model, clf, batch, n_norms):
    """One more train-mode forward and backward of a main path's model
    (bf16, batch 64) records every interlude's input, residual and
    output gradient, and each is held against the flax oracle
    (``fused_norm=False``'s BatchNorm) on the same tensors
    (:func:`_hold_interludes`); returns the loss, with the gradients
    left in the model."""
    import torch
    model.zero_grad(set_to_none=True)
    records, unhook = _capture_interludes(model)
    try:
        loss, _ = clf.loss(*batch)
        loss.backward()
    finally:
        unhook()
    rows = _interlude_report(model, records)
    if len(rows) != n_norms:
        raise AssertionError('%s: %d of %d interludes recorded'
                             % (name, len(rows), n_norms))
    what = '%s bf16 batch %d' % (name, BATCH)
    _say_interludes(phase, what, rows, n=4)
    _say_worst(phase, what, rows)
    _hold_interludes(what, rows, torch.bfloat16)
    return loss


def _zoo_interlude_check(model, clf, batch):
    """GoogLeNet-BN's main path, interlude by interlude
    (:func:`_hold_main_path_interludes`); then the whole model against unfused
    copies with the same weights on the same batch: the loss against the
    bf16 copy's, the gradients' distance from the f32 copy's against the
    bf16 copy's distance."""
    import torch
    from chainermn_tpu_torch import models
    loss = _hold_main_path_interludes('zoo', 'GoogLeNet-BN', model, clf,
                                      batch, model.n_norms)
    fused_grads = {k: p.grad.detach().clone()
                   for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    # the whole model: the fused and the unfused bf16 models against an
    # unfused f32 model (TF32 off), all with the same weights on the same
    # batch.  bf16 gradients are far from f32 ones (a BatchNorm bias
    # gradient is a sum that cancels, over inputs rounded to bf16), so
    # the fused model is held to the unfused one's distance
    grads, losses = {'fused': fused_grads}, {'fused': float(loss.detach())}
    torch.backends.cudnn.allow_tf32 = False
    try:
        for name, dtype in (('unfused', torch.bfloat16),
                            ('f32', torch.float32)):
            other = models.GoogLeNetBN(fused_norm=False, dtype=dtype)
            other.load_state_dict(model.state_dict())
            oloss, _ = models.StatefulClassifier(other).loss(*batch)
            oloss.backward()
            losses[name] = float(oloss.detach())
            grads[name] = {k: p.grad for k, p in other.named_parameters()}
            del other
    finally:
        torch.backends.cudnn.allow_tf32 = True
    dist = {}
    for name in ('fused', 'unfused'):
        diff = sum(float((grads[name][k].double() - g.double()).norm()) ** 2
                   for k, g in grads['f32'].items())
        norm = sum(float(g.double().norm()) ** 2
                   for g in grads['f32'].values())
        dist[name] = math.sqrt(diff / norm)
    gerrs = {k: _rel_l2(fused_grads[k], g)
             for k, g in grads['unfused'].items()}
    worst = max(gerrs, key=gerrs.get)
    _say('zoo', 'bf16 batch %d, the whole model with the same weights on the '
         'same batch: loss %.6f fused, %.6f unfused, %.6f f32; gradients '
         'over all %d tensors %.3g fused and %.3g unfused from the f32 '
         'model in relative L2 (bound: fused within twice unfused); fused '
         'and unfused tensors at most %.3g apart (%s)' % (
             BATCH, losses['fused'], losses['unfused'], losses['f32'],
             len(gerrs), dist['fused'], dist['unfused'], gerrs[worst], worst))
    # the loss within the bf16 tolerance of the reference's parity tests
    check_close('GoogLeNet-BN bf16 loss fused vs unfused',
                torch.tensor(losses['fused']), torch.tensor(losses['unfused']),
                5e-2, 0.0)
    if dist['fused'] > 2 * dist['unfused']:
        raise AssertionError('GoogLeNet-BN bf16 gradients: %.3g fused, %.3g '
                             'unfused from the f32 model' % (
                                 dist['fused'], dist['unfused']))


def _zoo_main():
    """GoogLeNet-BN (``fused_norm=True``, 224 px, bf16) trained for
    ``ZOO_STEPS`` steps at batch 64 through ``StandardUpdater``; returns
    the launch counts of that run."""
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, ops, training
    from chainermn_tpu_torch.datasets import imagenet
    comm = cmt.create_communicator('xla')
    try:
        model = models.GoogLeNetBN(fused_norm=True)
        n_norms, n_params = model.n_norms, len(list(model.parameters()))
        if n_norms != 68:
            raise AssertionError('GoogLeNet-BN has %d BN interludes' % n_norms)
        clf = models.StatefulClassifier(model)
        opt = cmt.create_multi_node_optimizer(
            ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
        raw, _ = imagenet.get_imagenet(BATCH, 8, size=256)
        mean = imagenet.compute_mean(raw, limit=BATCH)
        train = imagenet.PreprocessedDataset(raw, mean, 224, random=False)
        train = [train[i] for i in range(len(train))]   # set-up, once
        updater = training.StandardUpdater(
            training.SerialIterator(train, BATCH, shuffle=False), opt,
            clf.loss, model, comm)
        trainer = training.Trainer(updater, (ZOO_STEPS, 'iteration'),
                                   out=None)
        marks, losses = [], []

        def record(tr):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            losses.append(tr.observation['loss'])

        trainer.extend(record, trigger=(1, 'iteration'))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        sgd_tensors = ops.momentum_sgd.tensors
        peak = torch.cuda.max_memory_allocated()
        busy = profile_steps(updater, model=model)
        _zoo_interlude_check(model, clf, updater.shard_batch(train[:BATCH]))
    finally:
        comm.close()
    want = dict.fromkeys(ops.KERNELS, 0)
    # 206 tensors: two launches a step (a launch's table holds 200)
    per_step = -(-n_params // SGD_TABLE)
    want.update(bn_stats=n_norms * ZOO_STEPS, bn_apply=n_norms * ZOO_STEPS,
                bn_backward=n_norms * ZOO_STEPS,
                momentum_sgd=per_step * (ZOO_STEPS - 1))
    if counts != want:
        raise AssertionError('GoogLeNet-BN launch counts %s, expected %s'
                             % (counts, want))
    if sgd_tensors != n_params * (ZOO_STEPS - 1):
        raise AssertionError('momentum_sgd updated %d tensors, expected %d'
                             % (sgd_tensors, n_params * (ZOO_STEPS - 1)))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('GoogLeNet-BN: non-finite loss %s' % losses)
    steps = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    timed = sorted(steps[2:])
    p50 = timed[len(timed) // 2]
    _say('zoo', 'GoogLeNet-BN fused_norm=True, bf16, 224 px, batch %d, %d '
         'steps: losses %s; launches %s (%d interludes a step: one '
         'bn_stats, bn_apply and bn_backward each; %d momentum_sgd for %d '
         'tensors '
         'after step 0); step times ms %s; p50 of steps 2..%d %.2f ms = '
         '%.1f images/s; device busy %s over 3 profiled steps; peak memory '
         '%.2f GiB' % (BATCH, ZOO_STEPS, ', '.join('%.4f' % v for v in losses),
                       counts, n_norms, per_step, n_params,
                       ', '.join('%.1f' % (1e3 * v) for v in steps),
                       ZOO_STEPS - 1, 1e3 * p50, BATCH / p50,
                       'not measured' if busy is None
                       else '%.1f%%' % (100 * busy), peak / 2 ** 30))
    return counts


def _zoo_twins():
    """The ImageNet twin for each of ``ZOO_TWINS`` (hierarchical on NCCL,
    global batch 64, one epoch); returns the launch counts summed over
    the runs."""
    import shutil
    import tempfile
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.examples.imagenet import train_imagenet
    total = dict.fromkeys(ops.KERNELS, 0)
    for arch, quick in ZOO_TWINS:
        argv = ['--communicator', 'hierarchical', '--arch', arch,
                '--batchsize', str(IMAGENET_BATCH), '--epoch', '1']
        if quick:
            argv.append('--quick')
        out = tempfile.mkdtemp(prefix='zoo_twin_')
        try:
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            trainer, update_ms, losses, pinned, window_s = \
                _imagenet_example(out, argv)
            counts = ops.launch_counts()
            peak = torch.cuda.max_memory_allocated()
            iterations = trainer.updater.iteration
            insize = trainer.updater.model.insize
            # empty tensors (GoogLeNet's aux Dense at 64 px) take no row
            per_update = -(-sum(1 for p in trainer.updater.model.parameters()
                                if p.numel()) // SGD_TABLE)
            acc = dict(trainer.observation).get('validation/main/accuracy')
            train_imagenet.close(trainer)
        finally:
            shutil.rmtree(out, ignore_errors=True)
        want = dict.fromkeys(ops.KERNELS, 0)
        # the first update broadcasts
        want.update(momentum_sgd=per_update * (iterations - 1))
        if counts != want:
            raise AssertionError('ImageNet twin %s: launch counts %s, '
                                 'expected %s' % (arch, counts, want))
        if len(losses) != iterations or not all(math.isfinite(v)
                                                for v in losses):
            raise AssertionError('ImageNet twin %s: losses %s'
                                 % (arch, losses))
        if not pinned or not all(pinned):
            raise AssertionError('ImageNet twin %s: %d of %d batches pinned'
                                 % (arch, sum(pinned), len(pinned)))
        for key, n in counts.items():
            total[key] += n
        timed = sorted(update_ms[2:])
        p50 = timed[len(timed) // 2]
        _say('zoo', 'ImageNet twin --arch %s%s (insize %d, bf16, '
             'hierarchical on NCCL, global batch %d): %d iterations, %d '
             'momentum_sgd launches (%d an update) and no other kernel; '
             'update p50 %.3f ms '
             '= %.1f images/s (%d updates after 2 warm-up); %.1f images/s '
             'over the whole window; loss %.4f -> %.4f; validation accuracy '
             '%s; peak memory %.2f GiB' % (
                 arch, ' --quick' if quick else '', insize, IMAGENET_BATCH,
                 iterations, counts['momentum_sgd'], per_update, p50,
                 IMAGENET_BATCH / (p50 / 1e3), len(timed),
                 IMAGENET_BATCH * iterations / window_s, losses[0],
                 losses[-1], acc, peak / 2 ** 30))
    return total


def phase_zoo():
    """The fused / unfused check, GoogLeNet-BN's main path and the
    ImageNet twin over the zoo; returns ``(GoogLeNet-BN counts, twins'
    counts)``."""
    _zoo_fused_check()
    return _zoo_main(), _zoo_twins()


MP_CHECK_ITER = 5              # the card run is held to the CPU run here


def phase_model_parallel():
    """The model-parallel MNIST twin (``MultiNodeChainList`` over two MLP
    stages) in a world of one: 5 iterations on the CPU (gloo) and on the
    card (NCCL) agree, then the whole run at its defaults on the card;
    ``pseudo_connect`` and a self-edge ``send`` on CUDA tensors."""
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import functions, ops
    from chainermn_tpu_torch.examples.mnist import (
        train_mnist_model_parallel as twin)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('expected full-f32 matmuls (allow_tf32 False)')
    runs = {}
    for name, argv in (('cpu', ['--cpu']), ('cuda', [])):
        run = twin.main(argv, max_iterations=MP_CHECK_ITER)
        try:
            runs[name] = (run.losses, [p.detach().cpu().clone()
                                       for p in run.model.parameters()])
        finally:
            run.comm.close()
    (closs, cparams), (gloss, gparams) = runs['cpu'], runs['cuda']
    if len(gloss) != MP_CHECK_ITER or len(closs) != MP_CHECK_ITER:
        raise AssertionError('model-parallel: %d card, %d CPU steps'
                             % (len(gloss), len(closs)))
    for i, (a, b) in enumerate(zip(gloss, closs)):
        if abs(a - b) > 1e-4 * abs(b):
            raise AssertionError('model-parallel: loss %d card %r vs CPU %r'
                                 % (i, a, b))
    # rtol 1e-4, and an absolute 1e-4 (a tenth of Adam's lr): Adam
    # divides each gradient by its own running scale, so an element whose
    # gradient cancels to rounding noise (a pixel that is zero in all but
    # a few images) steps by up to about lr whatever the noise's size, on
    # the card and on the CPU alike (the LM test's key-bias gotcha)
    for i, (a, b) in enumerate(zip(gparams, cparams)):
        check_close('model-parallel parameter %d after %d iterations'
                    % (i, MP_CHECK_ITER), a, b, 1e-4, 1e-4)
    param_err = max(max_err(a, b) for a, b in zip(gparams, cparams))
    n_off = sum(int(((a - b).abs() > 1e-6).sum())
                for a, b in zip(gparams, cparams))
    n_all = sum(a.numel() for a in gparams)
    # the whole run on the card, each step timed
    marks = []

    def on_step(i, loss):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run = twin.main([], on_step=on_step)
    try:
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        window_s = time.perf_counter() - t0
        losses, accs = run.losses, run.val_accuracy
    finally:
        run.comm.close()
    if any(counts.values()):
        raise AssertionError('model-parallel twin launched %s' % counts)
    if not all(math.isfinite(v) for v in losses) or not accs[-1] > 0.5:
        raise AssertionError('model-parallel twin: losses %s..., accuracy '
                             '%s' % (losses[:5], accs))
    steps = sorted(b - a for a, b in zip(marks[1:-1], marks[2:]))
    p50 = steps[len(steps) // 2]
    # the differentiable functions on CUDA tensors
    comm = cmt.create_communicator('xla')
    try:
        x = torch.randn(7, device='cuda', requires_grad=True)
        d = torch.randn(3, device='cuda', requires_grad=True)
        out = functions.pseudo_connect(d * 2.0, x)
        (out * 3.0).sum().backward()
        check_close('pseudo_connect forward', out.detach(), x.detach(), 0, 0)
        check_close('pseudo_connect actual grad', x.grad,
                    torch.full_like(x, 3.0), 0, 0)
        check_close('pseudo_connect delegate grad', d.grad,
                    torch.zeros_like(d), 0, 0)
        x.grad = None
        y = functions.send(x, comm, rank=0, src=0)
        (y * 5.0).sum().backward()
        check_close('self-edge send', y.detach(), x.detach(), 0, 0)
        check_close('self-edge send grad', x.grad, torch.full_like(x, 5.0),
                    0, 0)
    finally:
        comm.close()
    _say('model_parallel', 'twin (MLP(200, 200) -> MLP(200, 10) over '
         'MultiNodeChainList(spmd=True), Adam 1e-3, batch 100, a world of '
         'one): first %d losses card %s, CPU %s; parameters after %d '
         'iterations: max abs err %.3g, %d of %d elements beyond 1e-6; the '
         'whole run on NCCL: %d '
         'iterations in %.2f s, step p50 %.3f ms = %.1f images/s, '
         'validation accuracy by epoch %s, no kernel launched; '
         'pseudo_connect and a self-edge send on the card: exact' % (
             MP_CHECK_ITER, ', '.join('%.6f' % v for v in gloss),
             ', '.join('%.6f' % v for v in closs), MP_CHECK_ITER, param_err,
             n_off, n_all, len(losses), window_s, 1e3 * p50, 100 / p50,
             ', '.join('%.4f' % a for a in accs)))
    return counts


def phase_seq2seq():
    """The seq2seq twin at its defaults (2 x 256 LSTM, vocabulary 512,
    batch 64, buckets 8 / 16 / 32, bf16) for one epoch on the card, then
    ``Seq2seq()`` at its class defaults (512 units, vocabulary 8000) in
    f32, card against CPU on one bucket."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import models, ops
    from chainermn_tpu_torch.examples.seq2seq import train_seq2seq
    marks, widths = [], []

    def on_step(width, metrics):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        widths.append(width)

    ops.reset_launch_counts()
    run = train_seq2seq.main(['--epoch', '1'], on_step=on_step)
    try:
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        run.comm.close()
    losses, tokens = run.losses, run.tokens
    if any(counts.values()):
        # jnp and optax in the JAX package: no kernel on this path
        raise AssertionError('seq2seq twin launched %s' % counts)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('seq2seq twin: non-finite loss %s' % losses)
    # the buckets run in turn (8, 16, 32), each with its own loss level:
    # the loss falls within each, mean of its first 3 steps to its last 3
    falls = {}
    for w in sorted(set(widths)):
        ls = [v for v, x in zip(losses, widths) if x == w]
        falls[w] = (sum(ls[:3]) / 3, sum(ls[-3:]) / 3, len(ls))
        if len(ls) < 6 or not falls[w][1] < falls[w][0]:
            raise AssertionError('seq2seq twin: bucket %d did not learn: %s'
                                 % (w, ls))
    window = marks[-1] - marks[1]
    steps = sorted(b - a for a, b in zip(marks[1:-1], marks[2:]))
    _say('seq2seq', 'twin (2 x 256 LSTM, vocabulary 512, batch 64, buckets '
         '8/16/32, bf16, xla on NCCL, 1 epoch of 8192 pairs): %d steps; '
         'loss by bucket (first 3 -> last 3, steps) %s; %.0f target tokens/s '
         'over steps 2..%d (%d tokens in %.3f s), step p50 %.2f ms; no '
         'kernel launched' % (
             len(losses), ', '.join('%d: %.4f -> %.4f (%d)' % (w, *f)
                                    for w, f in sorted(falls.items())),
             sum(tokens[2:]) / window, len(losses), sum(tokens[2:]), window,
             1e3 * steps[len(steps) // 2]))
    # Seq2seq() at its class defaults in f32, card vs CPU
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(6)
    xs = torch.randint(4, 8000, (16, 16), generator=gen)
    yin = torch.randint(4, 8000, (16, 16), generator=gen)
    yout = torch.randint(4, 8000, (16, 16), generator=gen)
    xs[:, 12:] = 0
    yin[:, 13:] = 0
    yout[:, 12:] = 0
    outs = {}
    for dev in ('cuda', 'cpu'):
        model = models.Seq2seq(dtype=torch.float32, device=dev,
                               generator=torch.Generator().manual_seed(7))
        logits = model(xs.to(dev), yin.to(dev))
        loss, _ = models.seq2seq_loss(model)(xs.to(dev), yin.to(dev),
                                             yout.to(dev))
        loss.backward()
        outs[dev] = (logits.detach().cpu(), loss.detach().cpu(),
                     model.out.weight.grad.detach().cpu(),
                     model.encoder_0.cell.ii.kernel.grad.detach().cpu())
        del model
    (gl, gloss, gout, genc), (cl, closs, cout, cenc) = outs['cuda'], \
        outs['cpu']
    check_close('Seq2seq logits card vs CPU', gl, cl, 1e-4, 1e-4)
    check_close('Seq2seq loss card vs CPU', gloss, closs, 1e-5, 1e-5)
    for what, a, b in (('out kernel', gout, cout),
                       ('encoder_0 ii kernel', genc, cenc)):
        scale = float(b.abs().max())
        check_close('Seq2seq %s gradient card vs CPU' % what, a, b, 1e-3,
                    1e-4 * scale)
    _say('seq2seq', 'Seq2seq() at its class defaults (2 x 512, vocabulary '
         '8000), f32, batch 16 x 16 with pads, card vs CPU: logits err %.3g, '
         'loss %.6f vs %.6f (perplexity %.1f), gradient err %.3g (out) and '
         '%.3g (encoder_0 ii)' % (
             max_err(gl, cl), float(gloss), float(closs),
             math.exp(float(gloss)), max_err(gout, cout),
             max_err(genc, cenc)))
    return counts


def _numpy_lm_weights(model, seed):
    """A flax parameter tree for ``model`` made from a numpy seed:
    kernels with variance 1 / fan_in, LayerNorm scales near 1, small
    biases, unit-variance embeddings."""
    import numpy as np
    from chainermn_tpu_torch import models
    rng = np.random.RandomState(seed)

    def fill(path, tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(path + (key,), value)
                continue
            a = rng.standard_normal(value.shape).astype(np.float32)
            if key == 'kernel':
                a /= math.sqrt(value.shape[0])
            elif key.endswith('_scale'):
                a = 1.0 + 0.1 * a
            elif key == 'pos_embed':
                a *= 0.02
            elif key != 'embedding':
                a *= 0.1
            out[key] = a
        return out

    return {'params': fill((), models.to_flax_variables(model)['params'])}


def finite_engine(*args, **kw):
    """A ``GenerationEngine`` that checks every step's logits finite
    before its greedy pick (one more reduction and host read per step:
    used outside the timed run)."""
    import torch
    from chainermn_tpu_torch import serving

    class FiniteEngine(serving.GenerationEngine):
        def _tokens(self, logits):
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError('non-finite logits in a %s step' % (
                    'prefill' if logits.dim() == 1 else 'decode'))
            return super()._tokens(logits)

    return FiniteEngine(*args, **kw)


def _drain(eng, queue, reqs, max_steps=10000):
    for _ in range(max_steps):
        if all(r.done() for r in reqs):
            return
        eng.step(queue)
    raise AssertionError('requests not done in %d steps' % max_steps)


def phase_serving_check():
    """Two f32 engines at full width and depth 2, the same numpy-seeded
    weights through the converter: one on the card (kernels, TF32 off),
    one on the CPU (plain versions).  Same greedy tokens, close prefill
    logits."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import models, serving
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        rng = np.random.RandomState(5)
        lengths = [4, 128] + list(rng.randint(4, 129, size=6))
        prompts = [rng.randint(0, SERVE_CFG['vocab_size'], n)
                   for n in lengths]
        weights = None
        toks, logits = {}, {}
        for dev in ('cuda', 'cpu'):
            model = models.TransformerLM(dtype=torch.float32, device=dev,
                                         **dict(SERVE_CFG, n_layers=2))
            weights = weights or _numpy_lm_weights(model, 6)
            models.load_flax_variables(model, weights)
            with torch.inference_mode():
                cache = models.init_kv_cache(model, 1, 128, device=dev)
                t = torch.zeros((1, 128), dtype=torch.int64, device=dev)
                t[0, :lengths[1]] = torch.from_numpy(prompts[1])
                out, _ = models.prefill(model, models.param_tree(model),
                                        cache, t, lengths[1], 0)
                logits[dev] = out.cpu()
            eng = finite_engine(model, n_slots=8, max_prompt_len=128,
                                max_len=512, device=dev)
            queue = serving.GenerationQueue(max_prompt_len=128)
            reqs = [queue.submit(p, 8) for p in prompts]
            _drain(eng, queue, reqs)
            toks[dev] = [[int(x) for x in r.result()] for r in reqs]
            del eng, model
    finally:
        torch.backends.cudnn.allow_tf32 = True
    # f32 with TF32 off: sums in another order on the card and the CPU
    tol = 1e-4
    check_close('prefill logits card vs CPU', logits['cuda'], logits['cpu'],
                tol, tol)
    if toks['cuda'] != toks['cpu']:
        raise AssertionError('greedy tokens differ, card %s vs CPU %s'
                             % (toks['cuda'], toks['cpu']))
    _say('serve-check', 'f32 depth 2, 8 prompts x 8 tokens: card and CPU '
         'tokens identical; prefill logits max err %.3g (tolerance %g)'
         % (max_err(logits['cuda'], logits['cpu']), tol))


# kernel-name fragments of each group in the serving profile
_SERVE_GROUPS = (('ported kernels', ('ln_kernel', 'flash_fwd_kernel',
                                     'flash_fwd_tc_kernel',
                                     'flash_decode_split_kernel')),
                 ('matmuls', ('gemm', 'cutlass', 'xmma', 'nvjet', 'sm90_',
                              'cublas')),
                 ('copies', ('memcpy', 'memset', 'copy')))


def profile_decode(eng, queue, n=5):
    """Device time by kernel group over ``n`` pure decode steps of a full
    bucket (``torch.profiler``), and the device's idle share: that busy
    time over the wall time of ``n`` such steps run just before without
    the profiler (and, for comparison, over the profiled steps' own)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(9)
    reqs = [queue.submit(rng.randint(0, SERVE_CFG['vocab_size'], 64),
                         (1 + PROFILE_TRIES) * n + 4)
            for _ in range(eng.n_slots)]
    eng.step(queue)                       # the prefills + one decode step
    eng.step(queue)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step(queue)
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    prof, kernels, wall_us = profiled(lambda: eng.step(queue), n)
    _drain(eng, queue, reqs)
    busy = sum(kernels.values())
    if busy == 0:
        _say('serve-profile', 'no device event in %d traces: not measured'
             % PROFILE_TRIES)
        return
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False))
    groups = {}
    for key, us in kernels.items():
        low = key.lower()
        group = next((g for g, frags in _SERVE_GROUPS
                      if any(f in low for f in frags)), 'other')
        groups[group] = groups.get(group, 0.0) + us
    _say('serve-profile', '%d decode steps of %d rows: wall %.3f ms/step '
         'without the profiler, %.3f ms/step under it; device busy %.3f '
         'ms/step, idle %.1f%% of the unprofiled wall (%.1f%% of the '
         'profiled); %d device kernels/step' % (
             n, eng.n_slots, plain_us / n / 1e3, wall_us / n / 1e3,
             busy / n / 1e3, 100 - 100 * busy / plain_us,
             100 - 100 * busy / wall_us, launches // n))
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        _say('serve-profile', '  %-16s %8.4f ms/step  %5.1f%% of device '
             'time' % (group, us / n / 1e3, 100 * us / busy))
    # the decode kernel's share (slot or paged: one launch a layer a step)
    dec = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and 'flash_decode' in e.key]
    dec_us = sum(e.self_device_time_total for e in dec)
    dec_n = sum(e.count for e in dec)
    _say('serve-profile', '  decode kernel    %8.4f ms/step  %5.1f%% of '
         'device time, %d launches/step, %.2f us a launch' % (
             dec_us / n / 1e3, 100 * dec_us / busy, dec_n // n,
             dec_us / max(dec_n, 1)))
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        _say('serve-profile', '  %8.4f ms/step  %s' % (us / n / 1e3,
                                                       key[:90]))
    # which PyTorch operators launched that device time (and how often)
    aten = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CPU
            and e.key.startswith('aten::') and e.device_time_total > 0]
    for e in sorted(aten, key=lambda e: -e.device_time_total)[:10]:
        _say('serve-profile', '  op %-28s %8.4f ms/step device, %4d '
             'calls/step, %8.4f ms/step host' % (
                 e.key, e.device_time_total / n / 1e3, e.count // n,
                 e.cpu_time_total / n / 1e3))


def _timed_serve(eng, queue, prompts, n_new=SERVE_NEW):
    """Submit ``prompts`` at once and drain them through ``step()``, with
    the launch counts set to 0 just before and read just after.  Returns
    the outputs, the counts, ``stats()``, the wall time, the TTFTs (from
    submit), the times of ticks that ran no prefill work, and the peak
    memory."""
    import torch
    from chainermn_tpu_torch import ops
    first = {}

    def on_token(rid, toks):
        first.setdefault(rid, time.perf_counter())

    # earlier engines' caches may wait for the cycle collector: free them
    # first, so that the peak is this engine's own
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    reqs = [queue.submit(p, n_new, on_token=on_token) for p in prompts]
    steps = []          # (seconds, prefill work in the step)
    while not all(r.done() for r in reqs):
        n0, s0 = eng.prefills + eng.prefill_chunks, time.perf_counter()
        eng.step(queue)
        steps.append((time.perf_counter() - s0,
                      eng.prefills + eng.prefill_chunks - n0))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(outs=[r.result() for r in reqs], counts=ops.launch_counts(),
                tc=ops.tc_launch_counts(), stats=eng.stats(), wall=wall,
                ttft=sorted(first[r.request_id] - t0 for r in reqs),
                decode=sorted(t for t, n in steps if n == 0),
                peak=torch.cuda.max_memory_allocated())


def _serve_metrics(res):
    """The serving metrics of a :func:`_timed_serve` run, for a log
    line."""
    st, ttft, decode = res['stats'], res['ttft'], res['decode']
    return ('%d requests x %d tokens in %d prefills (%d chunks) and %d '
            'decode steps (%.3f s): serve_generate_tokens_per_sec_per_chip '
            '%.1f; TTFT p50 %.2f ms (p99 %.2f ms, from submit, all '
            'submitted at once); decode-step p50 %.3f ms over %d ticks that '
            'ran no prefill (p99 %.3f ms); peak memory %.3f GiB' % (
                len(res['outs']), len(res['outs'][0]), st['prefills'],
                st.get('prefill_chunks', 0), st['decode_steps'], res['wall'],
                st['tokens_generated'] / res['wall'],
                1e3 * ttft[len(ttft) // 2], 1e3 * ttft[-1],
                1e3 * decode[len(decode) // 2], len(decode),
                1e3 * decode[min(len(decode) - 1, int(0.99 * len(decode)))],
                res['peak'] / 2 ** 30))


def _serve_prompts():
    """The serving main paths' 64 prompts of 4..128 tokens."""
    import numpy as np
    rng = np.random.RandomState(0)
    lengths = [4, SERVE_PROMPT] + list(rng.randint(4, SERVE_PROMPT + 1,
                                                   size=SERVE_REQUESTS - 2))
    return [rng.randint(0, SERVE_CFG['vocab_size'], n) for n in lengths]


def phase_serving_main():
    """The serving main path: ``GenerationEngine`` over the full-width
    ``TransformerLM`` of the repo's serving benchmark under
    ``Policy.bf16()``; 64 prompts of 4..128 tokens, 32 new tokens each,
    drained through ``step()``, with the kernel launch counts checked
    against the structure.  Returns the counts, the model, the prompts
    and the token streams."""
    import torch
    from chainermn_tpu_torch import models, ops, precision, serving
    model = models.TransformerLM(**SERVE_CFG,
                                 generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    eng = serving.GenerationEngine(model, n_slots=SERVE_SLOTS,
                                   max_prompt_len=SERVE_PROMPT,
                                   policy=precision.Policy.bf16())
    warm = eng.warmup()
    _say('serve', 'TransformerLM %d parameters, bf16 weights and cache, '
         '%d slots x %d positions; warmup of %d buckets %.2f s' % (
             n_params, SERVE_SLOTS, SERVE_CFG['max_len'],
             len(warm['prefill']) + len(warm['decode']),
             sum(warm['prefill'].values()) + sum(warm['decode'].values())))
    prompts = _serve_prompts()
    queue = serving.GenerationQueue(max_prompt_len=SERVE_PROMPT,
                                    max_queue=SERVE_REQUESTS)
    res = _timed_serve(eng, queue, prompts)
    counts, st, outs = res['counts'], res['stats'], res['outs']
    if any(len(o) != SERVE_NEW for o in outs):
        raise AssertionError('a request did not generate %d tokens'
                             % SERVE_NEW)
    layers = SERVE_CFG['n_layers']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=(2 * layers + 1) * (st['prefills']
                                               + st['decode_steps']),
                flash_fwd=layers * st['prefills'],
                flash_decode=layers * st['decode_steps'])
    if counts != want or st['prefills'] != SERVE_REQUESTS:
        raise AssertionError('launch counts %s over %d prefills and %d '
                             'decode steps, expected %s' % (
                                 counts, st['prefills'],
                                 st['decode_steps'], want))
    counts = with_tc('slot serving', counts, res['tc'])
    _say('serve', _serve_metrics(res))
    _say('serve', 'launches %s (per prefill: %d layer_norm, %d flash_fwd; '
         'per decode step: %d layer_norm, %d flash_decode)' % (
             counts, 2 * layers + 1, layers, 2 * layers + 1, layers))
    profile_decode(eng, queue)
    del eng
    # the same 64 requests again, outside the timed run, on an engine
    # that checks every step's logits finite: the same schedule over the
    # same kernels gives the same tokens
    chk = finite_engine(model, n_slots=SERVE_SLOTS,
                        max_prompt_len=SERVE_PROMPT,
                        policy=precision.Policy.bf16())
    reqs = [queue.submit(p, SERVE_NEW) for p in prompts]
    _drain(chk, queue, reqs)
    if [r.result().tolist() for r in reqs] != [o.tolist() for o in outs] \
            or chk.stats()['decode_steps'] != st['decode_steps']:
        raise AssertionError('the checked replay gave other tokens or '
                             'another schedule')
    _say('serve', 'replay of the %d requests with every step\'s logits '
         'checked: all finite, the same tokens in the same %d decode steps'
         % (SERVE_REQUESTS, st['decode_steps']))
    del chk
    # the int8 KV cache, once over a few requests
    eng8 = finite_engine(model, n_slots=SERVE_SLOTS,
                         max_prompt_len=SERVE_PROMPT,
                         policy=precision.Policy.bf16(), int8_kv=True)
    ops.reset_launch_counts()
    reqs = [queue.submit(p, 8) for p in prompts[:8]]
    _drain(eng8, queue, reqs)
    c8, st8 = ops.launch_counts(), eng8.stats()
    if c8['flash_decode'] != layers * st8['decode_steps'] \
            or any(len(r.result()) != 8 for r in reqs):
        raise AssertionError('int8 KV engine: counts %s, stats %s'
                             % (c8, st8))
    same = sum(a[:8].tolist() == b.tolist() for a, b in
               zip(outs, (r.result() for r in reqs)))
    _say('serve', 'int8 KV engine: 8 requests x 8 tokens, %d decode steps, '
         'launches %s; %d of 8 token streams equal the bf16 cache\'s'
         % (st8['decode_steps'], c8, same))
    return counts, model, prompts, [o.tolist() for o in outs]


# ---------------------------------------------------------------------
# paged and speculative serving

def _shared_prefix_prompts(rng, n_followers, prefix_len=120):
    """One ``prefix_len``-token leader (7 full 16-token pages and an
    8-token tail at 120) and ``n_followers`` prompts that extend it by a
    distinct 1..8-token suffix; the suffixes start with distinct tokens,
    so no follower's prompt is a prefix of another's."""
    vocab = SERVE_CFG['vocab_size']
    leader = rng.randint(0, vocab, prefix_len)
    heads = rng.choice(vocab, n_followers, replace=False)
    followers = [list(leader) + [int(heads[i])]
                 + list(rng.randint(0, vocab, i % 8)) for i in
                 range(n_followers)]
    return list(leader), followers


def _serve_shared(eng, queue, leader, followers, n_new):
    """The leader alone, then every follower at once; returns the
    followers' tokens."""
    _drain(eng, queue, [queue.submit(leader, n_new)])
    reqs = [queue.submit(p, n_new) for p in followers]
    _drain(eng, queue, reqs)
    return [r.result().tolist() for r in reqs]


def phase_paged_check():
    """The paged engine (whole prompts; chunks of 8; a shared-prefix set
    that hits the radix index and copies on write) and the speculative
    engine (a depth-1 draft; paged and not) at full width, depth 2, f32,
    from the numpy-seeded weights of phase 6: once on the card (kernels,
    TF32 off) and once on the CPU (plain versions).  Every mode gives the
    CPU's greedy tokens, and on the card each speculative engine gives
    its plain twin's."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import models, serving
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('expected full-f32 matmuls (allow_tf32 False)')
    rng = np.random.RandomState(7)
    lengths = [4, 128] + list(rng.randint(4, 129, size=4))
    prompts = [rng.randint(0, SERVE_CFG['vocab_size'], n) for n in lengths]
    leader, followers = _shared_prefix_prompts(rng, 5)
    # spec: the depth-1 draft; 'self': the target drafts for itself, so
    # the accept path runs too (a random draft rarely agrees)
    modes = {'slot': {}, 'paged': dict(paged=True),
             'chunked': dict(paged=True, prefill_chunk=8),
             'spec_slot': dict(spec='draft'),
             'spec_paged': dict(paged=True, spec='draft'),
             'spec_self': dict(paged=True, spec='self')}
    toks, shared, rates = {}, {}, {}
    weights = draft_weights = None
    for dev in ('cuda', 'cpu'):
        model = models.TransformerLM(dtype=torch.float32, device=dev,
                                     **dict(SERVE_CFG, n_layers=2))
        weights = weights or _numpy_lm_weights(model, 6)
        models.load_flax_variables(model, weights)
        draft = models.TransformerLM(dtype=torch.float32, device=dev,
                                     **dict(SERVE_CFG, n_layers=1))
        draft_weights = draft_weights or _numpy_lm_weights(draft, 8)
        models.load_flax_variables(draft, draft_weights)
        toks[dev], rates[dev] = {}, {}
        for name, kw in modes.items():
            kw = dict(kw)
            spec = kw.pop('spec', None)
            if spec:
                dm = draft if spec == 'draft' else model
                kw.update(draft_model=dm, draft_params=models.param_tree(dm))
            eng = serving.GenerationEngine(
                model, n_slots=8, max_prompt_len=128, max_len=512,
                device=dev, **kw)
            queue = serving.GenerationQueue(
                max_prompt_len=128, page_size=16 if eng.paged else None)
            reqs = [queue.submit(p, 8) for p in prompts]
            _drain(eng, queue, reqs)
            toks[dev][name] = [r.result().tolist() for r in reqs]
            if spec:
                rates[dev][name] = eng.stats()['speculative'][
                    'accepted_draft_rate']
        eng = serving.GenerationEngine(model, n_slots=8, max_prompt_len=128,
                                       max_len=512, device=dev, paged=True)
        queue = serving.GenerationQueue(max_prompt_len=128, page_size=16)
        toks[dev]['shared'] = _serve_shared(eng, queue, leader, followers, 8)
        st = eng.stats()
        shared[dev] = (st['prefix_hits'], st['cow_copies'],
                       st['prefix_tokens_reused'])
        if shared[dev] != (5, 5, 5 * len(leader)):
            raise AssertionError('shared prefix on %s: hits, copies, reused '
                                 '%s' % (dev, shared[dev]))
        del eng, model, draft
    for name in toks['cpu']:
        if toks['cuda'][name] != toks['cpu'][name]:
            raise AssertionError('%s engine: greedy tokens differ, card %s vs '
                                 'CPU %s' % (name, toks['cuda'][name],
                                             toks['cpu'][name]))
    for spec, twin in (('spec_slot', 'slot'), ('spec_paged', 'paged'),
                       ('spec_self', 'paged')):
        if toks['cuda'][spec] != toks['cuda'][twin]:
            raise AssertionError('%s: tokens differ from the %s engine\'s'
                                 % (spec, twin))
    own = rates['cuda']['spec_self']
    if not own >= 0.5:
        raise AssertionError('the target drafting for itself accepted only '
                             '%s of its proposals' % own)
    _say('paged-check', 'f32 depth 2, %d prompts x 8 tokens (and %d '
         'followers of a %d-token prefix): card and CPU tokens identical in '
         'the modes %s; the speculative engines equal their plain twins on '
         'the card; accepted_draft_rate on the card %s; prefix hits, '
         'copies, tokens reused %s; paged equals slot on the card: %s, on '
         'the CPU: %s' % (
             len(prompts), len(followers), len(leader),
             ', '.join(sorted(toks['cpu'])),
             ', '.join('%s %.4f' % kv for kv in sorted(rates['cuda'].items())),
             shared['cuda'],
             toks['cuda']['paged'] == toks['cuda']['slot'],
             toks['cpu']['paged'] == toks['cpu']['slot']))


def _paged_engine(model, **kw):
    from chainermn_tpu_torch import precision, serving
    return serving.GenerationEngine(
        model, n_slots=SERVE_SLOTS, max_prompt_len=SERVE_PROMPT,
        policy=precision.Policy.bf16(), paged=True, page_size=16, **kw)


def _paged_queue():
    from chainermn_tpu_torch import serving
    return serving.GenerationQueue(max_prompt_len=SERVE_PROMPT,
                                   max_queue=SERVE_REQUESTS, page_size=16)


def phase_paged_main(model, prompts, slot_outs):
    """The paged serving main path: ``GenerationEngine(paged=True,
    page_size=16)`` over phase 7's model, bf16, 32 slots, the same 64
    prompts; every stream equal to the slot engine's, the launch counts
    checked against the structure.  Then chunked prefill (32), and a
    shared-prefix set against the same requests without sharing."""
    from chainermn_tpu_torch import ops
    eng = _paged_engine(model)
    warm = eng.warmup()
    _say('paged', 'pool %s pages of 16 positions (%d per sequence), %d '
         'slots; warmup of %d buckets %.2f s' % (
             eng.n_pages, eng.pages_per_seq, SERVE_SLOTS,
             len(warm['prefill']) + len(warm['decode']),
             sum(warm['prefill'].values()) + sum(warm['decode'].values())))
    queue = _paged_queue()
    res = _timed_serve(eng, queue, prompts)
    counts, st = res['counts'], res['stats']
    outs = [o.tolist() for o in res['outs']]
    layers = SERVE_CFG['n_layers']
    chunks = st['prefill_chunks']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=(2 * layers + 1) * (chunks + st['decode_steps']),
                flash_fwd=layers * chunks,
                flash_decode_paged=layers * st['decode_steps'])
    if counts != want or chunks != SERVE_REQUESTS:
        raise AssertionError('paged launch counts %s over %d chunks and %d '
                             'decode steps, expected %s'
                             % (counts, chunks, st['decode_steps'], want))
    counts = with_tc('paged serving', counts, res['tc'])
    same = sum(a == b for a, b in zip(outs, slot_outs))
    if same != len(slot_outs):
        raise AssertionError('paged engine: %d of %d streams equal the slot '
                             'engine\'s' % (same, len(slot_outs)))
    slab = SERVE_SLOTS * st['pages_per_seq']
    _say('paged', _serve_metrics(res))
    _say('paged', 'launches %s (per chunk: %d layer_norm, %d flash_fwd; per '
         'decode step: %d layer_norm, %d flash_decode_paged); all %d streams '
         'equal the slot engine\'s; peak_pages_in_use %d of the '
         'slab-equivalent %d (%d slots x %d pages); prefix lookups %d, hits '
         '%d' % (counts, 2 * layers + 1, layers, 2 * layers + 1, layers,
                 same, st['peak_pages_in_use'], slab, SERVE_SLOTS,
                 st['pages_per_seq'], st['prefix_lookups'],
                 st['prefix_hits']))
    profile_decode(eng, queue)
    del eng
    # chunked prefill
    eng = _paged_engine(model, prefill_chunk=32)
    eng.warmup()
    res = _timed_serve(eng, _paged_queue(), prompts)
    st = res['stats']
    same = sum(a.tolist() == b for a, b in zip(res['outs'], slot_outs))
    _say('paged', 'prefill_chunk 32: %s; peak_pages_in_use %d; %d of %d '
         'streams equal the slot engine\'s' % (
             _serve_metrics(res), st['peak_pages_in_use'], same,
             len(slot_outs)))
    del eng
    # shared prefix, with and without the radix index
    import numpy as np
    leader, followers = _shared_prefix_prompts(np.random.RandomState(8),
                                               SERVE_SLOTS - 1)
    peaks = {}
    for sharing in (True, False):
        eng = _paged_engine(model, prefix_sharing=sharing)
        eng.warmup()
        queue = _paged_queue()
        t0 = time.perf_counter()
        got = _serve_shared(eng, queue, leader, followers, SERVE_NEW)
        wall = time.perf_counter() - t0
        st = eng.stats()
        peaks[sharing] = st['peak_pages_in_use']
        if sharing:
            n = len(followers)
            if (st['prefix_hits'], st['cow_copies'],
                    st['prefix_tokens_reused']) != (n, n, n * len(leader)):
                raise AssertionError(
                    'shared prefix: hits %d, copies %d, tokens reused %d; '
                    'expected %d, %d, %d' % (
                        st['prefix_hits'], st['cow_copies'],
                        st['prefix_tokens_reused'], n, n, n * len(leader)))
            shared_outs, hits = got, st
        elif got != shared_outs:
            _say('paged', 'shared prefix: %d of %d streams equal without '
                 'sharing' % (sum(a == b for a, b in zip(got, shared_outs)),
                              len(got)))
        _say('paged', 'shared prefix (%d-token leader, then %d followers, %d '
             'new tokens each), prefix_sharing=%s: %.3f s, peak_pages_in_use '
             '%d' % (len(leader), len(followers), SERVE_NEW, sharing, wall,
                     st['peak_pages_in_use']))
        del eng
    _say('paged', 'shared prefix: prefix_hits %d, cow_copies %d, '
         'prefix_tokens_reused %d (= %d x %d); peak_pages_in_use %d with '
         'sharing vs %d without' % (
             hits['prefix_hits'], hits['cow_copies'],
             hits['prefix_tokens_reused'], len(followers), len(leader),
             peaks[True], peaks[False]))
    return counts, outs


def phase_spec_main(model, prompts, paged_outs):
    """The speculative main path: the full-width target with a 3-layer
    draft of the same widths from another seed (as ``bench.py
    --speculative``), ``spec_tokens=4``, paged, over the 64 prompts; the
    launch counts checked against the structure."""
    import torch
    from chainermn_tpu_torch import models, ops
    draft = models.TransformerLM(**dict(SERVE_CFG, n_layers=3),
                                 generator=torch.Generator().manual_seed(7))
    eng = _paged_engine(model, draft_model=draft,
                        draft_params=models.param_tree(draft), spec_tokens=4)
    eng.warmup()
    res = _timed_serve(eng, _paged_queue(), prompts)
    counts, st = res['counts'], res['stats']
    spec = st['speculative']
    if any(len(o) != SERVE_NEW for o in res['outs']):
        raise AssertionError('a speculative request did not generate %d '
                             'tokens' % SERVE_NEW)
    layers, d_layers = SERVE_CFG['n_layers'], draft.n_layers
    chunks, verify = st['prefill_chunks'], spec['verify_steps']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(
        layer_norm=((2 * layers + 1) * (chunks + verify)
                    + (2 * d_layers + 1) * (chunks + spec['draft_steps'])),
        flash_fwd=(layers + d_layers) * chunks + layers * verify,
        flash_decode_paged=d_layers * spec['draft_steps'])
    if counts != want or spec['draft_steps'] != 4 * verify:
        raise AssertionError('speculative launch counts %s over %d chunks, '
                             '%d draft steps and %d verify passes, expected '
                             '%s' % (counts, chunks, spec['draft_steps'],
                                     verify, want))
    counts = with_tc('speculative serving', counts, res['tc'])
    same = sum(a.tolist() == b for a, b in zip(res['outs'], paged_outs))
    _say('spec', _serve_metrics(res))
    _say('spec', 'draft 3 layers (seed 7), k 4: %d draft steps, %d verify '
         'passes, accepted_draft_rate %.4f (%d of %d proposed); %.4f verify '
         'passes and %.4f verify flash_fwd launches per generated token; '
         'launches %s; %d of %d streams equal the plain paged engine\'s' % (
             spec['draft_steps'], verify, spec['accepted_draft_rate'],
             spec['draft_accepted'], spec['draft_proposed'],
             verify / st['tokens_generated'],
             layers * verify / st['tokens_generated'], counts, same,
             len(paged_outs)))
    return counts


# ---------------------------------------------------------------------
# TransformerLM training

def _ce_cases(gen):
    """The cross-entropy kernel against its plain version; returns the
    record, timed at the LM's ``(8192, 32000)`` f32 logits."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    ce = importlib.import_module('chainermn_tpu_torch.ops.cross_entropy')
    bf16, f32 = torch.bfloat16, torch.float32
    # loss and lse are f32 sums of up to 32000 terms taken in another
    # order than the plain version's: rtol 1e-5, atol 1e-5
    tol = (1e-5, 1e-5)
    errs = []
    timed = None
    for (b, v), dtype, pad in (((LM_BATCH * LM_SEQ, 32000), f32, False),
                               ((13, 1000), bf16, False),
                               ((5, 33), f32, True),
                               ((64, 32000), bf16, True)):
        logits = (torch.randn((b, v), generator=gen, device='cuda')
                  * 3).to(dtype)
        labels = torch.randint(0, v, (b,), generator=gen, device='cuda',
                               dtype=torch.int32)
        if pad:       # labels outside [0, V) pick nothing: loss = lse
            labels[::2] = -1
            labels[1] = v
        loss, lse = ops.ce_forward(logits, labels)
        torch.cuda.synchronize()
        ploss, plse = ce._ce_forward_plain(logits, labels)
        what = 'cross_entropy %s %s' % ((b, v), str(dtype).split('.')[-1])
        check_close(what + ' loss', loss, ploss, *tol)
        check_close(what + ' lse', lse, plse, *tol)
        if pad and not torch.equal(loss[::2], lse[::2]):
            raise AssertionError(what + ': a label of -1 picked something')
        again = ops.ce_forward(logits, labels)
        if not (torch.equal(again[0], loss) and torch.equal(again[1], lse)):
            raise AssertionError(what + ': two runs differ')
        errs.append(max(max_err(loss, ploss), max_err(lse, plse)))
        if timed is None:
            timed = (logits, labels)
    logits, labels = timed
    b, v = logits.shape
    long_labels = labels.long()
    t = timings(lambda: ops.ce_forward(logits, labels),
                lambda: ce._ce_forward_plain(logits, labels),
                lambda: F.cross_entropy(logits, long_labels,
                                        reduction='none'), iters=10)
    # logits read once, labels read, loss and lse written; per element a
    # max, a subtraction, an exponential and an add
    b_ms, b_by = bound_ms(b * v * 4 + 3 * b * 4, 4 * b * v)
    _say('kernels', 'cross_entropy max err %.3g over %d cases (rtol, atol: '
         '%s); at %s f32: %s (F.cross_entropy, reduction none); bound %.5f '
         'ms by %s' % (max(errs), len(errs), tol, (b, v), _fmt(t), b_ms,
                       b_by))
    return dict(name='cross_entropy', route='cuda',
                source='chainermn_tpu_torch/csrc/cross_entropy.cu',
                replaces='chainermn_tpu/ops/cross_entropy.py:48',
                max_abs_err=max(errs), bound_ms=b_ms, bound_by=b_by, **t)


def _flash_bwd_operands(gen, shape, t_kv, dtype, causal):
    """q, k, v as strided views of fused projections, a random g, and the
    kernel forward's out and lse."""
    import torch
    from chainermn_tpu_torch import ops
    b, t_q, h, d = shape
    q, k, v = _strided_qkv(gen, (b, t_q), h, d, dtype)
    if t_kv != t_q:
        _, k, v = _strided_qkv(gen, (b, t_kv), h, d, dtype)
    g = torch.randn(shape, generator=gen, device='cuda').to(dtype)
    out, lse = ops.flash_fwd(q, k, v, causal, d ** -0.5)
    return q, k, v, g, out, lse


def _delta(g, out):
    return (g.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _flash_bwd_cases(gen):
    """The two backward kernels against the plain blockwise backward;
    returns their records, timed at the LM's attention shape."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')
    bf16, f32 = torch.bfloat16, torch.float32
    # f32: sums over up to 1024 keys or queries in another order, 1e-4;
    # bf16: BF16_TOL (f32 on both sides, rounded once)
    tol = {f32: (1e-4, 1e-4), bf16: BF16_TOL}
    main = (LM_BATCH, LM_SEQ, LM_CFG['n_heads'],
            LM_CFG['d_model'] // LM_CFG['n_heads'])
    # bf16 dq and dk/dv take the tensor-core kernels, f32 the scalar ones;
    # the last five bf16 cases: every head width ragged across the 64-row
    # tile, t_q != t_kv, the verify window
    cases = [(main, LM_SEQ, bf16, True),
             ((1, 37, 4, 32), 37, bf16, True),      # less than one tile
             ((2, 100, 8, 64), 100, f32, True),
             ((1, 130, 2, 128), 130, f32, True),
             ((2, 130, 2, 64), 130, bf16, True),
             ((2, 77, 8, 64), 150, f32, False),     # t_q != t_kv
             ((1, 200, 2, 128), 90, bf16, False),
             ((2, 64, 4, 32), 64, f32, False),
             ((2, 130, 4, 32), 130, bf16, True),
             ((2, 65, 4, 64), 65, bf16, True),
             ((1, 130, 2, 128), 130, bf16, True),
             ((2, 77, 8, 64), 150, bf16, False),
             ((32, 4, 8, 64), 4, bf16, True)]
    errs = {'dq': [], 'dkv': [], 'delta': []}
    timed = None
    for shape, t_kv, dtype, causal in cases:
        b, t_q, h, d = shape
        scale = d ** -0.5
        q, k, v, g, out, lse = _flash_bwd_operands(gen, shape, t_kv, dtype,
                                                   causal)
        tc0 = ops.tc_launch_counts()
        dq, delta = ops.flash_bwd_dq(q, k, v, g, out, lse, causal, scale)
        torch.cuda.synchronize()
        # dk/dv reads the delta the dq kernel wrote
        dk, dv = ops.flash_bwd_dkv(q, k, v, g, lse, delta, causal, scale)
        torch.cuda.synchronize()
        tc1 = ops.tc_launch_counts()
        for name in ('flash_bwd_dq', 'flash_bwd_dkv'):
            if tc1[name] - tc0[name] != (dtype == bf16):
                raise AssertionError('%s %s: the tensor-core kernel runs for '
                                     'bf16 and only for bf16' % (name, dtype))
        pdq, pdk, pdv = fa._bwd_plain(q, k, v, out, lse, g, causal, scale)
        what = 'flash_bwd %s t_kv %d %s causal=%s' % (
            shape, t_kv, str(dtype).split('.')[-1], causal)
        for name, got, want in (('dq', dq, pdq), ('dk', dk, pdk),
                                ('dv', dv, pdv)):
            check_close('%s %s' % (what, name), got, want, *tol[dtype])
        # delta: f32 sums of D exact products, in another order than
        # torch's
        pdelta = _delta(g, out)
        check_close('%s delta' % what, delta, pdelta, 1e-5, 1e-4)
        errs['dq'].append(max_err(dq, pdq))
        errs['dkv'].append(max(max_err(dk, pdk), max_err(dv, pdv)))
        errs['delta'].append(max_err(delta, pdelta))
        # no float atomics: a second run gives the same bits; contiguous
        # operands give the same bits as the strided views
        qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
        for args in ((q, k, v), (qc, kc, vc)):
            dq2, delta2 = ops.flash_bwd_dq(*args, g, out, lse, causal, scale)
            dk2, dv2 = ops.flash_bwd_dkv(*args, g, lse, delta2, causal,
                                         scale)
            if not (torch.equal(dq2, dq) and torch.equal(delta2, delta)
                    and torch.equal(dk2, dk) and torch.equal(dv2, dv)):
                raise AssertionError(
                    what + ': a second run (or contiguous operands) '
                    'gave other bits')
        if timed is None:
            timed = (q, k, v, g, out, lse, delta)

    def both(q, k, v, g, out, lse, scale):
        """The backward as autograd runs it: dq (and delta), then dk/dv."""
        dq, delta = ops.flash_bwd_dq(q, k, v, g, out, lse, True, scale)
        return (dq, delta, *ops.flash_bwd_dkv(q, k, v, g, lse, delta, True,
                                              scale))

    # the gradient of out.sum(): an expanded scalar, every stride 0
    shape, d = (2, 100, 8, 64), 64
    q, k, v, g, out, lse = _flash_bwd_operands(gen, shape, 100, bf16, True)
    ones = torch.ones((), dtype=bf16, device='cuda').expand(shape)
    if any(ones.stride()):
        raise AssertionError('expected an expanded gradient')
    a = both(q, k, v, ones, out, lse, d ** -0.5)
    c = both(q, k, v, ones.contiguous(), out, lse, d ** -0.5)
    if not all(torch.equal(x, y) for x, y in zip(a, c)):
        raise AssertionError('flash_bwd: an expanded g gave other bits than '
                             'its contiguous copy')
    # operands whose rows are not 16-byte aligned: handed to the
    # tensor-core kernels as contiguous copies, the same bits
    mk, mg, mo = _misaligned(k), _misaligned(ones), _misaligned(out)
    if fa._aligned16(mk) or fa._aligned16(mg) or fa._aligned16(mo):
        raise AssertionError('expected misaligned copies')
    m = both(q, mk, v, mg, mo, lse, d ** -0.5)
    if not all(torch.equal(x, y) for x, y in zip(m, a)):
        raise AssertionError('flash_bwd_dq / flash_bwd_dkv: misaligned '
                             'operands gave other bits')
    # through autograd, against autograd of the full-softmax oracle (f32)
    q, k, v, g, _, _ = _flash_bwd_operands(gen, (2, 70, 4, 64), 70, f32, True)
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(ops.flash_attention(*leaves, causal=True),
                              leaves, g)
    want = torch.autograd.grad(ops.mha_reference(*leaves, causal=True),
                               leaves, g)
    for name, x, y in zip(('dq', 'dk', 'dv'), got, want):
        check_close('flash_attention autograd %s vs the oracle' % name, x, y,
                    *tol[f32])

    q, k, v, g, out, lse, delta = timed
    b, t, h, d = q.shape
    # the library yardstick: the backward of SDPA through autograd (dq,
    # dk and dv in one call; the same time stands in both rows)
    lq, lk, lv = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lout = F.scaled_dot_product_attention(lq, lk, lv, is_causal=True)
    lg = g.transpose(1, 2)

    def library():
        return torch.autograd.grad(lout, (lq, lk, lv), lg, retain_graph=True)

    def plain():
        return fa._bwd_plain(q, k, v, out, lse, g, True, 0.125)

    pairs = t * (t + 1) // 2
    records = []
    # the scalar kernels (the f32 route, the design the tensor-core
    # kernels replaced for bf16) in the same call
    qf, kf, vf, gf, of = (x.float() for x in (q, k, v, g, out))
    for name, kernel, n_products, n_tensors, line, scalar in (
            ('flash_bwd_dq',
             lambda: ops.flash_bwd_dq(q, k, v, g, out, lse, True, 0.125),
             3, 6, 375,
             lambda: ops.flash_bwd_dq(qf, kf, vf, gf, of, lse, True, 0.125)),
            ('flash_bwd_dkv',
             lambda: ops.flash_bwd_dkv(q, k, v, g, lse, delta, True, 0.125),
             4, 6, 397,
             lambda: ops.flash_bwd_dkv(qf, kf, vf, gf, lse, delta, True,
                                       0.125))):
        tm = timings(kernel, plain, library, iters=10, plain_iters=3)
        tm.update(scalar_f32_ms=time_ms(scalar, 10),
                  scalar_f32_device_ms=device_ms(scalar, 10))
        _say('kernels', '%s causal %s f32 (scalar kernel): per call %.5f '
             'ms, device only %s ms' % (
                 name, (b, t, h, d), tm['scalar_f32_ms'],
                 _ms(tm['scalar_f32_device_ms'])))
        # dq: q, k, v, g, out read once and dq written once (bf16), lse
        # read and delta written (f32); dk/dv: q, k, v, g read and dk, dv
        # written, lse and delta read.  s, dp and the kernel's own
        # products over the causal half, at the bf16 tensor-core rate
        n_bytes = n_tensors * b * t * h * d * 2 + 2 * b * h * t * 4
        b_ms, b_by = bound_ms(n_bytes, n_products * 2 * b * h * pairs * d,
                              BF16_TC_FLOPS_PER_S)
        key = 'dq' if name.endswith('dq') else 'dkv'
        _say('kernels', '%s max err %.3g over %d cases (f32 %s, bf16 %s); '
             'causal %s bf16 (tensor cores): %s (SDPA backward, dq + dk + '
             'dv; the plain version also computes all three); bound %.5f ms '
             'by %s' % (name, max(errs[key]), len(errs[key]), tol[f32],
                        tol[bf16], (b, t, h, d), _fmt(tm), b_ms, b_by))
        records.append(dict(
            name=name, route='cuda',
            source='chainermn_tpu_torch/csrc/flash_attention.cu',
            replaces='chainermn_tpu/ops/flash_attention.py:%d' % line,
            max_abs_err=max(errs[key]), bound_ms=b_ms, bound_by=b_by, **tm))
    _say('kernels', 'flash_bwd_dq delta max err %.3g over %d cases (rtol '
         '1e-5, atol 1e-4)' % (max(errs['delta']), len(errs['delta'])))
    # the whole backward, dq (with delta) then dk/dv, against SDPA's
    whole = dict(
        ms=time_ms(lambda: both(q, k, v, g, out, lse, 0.125), 10),
        device_ms=device_ms(lambda: both(q, k, v, g, out, lse, 0.125), 10))
    dq_rec = records[0]
    dq_rec.update(dq_plus_dkv_ms=whole['ms'],
                  dq_plus_dkv_device_ms=whole['device_ms'])
    _say('kernels', 'flash backward dq + dk/dv causal %s bf16: per call '
         '%.5f ms, device only %s ms; SDPA\'s whole backward per call %.5f '
         'ms, device only %s ms; ratio (device) %s' % (
             (b, t, h, d), whole['ms'], _ms(whole['device_ms']),
             dq_rec['library_ms'], _ms(dq_rec['library_device_ms']),
             '%.2f' % (whole['device_ms'] / dq_rec['library_device_ms'])
             if whole['device_ms'] and dq_rec['library_device_ms']
             else 'not measured'))
    return records


def phase_training_kernels():
    """The LM training path's new kernels against their plain versions on
    the card, at the shapes of the full-width TransformerLM."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(4)
    return [_ce_cases(gen)] + _flash_bwd_cases(gen)


def phase_lm_check():
    """A depth-2 f32 full-width ``TransformerLM`` from numpy-seeded
    weights, once on the card (kernels, TF32 off) and once on the CPU
    (plain versions): the ``lm_loss`` value and every leaf's gradient."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import models
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError('expected full-f32 matmuls (allow_tf32 False)')
    rng = np.random.RandomState(11)
    # 160 tokens: ragged against the backward's 64-row tiles
    toks = rng.randint(0, LM_CFG['vocab_size'], (2, 160)).astype(np.int32)
    tgts = rng.randint(0, LM_CFG['vocab_size'], (2, 160)).astype(np.int32)
    tgts[0, :7] = -1                        # padded targets get no gradient
    weights = None
    loss, grads = {}, {}
    for dev in ('cuda', 'cpu'):
        model = models.TransformerLM(dtype=torch.float32, device=dev,
                                     **dict(LM_CFG, n_layers=2))
        weights = weights or _numpy_lm_weights(model, 12)
        models.load_flax_variables(model, weights)
        value, metrics = models.lm_loss(model)(
            torch.from_numpy(toks).to(dev), torch.from_numpy(tgts).to(dev))
        value.backward()
        loss[dev] = (float(value.detach()), float(metrics['perp']))
        grads[dev] = {name: p.grad.detach().float().cpu()
                      for name, p in model.named_parameters()}
        del model
    # f32 with TF32 off: the card and the CPU sum every product in another
    # order through two blocks.  A leaf is held as a whole: its error
    # against the largest entry of the CPU's gradient (entries that cancel
    # to ~0, like the key bias's, have no meaningful relative error)
    tol = 2e-4
    if abs(loss['cuda'][0] - loss['cpu'][0]) > tol * abs(loss['cpu'][0]):
        raise AssertionError('lm_loss card %r vs CPU %r' % (loss['cuda'],
                                                             loss['cpu']))
    worst = ('', 0.0)
    for name, want in grads['cpu'].items():
        err = max_err(grads['cuda'][name], want) / float(want.abs().max())
        if not err <= tol:
            raise AssertionError('gradient of %s: err %.3g of its largest '
                                 'entry, beyond %g' % (name, err, tol))
        worst = max(worst, (name, err), key=lambda kv: kv[1])
    _say('lm-check', 'f32 depth 2, 2 x 160 tokens, card vs CPU: loss %.6f vs '
         '%.6f, perp %.3f vs %.3f; %d gradient leaves, worst %s at %.3g of '
         'its largest entry (tolerance %g)' % (
             loss['cuda'][0], loss['cpu'][0], loss['cuda'][1],
             loss['cpu'][1], len(grads['cpu']), worst[0], worst[1], tol))


# kernel-name fragments of each group in the LM training profile
_LM_GROUPS = (('layer_norm', ('ln_kernel',)),
              ('flash_fwd', ('flash_fwd_kernel', 'flash_fwd_tc_kernel')),
              ('flash_bwd_dq', ('flash_bwd_dq_kernel',
                                'flash_bwd_dq_tc_kernel')),
              ('flash_bwd_dkv', ('flash_bwd_dkv_kernel',
                                 'flash_bwd_dkv_tc_kernel')),
              # "::" keeps at::native::reduce_kernel out
              ('cross_entropy', ('::ce_kernel<',)),
              # the head is the path's only f32 product
              ('matmuls, f32 (the head)', ('sgemm', 'f32f32')),
              ('matmuls, bf16', ('gemm', 'cutlass', 'xmma', 'nvjet', 'sm90_',
                                 'cublas')),
              ('copies and casts', ('memcpy', 'memset', 'copy')))
# CPU-side profiler events whose device time is reported beside the groups
_LM_OPS = ('_SoftmaxCrossEntropyBackward', '_LayerNormBackward',
           '_FlashAttentionBackward', 'Optimizer.step#Adam.step',
           'IndexSelectBackward0')


def profile_lm(updater, n=3):
    """``n`` unprofiled steps for the wall time, then ``n`` steps under
    ``torch.profiler``: the device's busy and idle share of an unprofiled
    step, device time by kernel group, and the device time under the
    backward of each op that the port writes in PyTorch ops."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        updater.update()
    torch.cuda.synchronize()
    plain_us = (time.perf_counter() - t0) * 1e6
    prof, kernels, wall_us = profiled(updater.update, n)
    busy = sum(kernels.values())
    if busy == 0:
        _say('lm-profile', 'no device event in %d traces: not measured'
             % PROFILE_TRIES)
        return
    launches = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not getattr(e, 'is_user_annotation', False))
    _say('lm-profile', '%d steps: wall %.2f ms/step without the profiler, '
         '%.2f ms/step under it; device busy %.2f ms/step, idle %.1f%% of '
         'the unprofiled wall; %d device kernels/step' % (
             n, plain_us / n / 1e3, wall_us / n / 1e3, busy / n / 1e3,
             100 - 100 * busy / plain_us, launches // n))
    groups = _by_group(kernels, _LM_GROUPS)
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        _say('lm-profile', '  %-24s %8.3f ms/step  %5.1f%% of device time'
             % (group, us / n / 1e3, 100 * us / busy))
    for key, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:14]:
        _say('lm-profile', '  %8.3f ms/step  %s' % (us / n / 1e3, key[:100]))
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CPU \
                and e.key.startswith(_LM_OPS):
            _say('lm-profile', '  op %-36s %8.3f ms/step device, %3d '
                 'calls/step' % (e.key[:36], e.device_time_total / n / 1e3,
                                 e.count // n))


def _time_f32_head():
    """The LM head alone: forward and backward of the f32 ``(8192, 512) x
    (512, 32000)`` product with its bias, as the model runs it."""
    import torch
    x = torch.randn((LM_BATCH * LM_SEQ, LM_CFG['d_model']), device='cuda',
                    requires_grad=True)
    w = torch.randn((LM_CFG['d_model'], LM_CFG['vocab_size']), device='cuda',
                    requires_grad=True)
    bias = torch.zeros(LM_CFG['vocab_size'], device='cuda',
                       requires_grad=True)
    g = torch.randn((LM_BATCH * LM_SEQ, LM_CFG['vocab_size']), device='cuda')

    def run():
        out = x @ w + bias
        torch.autograd.grad(out, (x, w, bias), g)

    ms = time_ms(run, iters=5, warmup=2)
    flops = 3 * 2 * x.shape[0] * x.shape[1] * w.shape[1]
    _say('lm', 'the f32 head alone, forward + backward at %s x %s: %.3f ms '
         '(%.1f TFLOP/s of f32; allow_tf32 %s)' % (
             tuple(x.shape), tuple(w.shape), ms, flops / ms / 1e9,
             torch.backends.cuda.matmul.allow_tf32))


def phase_lm_main():
    """The LM training main path at full width and depth: the entry
    points of the repo's transformer benchmark on one fixed batch."""
    import numpy as np
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, ops, training
    comm = cmt.create_communicator('xla')
    try:
        model = models.TransformerLM(
            **LM_CFG, generator=torch.Generator().manual_seed(0))
        n_params = sum(p.numel() for p in model.parameters())
        opt = cmt.create_multi_node_optimizer(
            torch.optim.Adam(model.parameters(), lr=1e-3), comm)
        rng = np.random.RandomState(0)
        toks = rng.randint(0, LM_CFG['vocab_size'],
                           (LM_BATCH, LM_SEQ)).astype(np.int32)
        tgts = rng.randint(0, LM_CFG['vocab_size'],
                           (LM_BATCH, LM_SEQ)).astype(np.int32)
        data = [(toks[i], tgts[i]) for i in range(LM_BATCH)]
        updater = training.StandardUpdater(
            training.SerialIterator(data, LM_BATCH, shuffle=False), opt,
            models.lm_loss(model), model, comm)
        # one broadcast call (no step), then LM_STEPS steps
        trainer = training.Trainer(updater, (LM_STEPS + 1, 'iteration'),
                                   out=None)
        marks, losses = [], []

        def record(tr):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            losses.append(tr.observation['loss'])

        trainer.extend(record, trigger=(1, 'iteration'))
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        trainer.run()
        torch.cuda.synchronize()
        counts, tc = ops.launch_counts(), ops.tc_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        profile_lm(updater)
    finally:
        comm.close()
    layers, calls = LM_CFG['n_layers'], LM_STEPS + 1
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=(2 * layers + 1) * calls,
                flash_fwd=layers * calls, flash_bwd_dq=layers * calls,
                flash_bwd_dkv=layers * calls, cross_entropy=calls)
    if counts != want:
        raise AssertionError('launch counts %s, expected %s' % (counts,
                                                                want))
    counts = with_tc('LM training', counts, tc)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('non-finite loss: %s' % losses)
    # the first call broadcasts instead of stepping: the same batch and
    # the same weights give the same loss at calls 0 and 1
    if abs(losses[0] - losses[1]) > 1e-4 * abs(losses[0]):
        raise AssertionError('loss at call 0 %r != call 1 %r'
                             % (losses[0], losses[1]))
    if not losses[-1] < losses[1]:
        raise AssertionError('the loss did not fall: %s' % losses)
    steps = [b - a for a, b in zip([t0] + marks[:-1], marks)]
    timed = sorted(steps[3:])            # the broadcast call + 2 warm-ups
    p50 = timed[len(timed) // 2]
    worst = timed[-1]
    tokens = LM_BATCH * LM_SEQ
    _say('lm', 'TransformerLM %d parameters, bf16 compute, f32 masters, '
         'Adam 1e-3, %d x %d tokens a step; allow_tf32 %s' % (
             n_params, LM_BATCH, LM_SEQ,
             torch.backends.cuda.matmul.allow_tf32))
    _say('lm', 'losses %s' % ', '.join('%.4f' % v for v in losses))
    _say('lm', 'launches %s over 1 broadcast call + %d steps (per call: %d '
         'layer_norm, %d flash_fwd, %d flash_bwd_dq, %d flash_bwd_dkv, 1 '
         'cross_entropy)' % (counts, LM_STEPS, 2 * layers + 1, layers,
                             layers, layers))
    _say('lm', 'step times ms %s; p50 of steps 3..%d %.2f ms (max of these '
         '%d steps %.2f ms) = %.1f tokens/s at %d tokens a step; peak memory '
         '%.2f GiB' % (
             ', '.join('%.1f' % (1e3 * s) for s in steps), LM_STEPS,
             1e3 * p50, len(timed), 1e3 * worst, tokens / p50, tokens,
             peak / 2 ** 30))
    _time_f32_head()
    return counts


def _timed(phase, *args):
    """Run one phase and log its wall time."""
    t0 = time.perf_counter()
    out = phase(*args)
    _say('time', '%s %.1f s' % (phase.__name__, time.perf_counter() - t0))
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device is available', file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chainermn_tpu_torch  # noqa: F401  (fails alone, as it should)
    t_start = time.perf_counter()
    name, smi = phase_device()
    _timed(phase_build)
    records = (_timed(phase_kernels) + _timed(phase_serving_kernels)
               + _timed(phase_training_kernels))
    _timed(phase_model_check)
    _timed(phase_communicators)
    paths = {'resnet_training': _timed(phase_main_path)}
    paths['mnist_training'] = _timed(phase_mnist)
    paths['imagenet_training'] = _timed(phase_imagenet)
    paths['googlenetbn_training'], paths['imagenet_zoo'] = _timed(phase_zoo)
    paths['mnist_model_parallel'] = _timed(phase_model_parallel)
    paths['seq2seq_training'] = _timed(phase_seq2seq)
    _timed(phase_serving_check)
    paths['lm_serving'], model, prompts, slot_outs = _timed(
        phase_serving_main)
    _timed(phase_paged_check)
    paths['lm_serving_paged'], paged_outs = _timed(
        phase_paged_main, model, prompts, slot_outs)
    paths['lm_serving_spec'] = _timed(phase_spec_main, model, prompts,
                                      paged_outs)
    del model
    _timed(phase_lm_check)
    paths['lm_training'] = _timed(phase_lm_main)
    _say('time', 'all phases %.1f s' % (time.perf_counter() - t_start))
    for rec in records:
        by_path = {path: counts[rec['name']]
                   for path, counts in paths.items() if counts[rec['name']]}
        if not by_path:
            raise AssertionError('no main path launched %s' % rec['name'])
        rec['launches'] = sum(by_path.values())
        rec['launches_by_path'] = by_path
        tc_key = rec['name'] + '.tc'
        if any(tc_key in counts for counts in paths.values()):
            rec['tc_launches'] = sum(counts.get(tc_key, 0)
                                     for counts in paths.values())
    print(json.dumps({'kernels': records}))
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
