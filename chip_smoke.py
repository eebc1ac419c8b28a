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
   kernel / plain / library times and the bound; the three BN kernels'
   float16 instantiations at ``F16_SHAPES`` (ResNet-50's stage-1 exit +
   residual + relu, GoogLeNet-BN's ``(3136, 352)`` + relu) held the same
   way (the whole forward within ``F16_TOL``), timed, and recorded as
   ``bn_stats_f16``, ``bn_apply_f16`` and ``bn_backward_f16``;
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
5f. the training step's precision and loop knobs (``precision``), on
   ResNet-50 ``fused_norm=True`` at batch 64, 224 px: (a)
   ``Policy.bf16()`` + ``remat=True`` + ``Trainer(async_metrics=True)``
   for 10 steps (finite losses, step 0 equal to step 1, two
   ``bn_stats`` and ``bn_apply`` launches an interlude a step for the
   forward and its recompute, one ``bn_backward``), against the same
   with sync metrics and without remat: the running statistics after 2
   steps within ``STATS_TOL`` of the run without remat, the peak memory,
   images/s in windows of ``WINDOW_STEPS`` steps taken in turns (async,
   sync, sync, async; remat, none, none, remat), the busy share and
   device ms of each over 3 profiled steps; (b)
   ``Policy.f16()`` on a ResNet-50 built in f16 for ``F16_STEPS`` steps
   on the f16 BN kernels, ``loss_scale`` and ``grads_finite`` each step,
   a batch with an inf at ``F16_INF_STEP`` backed off and skipped with
   every parameter and optimizer-state tensor bit-equal across it and the
   BN buffers taking its statistics (as the JAX updater keeps them),
   timed in turns against (a) without remat; (c) ``accum_steps=2``
   against 1 on the same batch, the losses of steps 0 and 1 within
   ``ACCUM_RTOL``, launch counts, peak memory, times in turns;
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
   over 3 profiled steps, and its log and snapshots; then the example
   under ``--policy bf16`` held to the gate's bar (validation accuracy
   at least 0.95), its master weights f32;
5b. the ImageNet main path (``imagenet``): the twin of
   ``examples/imagenet/train_imagenet.py`` (``train_imagenet.main``) with
   ``--communicator hierarchical --arch resnet50 --batchsize 64 --epoch
   1`` at insize 224 on the synthetic 1280 / 128 set: the
   ``distributed_sgd_schedule`` rate on ``FusedMomentumSGD``,
   ``Trainer(async_metrics=True)`` as in the JAX script, a
   ``MultiprocessIterator`` under the updater's ``device_prefetch``
   (pinned batches, checked), the multi-node evaluator, a snapshot;
   ``momentum_sgd`` once an update after the broadcast call and no other
   kernel, finite losses, images/s from the p50 of the synchronized
   ``update()`` calls and over the whole window, the device busy share
   over 3 profiled steps, peak memory;
5g. the training input side (``input``, after 5b): the port's native host
   core (``chainermn_tpu_torch/csrc/chainermn_core.cpp``) built with
   ``g++`` from the checkout, ``augment_batch`` bit-equal to
   ``_augment_ref`` on 64 samples of 256 x 256 x 3 cropped to 224 (a
   float32 and a uint8 store, with and without a mean), both timed;
   ``bench.py --loader``'s A/B on ResNet-50 ``fused_norm=True`` (224 px,
   bf16, batch 64): 2 + 24 steps fed one resident batch, then 2 + 24
   fed by ``StreamingLoader`` over 192 examples in 2 record shards (2
   decode workers, 2 batches read ahead) -> ``DevicePrefetchIterator``
   (depth 2) -> ``update_core``: images/s, ``loader_efficiency``, the
   device busy share of each, the streamed run's launch counts (path
   ``resnet_streamed``: one ``bn_stats``, ``bn_apply`` and
   ``bn_backward`` per interlude a step and one SGD launch a step,
   checked); a fenced streamed window whose ``host_batch_prep`` / ``h2d``
   spans are held against its ``jitted_step`` spans
   (``h2d_overlap_fraction``), the queue-depth p50, the workers' busy
   fraction, ``corrupt_skipped`` 0; one epoch over a copy of the shards
   with one flipped byte (``corrupt_skipped`` 1, the epoch ends); the
   ImageNet twin under ``--pipeline native`` (path ``imagenet_native``:
   one SGD launch an update after the broadcast, no other kernel) beside
   5b's numbers; ``resnet50_s2d`` on ``convert_stem_variables`` of the
   standard model, its eval forward (224 px, batch 64, f32, TF32 off)
   within ``BF16_TOL`` of the standard stem's, then 6 bf16 training
   steps of each (after 2, in turns), step p50 against p50;
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
   slots, 64 prompts of 4..128 tokens, 32 new tokens each, on one CUDA
   graph per bucket (the default ``aot=True``: the serving engines of
   phases 6-7e all replay graphs), with the launch counts
   checked against the structure, tokens/s, TTFT, the decode step, a
   profile of decode steps, a replay of the same requests with every
   call's logits checked finite, and an int8-KV engine.  A replay counts
   nothing in the wrappers: a graphed path's launches are its replays
   times the counts recorded at each capture (``_path_counts``; no
   wrapper may count an eager launch in the window), and a profiled
   drain of 8 requests holds the LayerNorm, flash forward and decode
   kernels of its trace to that figure (``_hold_trace``; phases 7, 7b,
   7c, 7e and 7f);
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
7d. the request-serving path (``serve_infer``): ``batch_norm_act_inference``
   (one ``bn_apply`` launch) at ResNet-50's stage-1 exit of bucket 32
   against ``_apply_ref`` (``BF16_TOL``; whether bit-equal is printed);
   then full-width ResNet-50 (224 px, ``fused_norm=True``, the zoo's own
   seeded init but ``BRANCH_SCALE`` for the BatchNorm scales it starts at
   zero, running statistics from one seeded batch, eval) through
   ``InferenceEngine.for_model(max_batch=32)`` under ``Policy.bf16()`` and
   ``Int8Policy.bf16()``: every int8 weight within half a step of its f32
   weight, every bucket captured as a CUDA graph (53 ``bn_apply``
   launches recorded in each), each bucket's replay bit-equal to an
   eager forward of the same engine in bf16, the 53 interludes of one
   more eager forward of each engine at each bucket (from 49 rows at
   bucket 1) held against ``_apply_ref`` on their own inputs
   (``BF16_TOL``), the int8 logits within ``INT8_TOL`` of the bf16
   engine's, one replay's time against one eager forward's per bucket,
   weights and peak memory; bench.py's capacity probe, then ``open_loop``
   at twice it over ``RequestQueue(32, 0.005, 128)`` with
   ``SERVE_INFER_REQUESTS`` requests (no eager launch in the window),
   served req/s, latency p50/p99, the shed fraction, pad waste and the
   device's busy share; a second window under ``torch.profiler``, whose
   trace's ``bn_apply`` kernels are the path's launches (they must equal
   the replays times the captured launches, and a trace without them
   fails the phase); then the int8 branch check on a ResNet-50 whose
   residual branches reach the logits (``BRANCH_SCALE``): the int8
   engine's replays bit-equal to a bf16 engine over its own dequantized
   weights at buckets 1 and 32, their interludes held, the quantization's
   own error printed; and on that model's bf16 engine a hot swap to a
   perturbed tree (the replay equal to an engine built on that tree, no
   new capture) and a NaN tree refused;
7e. the serving LM under ``open_loop_generate`` (``serve_loadgen``) with
   ``GenerationEngine.run()`` on its thread: bench.py's capacity probe (2
   x 32 requests at once), then ``SERVE_GEN_REQUESTS`` at twice that
   capacity in slot and in paged mode, and an ``Int8Policy.bf16()`` run
   of the probe's requests; launch counts checked, tokens/s, TTFT,
   inter-token and decode-step p50/p99, and how many greedy streams of
   the int8 engine equal the bf16 engine's; a profiled window of 16
   requests holds its traced kernels;
7f. the generation graphs (``serve_graphs``): the serving LM in six
   modes (slot; paged with prefix sharing, the shared-prefix set too;
   ``prefill_chunk=32``; speculative with the 3-layer draft, paged;
   ``Int8Policy.bf16()`` weights; ``int8_kv``), each on an engine with
   ``aot=True`` and one with ``aot=False`` over the same 64 prompts:
   every bucket captured, every stream identical, the first logits of
   each call shape and every call's logits on the idle engines
   (each bucket of each family) bit-equal, traced launches equal to
   replays times the captured counts; eager against graphed tokens/s,
   decode-step p50/p99, TTFT p50, the busy share of a full-bucket decode
   tick, captures, their seconds and the engine's memory;
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
    structure, tokens/s, step times, peak memory and a profile;
11. the LM's parallel axes (``lm_parallel``): rows 4-8 against their
    plain versions at the path's shapes (LayerNorm ``(8192, 512)`` bf16,
    the flash forward, dq and dk/dv at ``(1, 8192, 8, 64)`` bf16 causal,
    the cross-entropy at ``(8192, 32000)`` f32), timed beside
    ``F.layer_norm``, SDPA and ``F.cross_entropy`` (each row's
    ``other_shapes['lm_parallel']``); the ``train_lm`` twin at full
    width (``TransformerLM()``'s widths, bf16, AdamW) with ``--seq-len
    8192 --batchsize 1 --mesh 1x1 --bind-sp`` for 10 steps under
    Ulysses (path ``lm_parallel_ulysses``) and under the ring
    (``lm_parallel_ring``): launch counts checked, tokens/s at the step
    p50, peak memory, the busy share and the kernels of a profiled step
    held to the wrappers' counts; then the tensor-parallel ``TransformerLM`` on
    ``MeshPlan.create(tp=2)``'s degraded ``(1, 1)`` through
    ``StandardUpdater(plan.communicator())`` with ``zero=False`` and
    ``zero=True``, 4 calls each, bit-equal (``lm_parallel_tp``).  One
    card holds no second NCCL rank: the all_to_all, the ring's permute
    and the sub-groups run over axes of one process here;
12. the LM pipeline (``lm_pipeline``): rows 4-8 at the micro-batch
    shapes, ``MeshPipelineUpdater`` on ``MeshPlan.create(tp=1, pp=2)``'s
    degraded ``(1, 1, 1)`` under gpipe, gpipe with ``remat`` and 1F1B
    (paths ``lm_pipeline_*``), one step held against 1F1B and the
    unpipelined step, the twins;
13. expert parallelism (``moe``): hold A (``sort_dispatch`` bit-equal
    to ``dense_dispatch_reference`` at ``(8192, 512)`` f32 with drops),
    LayerNorm with the policy's bf16 gamma against its plain version
    (``other_shapes['moe']``), hold B (one f32 ``moe_transformer_block``
    card vs CPU at batch 2, rtol 1e-4 / atol 1e-5, routes compared), then
    six blocks at the LM path's widths with 8 experts of d_ff 2048 on
    ``MeshPlan.create(ep=8)``'s degraded ``(1, 1)`` trained with k = 1
    and 2 (paths ``moe_k1``, ``moe_k2``; ``Policy.bf16()``, AdamW): step
    p50, tokens/s, peak memory, busy share of a profiled step (its
    kernels held to the wrappers' counts), dropped fraction, launches;
14. trust ratios under ZeRO (``zero_trust``) on ``MeshPlan.create(
    slices=2)``'s degraded ``(1, 1, 1)``: ResNet-50 with ``zero.lars``
    (path ``resnet_lars``) and the LM with ``zero.lamb`` (``lm_lamb``)
    under ``StandardUpdater(zero=True, policy=Policy.bf16())``, step p50
    and rates, peak memory, launches; the LM's snapshot after step 5
    resumed through ``resume_updater(elastic=True)`` into a fresh
    updater, the following steps bit-equal to the straight run;
15. fault-tolerant training (``supervised``): phase 10's LM training path
    (full width, 8 x 1024 tokens a step, Adam) as the custom worker of
    ``training.supervisor.Supervisor(nprocs=1)`` (this script re-invoked
    with ``--supervised-worker``: ``worker_main``, a heartbeat into
    ``$CMN_SUP_LIVE``, ``PreemptionHandler`` with asynchronous writes,
    ``auto_resume``, NCCL in a world of one), 8 calls under (a) no fault,
    (b) ``sigterm_step=@3``, (c) ``kill_step=@5`` with a checkpoint every
    2 steps, (d) ``hang_step=@4``: each supervisor exits 0, the ledger
    holds the failure's cause (``preempted``; ``killed`` at ``kill_step``
    with the doctor agreeing; ``hang`` escalated SIGTERM -> SIGKILL), a
    restart and the recovery at iteration 4, and every loss and the final
    parameters' digest of (b)-(d) are bit-equal to (a)'s; the workers'
    launch counts (written after every call, so a killed attempt leaves
    them) are held per call and become the paths ``supervised_a`` ..
    ``supervised_d``; it prints each MTTR, the goodput share
    (``telemetry.goodput``), the start-up to the first step and its
    split, the snapshot size, and in this process the step p50 with no
    checkpoint, a synchronous one every step and an asynchronous one
    every step.
16. the replica fleet (``fleet``, ``serving/fleet.py``): the serving LM at
    full width with snapshots written by ``fleet.demo_train`` on the card;
    two in-process ``Policy.bf16()`` replicas (8 slots, prompts 4..128,
    32 new tokens) under open-loop traffic: (b) a ``serve_slow=*:0.12``
    canary breaches on the inter-token delta and rolls back, (a) at half
    of one replica's probed capacity a healthy roll promotes with nothing
    shed, captures flat and each replica equal to a fresh engine from the
    new snapshot; the SLO monitors' readings by (replica, version) and
    their cost; (c) in f32 with the journal and the ``ReplicaSupervisor``
    a replica holding >= 4 pinned streams is killed mid-decode in slab,
    paged-prefix and speculative modes (then slab in bf16): every f32
    stream equals the uninterrupted engine's, nothing is lost, and the
    respawn captures its graphs while the survivor serves; (d) the CLI
    with two replica processes promotes a roll, dies to ``swap_kill`` in
    the next and converges on restart; paths ``fleet_roll``,
    ``fleet_breach`` and ``fleet_kill_*``.

A kernel row's ``ms``, ``plain_ms`` and ``library_ms`` are times per
call between CUDA events, launches included; ``device_ms``,
``plain_device_ms`` and ``library_device_ms`` sum only the kernels'
own device time from ``torch.profiler``, and are null when the tracer
recorded no device event in any of its tries (the script does not fail
for a lost trace: every check and every time of the contract comes from
the kernels' results and from CUDA events).

The ``bn_apply`` row's ``inference_*`` keys are phase 7d's reading of
the inference call, warm (its three operands stay in the 50 MB L2
between launches) and cold (``inference_cold_*``: the L2 flushed by a
128 MiB write before each launch, outside the timed span; the share of
the bound is taken from the cold device time).  No PyTorch call
computes the ``bn_apply`` row's case (+ residual, + relu), so its
``library_ms`` is null.
``F.batch_norm(training=False)`` on the same statistics computes the
kernel's no-residual, no-relu case:
the ``no_residual_*`` keys time the kernel and that call in that case,
with ``no_residual_bound_ms`` its bound.  Likewise the ``bn_backward``
row (ResNet-50's + residual + relu; GoogLeNet-BN's + relu) has a null
``library_ms``, and its ``no_relu_*`` keys time the kernel and
``aten.native_batch_norm_backward`` without relu and residual.  It
replaces no Pallas kernel: ``replaces`` names the reference's ``jnp``
backward.

A kernel row's ``launches`` sums the main paths that run it
(``launches_by_path`` splits them); each path is driven with the counts
set to 0 just before it and read just after; a graphed serving path's
launches are its replays times the launches recorded at capture.  The
rows of the kernels with a tensor-core route (bf16 ``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv``) add ``tc_launches``: every
launch of theirs on a main path took it (each path asserts so), their
times are the tensor-core
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
# (rtol, atol) of an f16 BN output against its plain version on its own
# statistics: f32 math rounded once to f16, so at most one rounding flip,
# one unit in the last place: at most 2 ** -10 of the value
F16_TOL = (2 ** -10, 1e-5)
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


# bytes written between launches by ``cold_times``: more than the
# H100's 50 MB L2, so that a launch finds its operands in HBM
L2_FLUSH_BYTES = 128 * 2 ** 20


def cold_times(fn, event, iters=20):
    """``fn`` with the L2 flushed before each launch (a write of
    ``L2_FLUSH_BYTES`` outside the timed span): the mean ms between CUDA
    events around each call, and the mean device ms of the kernels whose
    name matches ``event`` in a profiled run of the same loop (None when
    every trace came back empty)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    flush = torch.empty(L2_FLUSH_BYTES // 4, device='cuda')
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for _ in range(3):
        flush.fill_(0.0)
        fn()
    total = 0.0
    for i in range(iters):
        flush.fill_(float(i))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    device = None
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for i in range(iters):
                flush.fill_(float(i))
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and re.search(event, e.key))
        if us > 0:
            device = us / iters / 1e3
            break
        _say('profile', 'a trace held no device event')
    return total / iters, device


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
    # one bf16 rounding may flip, one part in 2**8; one f16 rounding, at
    # most 2**-10 of the value (F16_TOL)
    full, _, _ = ops.batch_norm_act(x, scale, bias, residual=res, relu=relu)
    ref = bn._apply_ref(x, pmean, prstd, scale, bias, res, relu)
    tol = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 2e-2),
           torch.float16: F16_TOL}[dtype]
    check_close('batch_norm_act %s' % ((m, c),), full, ref, *tol)
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


# the float16 instantiations' cases, (rows, channels, residual), relu in
# both: ResNet-50's stage-1 exit (the bf16 rows' timed case) and
# GoogLeNet-BN's last stage
F16_SHAPES = ((BATCH * 56 * 56, 256, True), (BATCH * 7 * 7, 352, False))


def _f16_bn_records(gen):
    """The three BN kernels on float16 activations at ``F16_SHAPES``: the
    statistics within ``STATS_TOL`` of their plain version and bit-equal
    across two runs, ``bn_apply`` bit-equal to its plain version, the
    whole forward within ``F16_TOL`` of the plain forward
    (:func:`_bn_case`); the backward's elementwise pass bit-equal to
    ``_bwd_apply_ref`` on the kernel's sums and its sums held to f64
    (:func:`_bwd_case`); each timed against its plain version and its
    bytes bound.  Returns the three records (``bn_stats_f16``,
    ``bn_apply_f16``, ``bn_backward_f16``): the first shape's times, the
    second's under ``googlenetbn_shapes``."""
    import torch
    from chainermn_tpu_torch import ops
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    source = 'chainermn_tpu_torch/csrc/batch_norm_act.cu'
    rows = {'bn_stats_f16': [], 'bn_apply_f16': [], 'bn_backward_f16': []}
    errs = dict.fromkeys(rows, 0.0)
    for m, c, residual in F16_SHAPES:
        x, res, scale, bias, se, ae = _bn_case(gen, m, c, torch.float16,
                                               residual, True)
        mean, _, rstd = ops.bn_stats(x, 1e-5)
        t = timings(lambda: ops.bn_stats(x, 1e-5),
                    lambda: bn._batch_stats(x, 1e-5),
                    lambda: torch.var_mean(x, 0, correction=0), iters=10)
        b_ms, b_by = bound_ms(m * c * 2 + 3 * c * 4, 3 * m * c)
        rows['bn_stats_f16'].append(dict(shape=[m, c], max_abs_err=se,
                                         bound_ms=b_ms, bound_by=b_by, **t))
        _say('kernels', 'bn_stats at %s f16: %s (var_mean); bound %.5f ms '
             'by %s' % ((m, c), _fmt(t), b_ms, b_by))
        t = timings(
            lambda: ops.bn_apply(x, res, mean, rstd, scale, bias, True),
            lambda: bn._apply_ref(x, mean, rstd, scale, bias, res, True),
            None, iters=10)
        b_ms, b_by = bound_ms((2 + residual) * m * c * 2 + 4 * c * 4,
                              5 * m * c)
        rows['bn_apply_f16'].append(dict(shape=[m, c], max_abs_err=ae,
                                         bound_ms=b_ms, bound_by=b_by, **t))
        _say('kernels', 'bn_apply at %s f16%s + relu: %s; bound %.5f ms by '
             '%s' % ((m, c), ' + residual' if residual else '', _fmt(t),
                     b_ms, b_by))
        args, r = _bwd_case(gen, m, c, 'float16', residual, True)
        t = _bwd_timings(args)
        rows['bn_backward_f16'].append(dict(shape=[m, c], **r, **t))
        _say_bwd('%s f16%s + relu' % ((m, c), ' + residual' if residual
                                     else ''), t)
        for name, err in zip(rows, (se, ae, r['max_abs_err'])):
            errs[name] = max(errs[name], err)
    replaces = {'bn_stats_f16': 'chainermn_tpu/ops/batch_norm_act.py:110',
                'bn_apply_f16': 'chainermn_tpu/ops/batch_norm_act.py:161',
                'bn_backward_f16': 'chainermn_tpu/ops/batch_norm_act.py:221'}
    return [dict(first, name=name, route='cuda', source=source,
                 replaces=replaces[name], dtype='float16',
                 max_abs_err=errs[name], googlenetbn_shapes=[gbn])
            for name, (first, gbn) in rows.items()]


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
    f16_records = _f16_bn_records(gen)

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
    return records + f16_records


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


# the precision phase: ResNet-50 fused_norm=True at batch 64, 224 px
F16_STEPS = 6                  # part (b)
F16_INF_STEP = 3               # part (b)'s step fed a batch with an inf
ACCUM_STEPS = 3                # part (c): steps of each run
# part (c): the loss of accum_steps=2 against accum_steps=1 at steps 0
# and 1 (the same weights: step 0 broadcasts), within the bf16 tolerance
# of the port's parity tests: the micro-batches normalize with their own
# batch statistics.  After a step the two take different updates
ACCUM_RTOL = 5e-2


def _precision_batch():
    """Phase 5's synthetic ImageNet batch (64 images, 224 px, labels)."""
    from chainermn_tpu_torch.datasets import imagenet
    raw, _ = imagenet.get_imagenet(BATCH, 8, size=256)
    mean = imagenet.compute_mean(raw, limit=BATCH)
    train = imagenet.PreprocessedDataset(raw, mean, 224, random=False)
    return [train[i] for i in range(len(train))]


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _device(step, n=3):
    """``(busy share, device ms a call)`` over ``n`` calls of ``step``
    under the profiler (``(None, None)`` when no trace held a device
    event)."""
    _, kernels, wall_us = profiled(step, n)
    busy = sum(kernels.values())
    return (busy / wall_us, busy / n / 1e3) if busy else (None, None)


# part (a)'s timed windows: steps a window, windows a side (in turns)
WINDOW_STEPS = 8


def _window(updater, sync):
    """Seconds a step over ``WINDOW_STEPS`` steps issued as the trainer
    issues them (``update(sync=False)`` under async metrics),
    synchronized before and after."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(WINDOW_STEPS):
        updater.update(sync=sync)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / WINDOW_STEPS


def _in_turns(a, b):
    """``a``, ``b``, ``b``, ``a`` (each a callable returning a time):
    the two sides' times, in that order."""
    ta1, tb1, tb2, ta2 = a(), b(), b(), a()
    return (ta1, ta2), (tb1, tb2)


def _resnet_run(comm, train, policy, steps, dtype=None, remat=False,
                async_metrics=False, accum=1):
    """ResNet-50 ``fused_norm=True`` (seeded weights) trained ``steps``
    steps on ``train`` through ``StandardUpdater(policy=, remat=,
    accum_steps=)`` and ``Trainer(async_metrics=)``; returns the losses
    (floats, read after the run), the launch counts, the peak memory of
    the run (above what was allocated before its model was built: the
    updaters kept for the timed windows), the BN buffers after step 2 and
    the updater."""
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, ops, training
    _free()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = models.ResNet50(fused_norm=True, **(
        {} if dtype is None else {'dtype': dtype}))
    clf = models.StatefulClassifier(model)
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
    updater = training.StandardUpdater(
        training.SerialIterator(train, BATCH, shuffle=False), opt,
        clf.loss, model, comm, policy=policy, remat=remat,
        accum_steps=accum)
    trainer = training.Trainer(updater, (steps, 'iteration'), out=None,
                               async_metrics=async_metrics)
    losses, stats = [], []

    def record(tr):
        losses.append(tr.observation['loss'])
        if tr.updater.iteration == 2:
            stats.extend(b.detach().clone() for b in model.buffers())

    trainer.extend(record, trigger=(1, 'iteration'))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    trainer.run()
    torch.cuda.synchronize()
    return dict(losses=[float(v) for v in losses],
                counts=ops.launch_counts(),
                peak=torch.cuda.max_memory_allocated() - base, stats=stats,
                updater=updater)


def _want(forwards, backwards, sgd):
    """Launch counts of a ResNet-50 run of ``forwards`` forward passes
    (a recompute is one) and ``backwards`` backward passes: one stats and
    one apply launch an interlude a forward, one backward launch an
    interlude a backward; ``sgd`` momentum SGD launches."""
    from chainermn_tpu_torch import ops
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(bn_stats=BN_PER_STEP * forwards,
                bn_apply=BN_PER_STEP * forwards,
                bn_backward=BN_PER_STEP * backwards, momentum_sgd=sgd)
    return want


def _check_counts(what, counts, want):
    if counts != want:
        raise AssertionError('%s: launch counts %s, expected %s'
                             % (what, counts, want))


def _f16_state(updater):
    """Every parameter and optimizer-state tensor of a run, and its BN
    buffers apart, cloned (for a bit-for-bit comparison)."""
    opt = updater.optimizer.actual_optimizer
    model = updater.model
    out = [t.detach().clone() for t in model.parameters()]
    out += [v.detach().clone() for p in model.parameters()
            for v in opt.state.get(p, {}).values() if hasattr(v, 'clone')]
    return out, [t.detach().clone() for t in model.buffers()]


def _precision_f16(comm, train):
    """Part (b): ``Policy.f16()`` on ResNet-50 ``fused_norm=True`` built in
    f16, ``F16_STEPS`` steps through ``update_core``; step
    ``F16_INF_STEP`` gets a batch with an inf and must be skipped, every
    parameter and optimizer-state tensor bit-equal across it, the BN
    buffers taking the step's statistics (the JAX updater keeps its
    ``new_state`` on a skipped step).
    Returns the launch counts, the per-step metrics and the updater."""
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, ops, training
    from chainermn_tpu_torch.precision import Policy
    model = models.ResNet50(fused_norm=True, dtype=torch.float16)
    clf = models.StatefulClassifier(model)
    opt = cmt.create_multi_node_optimizer(
        ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
    updater = training.StandardUpdater(
        training.SerialIterator(train, BATCH, shuffle=False), opt, clf.loss,
        model, comm, policy=Policy.f16())
    good = updater.shard_batch(train[:BATCH])
    if good[0].dtype != torch.float16:
        raise AssertionError('f16: the batch arrived as %s' % good[0].dtype)
    bad = (good[0].clone(), good[1])
    bad[0][0, 0, 0, 0] = float('inf')
    dtypes = set()
    handles = [m.register_forward_pre_hook(
        lambda mod, args: dtypes.add(args[0].dtype))
        for m in model.modules() if isinstance(m, models.NormAct)]
    _free()
    ops.reset_launch_counts()
    metrics = []
    try:
        for i in range(F16_STEPS):
            before = _f16_state(updater) if i == F16_INF_STEP else None
            scale = float(updater.scale_state.scale)
            m = updater.update_core(bad if i == F16_INF_STEP else good)
            m = {k: float(v) for k, v in m.items()}
            metrics.append(m)
            _say('precision', 'f16 step %d%s: loss %.4f, loss_scale %g, '
                 'grads_finite %g -> scale %g' % (
                     i, ' (a batch with an inf)' if i == F16_INF_STEP
                     else '', m['loss'], m['loss_scale'], m['grads_finite'],
                     float(updater.scale_state.scale)))
            if m['loss_scale'] != scale:
                raise AssertionError('f16 step %d: loss_scale %r, the scale '
                                     'was %r' % (i, m['loss_scale'], scale))
            if before is None:
                continue
            after = _f16_state(updater)
            if m['grads_finite'] != 0.0 or float(
                    updater.scale_state.scale) != max(scale / 2, 1.0):
                raise AssertionError('f16: the inf batch was not backed '
                                     'off: %s' % m)
            if len(before[0]) != len(after[0]) or not all(
                    torch.equal(a, b) for a, b in zip(before[0], after[0])):
                raise AssertionError('f16: the skipped step changed a '
                                     'parameter or optimizer state tensor')
            if all(torch.equal(a, b) for a, b in zip(before[1], after[1])):
                raise AssertionError('f16: the skipped step kept no BN '
                                     'statistics')
            _say('precision', 'f16: the skipped step left all %d parameter '
                 'and optimizer-state tensors bit-equal; the %d BN buffers '
                 'took its statistics' % (len(after[0]), len(after[1])))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
    finally:
        for h in handles:
            h.remove()
    if dtypes != {torch.float16}:
        raise AssertionError('f16: the BN interludes saw %s' % dtypes)
    finite = [m['grads_finite'] == 1.0 for m in metrics]
    if sum(finite[:F16_INF_STEP] + finite[F16_INF_STEP + 1:]) == 0:
        raise AssertionError('f16: no finite step: %s' % metrics)
    if not all(math.isfinite(m['loss']) for m, f in zip(metrics, finite)
               if f):
        raise AssertionError('f16: a finite step with a non-finite loss: %s'
                             % metrics)
    # the first finite step broadcasts, each later one steps
    _check_counts('f16', counts, _want(F16_STEPS, F16_STEPS,
                                       max(0, sum(finite) - 1)))
    return counts, metrics, updater


def _say_turns(what, a, b, names):
    """Log two sides' windows (seconds a step) as images/s."""
    _say('precision', '%s, windows of %d steps in turns (%s, %s, %s, %s): '
         '%s %.2f / %.2f ms a step = %.1f / %.1f images/s; %s %.2f / %.2f '
         'ms = %.1f / %.1f images/s' % (
             what, WINDOW_STEPS, names[0], names[1], names[1], names[0],
             names[0], 1e3 * a[0], 1e3 * a[1], BATCH / a[0], BATCH / a[1],
             names[1], 1e3 * b[0], 1e3 * b[1], BATCH / b[0], BATCH / b[1]))


def phase_precision():
    """The training step's precision and loop knobs on ResNet-50
    ``fused_norm=True`` at full width: (a) ``Policy.bf16()`` +
    ``remat=True`` + ``Trainer(async_metrics=True)``, against the same
    with sync metrics and without remat; (b) ``Policy.f16()`` on the f16
    BN kernels with a forced backoff, timed against (a) without remat;
    (c) ``accum_steps=2`` against 1.  Times are windows of
    ``WINDOW_STEPS`` steps in turns (a, b, b, a) within this call, the
    device share and time from 3 profiled steps.  Returns the launch
    counts of each path."""
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch.precision import Policy
    train = _precision_batch()
    bf16 = Policy.bf16()
    gib = 2 ** 30
    comm = cmt.create_communicator('xla')
    try:
        # (a) remat + async metrics, and without remat (sync)
        remat = _resnet_run(comm, train, bf16, STEPS, remat=True,
                            async_metrics=True)
        plain = _resnet_run(comm, train, bf16, STEPS)
        _check_counts('bf16 remat + async', remat['counts'],
                      _want(2 * STEPS, STEPS, STEPS - 1))
        _check_counts('bf16 without remat', plain['counts'],
                      _want(STEPS, STEPS, STEPS - 1))
        for what, run in (('remat + async', remat),
                          ('without remat', plain)):
            losses = run['losses']
            if len(losses) != STEPS or not all(map(math.isfinite, losses)):
                raise AssertionError('bf16 %s: losses %s' % (what, losses))
            # the same batch at steps 0 and 1; step 0 broadcasts
            if abs(losses[0] - losses[1]) > 1e-3 * max(1.0, abs(losses[0])):
                raise AssertionError('bf16 %s: loss at step 0 %r != step 1 '
                                     '%r' % (what, losses[0], losses[1]))
        # the running statistics take one update a step under remat
        if len(remat['stats']) != len(plain['stats']) or not remat['stats']:
            raise AssertionError('precision: %d and %d buffers'
                                 % (len(remat['stats']), len(plain['stats'])))
        stats_err = 0.0
        for i, (a, b) in enumerate(zip(remat['stats'], plain['stats'])):
            check_close('running statistics %d after 2 steps, remat vs not'
                        % i, a, b, *STATS_TOL)
            stats_err = max(stats_err, max_err(a, b))
        _say('precision', 'bf16 + remat + async metrics: losses %s'
             % ', '.join('%.4f' % v for v in remat['losses']))
        _say('precision', 'launches a step under remat: %d bn_stats, %d '
             'bn_apply (forward and recompute), %d bn_backward; running '
             'statistics after 2 steps against remat=False: max abs err %.3g '
             '(STATS_TOL %s); peak memory %.3f GiB with remat, %.3f without'
             % (2 * BN_PER_STEP, 2 * BN_PER_STEP, BN_PER_STEP, stats_err,
                STATS_TOL, remat['peak'] / gib, plain['peak'] / gib))
        ru, pu = remat['updater'], plain['updater']
        asy, syn = _in_turns(lambda: _window(ru, False),
                             lambda: _window(ru, True))
        _say_turns('bf16 + remat, async against sync metrics', asy, syn,
                   ('async', 'sync'))
        rem, pla = _in_turns(lambda: _window(ru, True),
                             lambda: _window(pu, True))
        _say_turns('bf16, sync metrics, remat against none', rem, pla,
                   ('remat', 'no remat'))
        for what, step in (('remat, async metrics',
                            lambda: ru.update(sync=False)),
                           ('remat, sync metrics', ru.update),
                           ('no remat, sync metrics', pu.update)):
            busy, dev = _device(step)
            _say('precision', 'bf16 %s: device busy %s, device %s ms a step '
                 '(3 profiled steps)' % (
                     what, 'not measured' if busy is None
                     else '%.1f%%' % (100 * busy),
                     'not measured' if dev is None else '%.2f' % dev))
        del remat['updater'], ru
        # (b) f16 on the f16 BN kernels, timed against bf16 without remat
        f16_counts, metrics, fu = _precision_f16(comm, train)
        f16, b16 = _in_turns(lambda: _window(fu, True),
                             lambda: _window(pu, True))
        _say_turns('f16 (loss-scaled) against bf16, no remat, sync metrics',
                   f16, b16, ('f16', 'bf16'))
        busy, dev = _device(fu.update)
        _say('precision', 'f16: device busy %s, device %s ms a step (3 '
             'profiled steps)' % (
                 'not measured' if busy is None else '%.1f%%' % (100 * busy),
                 'not measured' if dev is None else '%.2f' % dev))
        del fu, pu, plain['updater']
        # (c) accum_steps=2 against 1 on the same batch
        one = _resnet_run(comm, train, bf16, ACCUM_STEPS)
        two = _resnet_run(comm, train, bf16, ACCUM_STEPS, accum=2)
        _check_counts('accum_steps=1', one['counts'],
                      _want(ACCUM_STEPS, ACCUM_STEPS, ACCUM_STEPS - 1))
        _check_counts('accum_steps=2', two['counts'],
                      _want(2 * ACCUM_STEPS, 2 * ACCUM_STEPS,
                            ACCUM_STEPS - 1))
        if not all(map(math.isfinite, two['losses'])):
            raise AssertionError('accum_steps=2: losses %s' % two['losses'])
        for i, (a, b) in enumerate(zip(two['losses'][:2],
                                       one['losses'][:2])):
            if abs(a - b) > ACCUM_RTOL * abs(b):
                raise AssertionError('accum_steps=2: loss %d %r vs %r'
                                     % (i, a, b))
        acc2, acc1 = _in_turns(lambda: _window(two['updater'], True),
                               lambda: _window(one['updater'], True))
        _say('precision', 'accum_steps=2 against 1 on the same batch: losses '
             '%s vs %s; peak memory %.3f vs %.3f GiB' % (
                 ', '.join('%.4f' % v for v in two['losses']),
                 ', '.join('%.4f' % v for v in one['losses']),
                 two['peak'] / gib, one['peak'] / gib))
        _say_turns('accum_steps=2 against 1, sync metrics', acc2, acc1,
                   ('accum 2', 'accum 1'))
        del one['updater'], two['updater']
    finally:
        comm.close()
    f16_path = dict(f16_counts)
    for name in ('bn_stats', 'bn_apply', 'bn_backward'):
        f16_path[name + '_f16'] = f16_path.pop(name)
    _free()
    return {'resnet_bf16_remat_async': remat['counts'],
            'resnet_bf16_policy': plain['counts'], 'resnet_f16': f16_path,
            'resnet_bf16_accum2': two['counts']}


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

    def timed(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        starts.append(t0)
        result = update(self, *args, **kw)
        torch.cuda.synchronize()
        update_ms.append(1e3 * (time.perf_counter() - t0))
        # a 0-d tensor under the twin's async_metrics: read after the
        # timed span
        losses.append(float(result['loss']))
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
    return counts, dict(p50_ips=IMAGENET_BATCH / (p50 / 1e3),
                        window_ips=IMAGENET_BATCH * iterations / window_s,
                        busy=busy, p50_ms=p50)


# the input phase (phase_input): the native augmentation at the twin's
# sizes (a batch of 64 samples of 256 x 256 x 3 cropped to 224) ...
AUG_SAMPLES = 64
AUG_SIZE = 256
AUG_CROP = 224
AUG_ITERS = 5                  # timed calls of each version
# ... bench.py --loader's streamed-against-resident A/B of ResNet-50 at
# batch 64: 192 examples in 2 record shards, 2 decode workers, 2 batches
# read ahead, a device prefetch of 2 ...
INPUT_EXAMPLES = 192
INPUT_SHARDS = 2
INPUT_WORKERS = 2
INPUT_PREFETCH = 2
INPUT_WARMUP = 2
INPUT_STEPS = 24
# ... and the space-to-depth stem's training steps
S2D_STEPS = 6


def _host_ms(fn, iters=AUG_ITERS):
    """Median host ms of ``iters`` calls of ``fn`` (host code: no card)."""
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def _input_augment():
    """The native library built from the checkout; ``augment_batch`` (a
    uint8 store staged to float32 first, as ``BatchAugmentPipeline``
    does) bit-equal to ``_augment_ref`` on 64 samples of 256 x 256 x 3
    cropped to 224, with and without a mean, for a float32 and a uint8
    store; both timed."""
    import numpy as np
    from chainermn_tpu_torch import native
    from chainermn_tpu_torch.datasets.imagenet import _augment_ref
    from chainermn_tpu_torch.ops._build import LIBRARIES
    path, build_s = LIBRARIES.build_host('chainermn_core')
    _say('input', 'g++ built %s in %.1f s; pool of %d threads (%d CPUs)'
         % (path.name, build_s, native.pool_threads(), os.cpu_count()))
    rng = np.random.RandomState(0)
    f32 = (rng.rand(AUG_SAMPLES, AUG_SIZE, AUG_SIZE, 3)
           * 255).astype(np.float32)
    stores = (('float32', f32), ('uint8', f32.astype(np.uint8)))
    mean = f32.mean(axis=0)
    b, room = AUG_SAMPLES, AUG_SIZE - AUG_CROP + 1
    idx = rng.permutation(b).astype(np.int64)
    tops = rng.randint(0, room, b).astype(np.int32)
    lefts = rng.randint(0, room, b).astype(np.int32)
    flips = (rng.rand(b) > 0.5).astype(np.uint8)
    out = {}
    for kind, store in stores:
        for m in (mean, None):
            def kernel(store=store, m=m):
                if store.dtype == np.float32:
                    src, src_idx = store, idx
                else:
                    src = store[idx].astype(np.float32)
                    src_idx = np.arange(b, dtype=np.int64)
                return native.augment_batch(src, src_idx, tops, lefts,
                                            flips, AUG_CROP, mean=m)

            def plain(store=store, m=m):
                return _augment_ref(store, idx, tops, lefts, flips,
                                    AUG_CROP, mean=m)

            got, want = kernel(), plain()
            if not np.array_equal(got.view(np.uint32),
                                  want.view(np.uint32)):
                raise AssertionError(
                    'augment_batch (%s store, mean %s) differs from '
                    '_augment_ref: max abs err %.3g' % (
                        kind, m is not None,
                        float(np.abs(got - want).max())))
            ms, plain_ms = _host_ms(kernel), _host_ms(plain)
            key = '%s%s' % (kind, '+mean' if m is not None else '')
            out[key] = (ms, plain_ms)
            _say('input', 'augment_batch, %s store, %s: bit-equal to '
                 '_augment_ref; %.3f ms a batch of %d (plain %.3f ms, '
                 '%.1fx)' % (kind, 'with mean' if m is not None
                             else 'no mean', ms, b, plain_ms, plain_ms / ms))
    return out


def _flip_record_byte(path, record):
    """Flip one payload byte of ``record`` in shard ``path``."""
    from chainermn_tpu_torch import data
    at = data.read_index(path)['offsets'][record] + 8 + 64
    with open(path, 'r+b') as f:
        f.seek(at)
        byte = f.read(1)
        f.seek(at)
        f.write(bytes([byte[0] ^ 0xFF]))


def _input_ab():
    """ResNet-50 (``fused_norm=True``, 224 px, batch 64, phase 5's set-up)
    fed the same way as ``bench.py --loader``: one resident batch on the
    card every step, then ``StreamingLoader`` over record shards ->
    ``DevicePrefetchIterator`` -> ``update_core``, each 2 + 24 steps; a
    fenced streamed window for the overlap of the input spans with the
    steps; one epoch over a copy of the shards with one flipped byte.
    Returns the streamed run's launch counts."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import data, models, ops, telemetry, training
    from chainermn_tpu_torch.telemetry.report import (
        load_rank_logs, overlap_from_intervals)
    comm = cmt.create_communicator('xla')
    work = tempfile.mkdtemp(prefix='input_phase_')
    loader = it = None
    try:
        rng = np.random.RandomState(7)
        x = rng.rand(INPUT_EXAMPLES, 224, 224, 3).astype(np.float32)
        y = rng.randint(0, 1000, INPUT_EXAMPLES).astype(np.int32)
        examples = [(x[i], y[i]) for i in range(INPUT_EXAMPLES)]
        t0 = time.perf_counter()
        paths = data.write_examples(examples, os.path.join(work, 'shards'),
                                    n_shards=INPUT_SHARDS)
        write_s = time.perf_counter() - t0
        model = models.ResNet50(fused_norm=True)
        clf = models.StatefulClassifier(model)
        opt = cmt.create_multi_node_optimizer(
            ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
        upd = training.StandardUpdater(iter(()), opt, clf.loss, model,
                                       comm)

        def run(next_batch, steps=INPUT_STEPS):
            for _ in range(INPUT_WARMUP):
                upd.update_core(next_batch())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(steps):
                upd.update_core(next_batch())
            torch.cuda.synchronize()
            return BATCH * steps / (time.perf_counter() - t0)

        def fenced(next_batch, name):
            """``run`` with telemetry on and fenced: (images/s, spans)."""
            tele = os.path.join(work, name)
            rec = telemetry.enable(tele, sync_fences=True)
            try:
                ips = run(next_batch)
                rec.flush()
            finally:
                telemetry.disable()
            return ips, load_rank_logs(tele)[1]

        resident = upd.shard_batch(examples[:BATCH])
        resident_ips = run(lambda: resident)
        resident_busy, _ = _device(lambda: upd.update_core(resident))
        fenced_res_ips, res_spans = fenced(lambda: resident, 'resident')
        loader = data.StreamingLoader(
            data.ShardSet(paths), BATCH, size=1, rank=0, seed=11,
            n_workers=INPUT_WORKERS, prefetch=INPUT_PREFETCH)
        it = training.DevicePrefetchIterator(loader, upd._place,
                                             depth=INPUT_PREFETCH,
                                             device=upd.device)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        streamed_ips = run(lambda: next(it))
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        streamed_busy, _ = _device(lambda: upd.update_core(next(it)))
        # the same stream again with fences on: spans cover the card's
        # work, so the input spans' overlap with the steps is measured
        fenced_ips, spans = fenced(lambda: next(it), 'streamed')
        input_iv = [(sp['t0'], sp['t1']) for sp in spans
                    if sp['name'] in ('host_batch_prep', 'h2d')]
        step_iv = [(sp['t0'], sp['t1']) for sp in spans
                   if sp['name'] == 'jitted_step']
        synced = sum(1 for sp in spans if sp.get('synced'))
        ov = overlap_from_intervals(input_iv, step_iv)
        it.finalize()
        it = None
        depth = sorted(loader.depth_samples)
        depth_p50 = depth[len(depth) // 2]
        busy_frac = loader.busy_fraction()
        skipped = loader.corrupt_skipped
        loader = None
        if skipped:
            raise AssertionError('corrupt_skipped %d on intact shards'
                                 % skipped)
        # one epoch over a copy with one flipped byte: skipped, counted,
        # and the epoch still ends
        bad = shutil.copytree(os.path.join(work, 'shards'),
                              os.path.join(work, 'corrupt'))
        bad_paths = sorted(os.path.join(bad, os.path.basename(p))
                           for p in paths)
        _flip_record_byte(bad_paths[1], 5)
        loader = data.StreamingLoader(bad_paths, BATCH, size=1, rank=0,
                                      seed=11, repeat=False,
                                      n_workers=INPUT_WORKERS,
                                      prefetch=INPUT_PREFETCH)
        it = training.DevicePrefetchIterator(loader, upd._place, depth=2,
                                             device=upd.device)
        rows = []
        for arrays in it:
            upd.update_core(arrays)
            rows.append(int(arrays[0].shape[0]))
        torch.cuda.synchronize()
        corrupt = loader.corrupt_skipped
        # the skipped example leaves one batch of its epoch a row short
        full = [BATCH] * (INPUT_EXAMPLES // BATCH)
        if corrupt != 1 or sorted(rows) != [BATCH - 1] + full[1:] \
                or loader.epoch != 1:
            raise AssertionError('corrupt epoch: %d skipped, batches %s, '
                                 'epoch %d' % (corrupt, rows, loader.epoch))
    finally:
        if it is not None:
            it.finalize()
        elif loader is not None:
            loader.finalize()
        comm.close()
        shutil.rmtree(work, ignore_errors=True)
    steps = INPUT_WARMUP + INPUT_STEPS
    want = _want(steps, steps, steps)   # phase 5's counts a step
    _check_counts('ResNet-50 streamed', counts, want)
    _say('input', 'ResNet-50 (fused_norm, 224 px, bf16, batch %d, %d + %d '
         'steps each): resident %.1f images/s, streamed %.1f images/s '
         '(%d examples, %d shards written in %.2f s; %d workers, %d '
         'batches read ahead, device prefetch %d), loader_efficiency '
         '%.4f; device busy %s resident, %s streamed (3 profiled steps)' % (
             BATCH, INPUT_WARMUP, INPUT_STEPS, resident_ips, streamed_ips,
             INPUT_EXAMPLES, INPUT_SHARDS, write_s, INPUT_WORKERS,
             INPUT_PREFETCH, INPUT_PREFETCH, streamed_ips / resident_ips,
             _pct(resident_busy), _pct(streamed_busy)))
    _say('input', 'fenced streamed window: %.1f images/s; '
         'h2d_overlap_fraction %s (%d input spans, %.1f ms of them, %.1f '
         'ms hidden behind %d jitted_step spans; %d spans fenced); '
         'data_queue_depth p50 %d; data_worker_busy_fraction %.4f; '
         'corrupt_skipped %d' % (
             fenced_ips, 'none' if ov['overlap_fraction'] is None
             else '%.4f' % ov['overlap_fraction'], len(input_iv),
             1e3 * ov['total_collective_s'],
             1e3 * ov['hidden_collective_s'], len(step_iv), synced,
             depth_p50, busy_frac, skipped))
    _say('input', 'span p50s, fenced (ms): resident %.1f images/s, '
         'jitted_step %s; streamed jitted_step %s, host_batch_prep %s, '
         'h2d %s, data_decode %s' % (
             fenced_res_ips, _span_p50(res_spans, 'jitted_step'),
             _span_p50(spans, 'jitted_step'),
             _span_p50(spans, 'host_batch_prep'), _span_p50(spans, 'h2d'),
             _span_p50(spans, 'data_decode')))
    _say('input', 'one flipped byte in a copy of the shards: one epoch of '
         'batches %s, corrupt_skipped %d, the epoch ended' % (rows,
                                                             corrupt))
    _say('input', 'resnet_streamed launches %s' % counts)
    return counts


def _span_p50(spans, name):
    """The p50 duration (ms, as text) of the spans called ``name``."""
    ms = sorted(1e3 * (sp['t1'] - sp['t0']) for sp in spans
                if sp['name'] == name)
    return '%.3f' % ms[len(ms) // 2] if ms else 'none'


def _pct(share):
    return 'not measured' if share is None else '%.1f%%' % (100 * share)


def _input_native_twin(thread):
    """The ImageNet twin under ``--pipeline native`` (phase 5b's run with
    ``BatchAugmentPipeline`` + ``PipelineIterator``), beside phase 5b's
    thread-pipeline numbers; returns its launch counts."""
    import shutil
    import tempfile
    from chainermn_tpu_torch import ops, training
    from chainermn_tpu_torch.datasets import imagenet
    from chainermn_tpu_torch.examples.imagenet import train_imagenet
    out = tempfile.mkdtemp(prefix='imagenet_native_')
    try:
        ops.reset_launch_counts()
        trainer, update_ms, losses, pinned, window_s = _imagenet_example(
            out, IMAGENET_ARGV + ['--pipeline', 'native'])
        counts = ops.launch_counts()
        iterations = trainer.updater.iteration
        inner = trainer.updater.iterator.inner
        try:
            busy = profile_steps(trainer.updater)
        finally:
            train_imagenet.close(trainer)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if not (isinstance(inner, training.PipelineIterator) and isinstance(
            inner.pipeline, imagenet.BatchAugmentPipeline)):
        raise AssertionError('--pipeline native fed %r' % (inner,))
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(momentum_sgd=iterations - 1)
    _check_counts('ImageNet twin, native pipeline', counts, want)
    if len(losses) != iterations or not all(math.isfinite(v)
                                            for v in losses):
        raise AssertionError('native twin: losses %s' % losses)
    if not pinned or not all(pinned):
        raise AssertionError('native twin: %d of %d batches pinned'
                             % (sum(pinned), len(pinned)))
    timed = sorted(update_ms[2:])
    p50 = timed[len(timed) // 2]
    _say('input', 'ImageNet twin (hierarchical, ResNet-50, 224 px, batch '
         '%d, 1 epoch of the synthetic 1280): --pipeline native %.1f '
         'images/s at the update() p50 (%.3f ms), %.1f images/s over the '
         'window, device busy %s; --pipeline thread in this run %.1f '
         'images/s at the p50 (%.3f ms), %.1f over the window, device '
         'busy %s; %d iterations, %d momentum_sgd launches and no other '
         'kernel; loss %.4f -> %.4f' % (
             IMAGENET_BATCH, IMAGENET_BATCH / (p50 / 1e3), p50,
             IMAGENET_BATCH * iterations / window_s, _pct(busy),
             thread['p50_ips'], thread['p50_ms'], thread['window_ips'],
             _pct(thread['busy']), iterations, counts['momentum_sgd'],
             losses[0], losses[-1]))
    return counts


def _s2d_models(dtype, fused_norm=True):
    """A standard-stem ResNet-50 (seeded) and ``resnet50_s2d`` on its
    weights through ``convert_stem_variables``, both in eval mode."""
    from chainermn_tpu_torch import models
    std = models.ResNet50(dtype=dtype, fused_norm=fused_norm,
                          generator=_seed(3))
    s2d = models.get_arch('resnet50_s2d', dtype=dtype,
                          fused_norm=fused_norm, generator=_seed(4))
    models.load_flax_variables(s2d, models.convert_stem_variables(
        models.to_flax_variables(std)))
    return std.eval(), s2d.eval()


def _seed(n):
    import torch
    return torch.Generator().manual_seed(n)


def _input_s2d():
    """``resnet50_s2d`` on the standard model's converted weights: the
    eval forward at 224 px, batch 64 in f32 (TF32 off) within
    ``BF16_TOL`` of the standard stem's (the same function); the bf16
    models' difference printed; then ``S2D_STEPS`` bf16 training steps of
    each after 2 (in turns), step p50 against p50."""
    import numpy as np
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, ops, training
    x = torch.rand((BATCH, 224, 224, 3), generator=_seed(5)).cuda()
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        std, s2d = _s2d_models(torch.float32)
        with torch.no_grad():
            want, got = std(x), s2d(x)
        check_close('resnet50_s2d eval forward (f32)', got, want, *BF16_TOL)
        f32_err = max_err(got, want)
        del std, s2d
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
    _free()
    std, s2d = _s2d_models(torch.bfloat16)
    with torch.no_grad():
        want, got = std(x), s2d(x)
    bf16_err = max_err(got, want)
    bf16_rel = bf16_err / float(want.float().abs().max())
    labels = torch.randint(0, 1000, (BATCH,), generator=_seed(6))
    host = x.cpu().numpy()
    batch = [(host[i], np.int32(labels[i])) for i in range(BATCH)]
    comm = cmt.create_communicator('xla')
    updaters, times, losses = {}, {}, {}
    try:
        for name, model in (('standard', std), ('space_to_depth', s2d)):
            model.train()
            clf = models.StatefulClassifier(model)
            opt = cmt.create_multi_node_optimizer(
                ops.FusedMomentumSGD(model.parameters(), 0.1, 0.9), comm)
            updaters[name] = training.StandardUpdater(
                training.SerialIterator(batch, BATCH, shuffle=False), opt,
                clf.loss, model, comm)
            times[name], losses[name] = [], []
            for _ in range(2):   # the broadcast call and a warm-up step
                losses[name].append(updaters[name].update()['loss'])
        # the timed steps in turns (standard, s2d, s2d, standard), half
        # a side's steps a turn
        half = S2D_STEPS // 2
        for name in ('standard', 'space_to_depth', 'space_to_depth',
                     'standard'):
            for _ in range(half):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                losses[name].append(updaters[name].update()['loss'])
                times[name].append(1e3 * (time.perf_counter() - t0))
    finally:
        comm.close()
    p50 = {}
    for name in updaters:
        if not all(math.isfinite(v) for v in losses[name]):
            raise AssertionError('%s stem: losses %s' % (name,
                                                         losses[name]))
        timed = sorted(times[name])
        p50[name] = timed[len(timed) // 2]
    _say('input', 'resnet50_s2d on convert_stem_variables of the standard '
         'model: eval forward (224 px, batch %d, f32, TF32 off) max abs '
         'err %.3g, within BF16_TOL %s; in bf16 max abs err %.3g (%.3g of '
         'the largest logit, not bounded); %d bf16 training steps each '
         'after 2, in turns: step p50 %.3f ms space_to_depth against %.3f '
         'ms standard (%.1f vs %.1f images/s)' % (
             BATCH, f32_err, BF16_TOL, bf16_err, bf16_rel, S2D_STEPS,
             p50['space_to_depth'], p50['standard'],
             BATCH / p50['space_to_depth'] * 1e3,
             BATCH / p50['standard'] * 1e3))


def phase_input(thread):
    """The training input side: the native augmentation, ResNet-50
    streamed against resident, the twin on the native pipeline (beside
    phase 5b's ``thread``), the space-to-depth stem.  Returns the launch
    counts of the paths ``resnet_streamed`` and ``imagenet_native``."""
    _input_augment()
    streamed = _input_ab()
    _free()
    native = _input_native_twin(thread)
    _free()
    _input_s2d()
    _free()
    return {'resnet_streamed': streamed, 'imagenet_native': native}


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


def _mnist_example(out, extra=()):
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
                                    '--out', out, *extra])
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
    # 3. the example under --policy bf16, held to the gate's bar: bf16
    # compute and batches, f32 master weights
    out = tempfile.mkdtemp(prefix='mnist_bf16_')
    try:
        ops.reset_launch_counts()
        trainer, update_ms, _, _ = _mnist_example(out, ['--policy', 'bf16'])
        bf16_counts = ops.launch_counts()
        trainer.updater.comm.close()
        masters = {p.dtype for p in trainer.updater.model.parameters()}
        with open(os.path.join(out, 'log')) as f:
            bf16_entries = json.load(f)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    if any(bf16_counts.values()):
        raise AssertionError('MNIST bf16 example launched %s' % bf16_counts)
    if masters != {torch.float32}:
        raise AssertionError('MNIST bf16 example: master weights %s'
                             % masters)
    bf16_acc = bf16_entries[-1]['validation/main/accuracy']
    if not (len(bf16_entries) == 2 and bf16_acc >= 0.95
            and bf16_entries[1]['loss'] < bf16_entries[0]['loss']):
        raise AssertionError('MNIST bf16 example: log %s' % bf16_entries)
    timed = sorted(update_ms[2:])
    _say('mnist', 'example under --policy bf16: validation accuracy %.4f '
         '(f32 %.4f; the gate\'s bar 0.95), epoch losses %.4f -> %.4f (f32 '
         '%.4f -> %.4f), update p50 %.3f ms' % (
             bf16_acc, entries[1]['validation/main/accuracy'],
             bf16_entries[0]['loss'], bf16_entries[1]['loss'],
             entries[0]['loss'], entries[1]['loss'],
             timed[len(timed) // 2]))
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
    """A ``GenerationEngine`` that checks every call's logits finite
    where the host reads the call's greedy ids (``_read``: the graph's
    own output under CUDA graphs; one more reduction and host read per
    call: used outside the timed run)."""
    import torch
    from chainermn_tpu_torch import serving

    class FiniteEngine(serving.GenerationEngine):
        def _read(self, logits, ids):
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError('non-finite logits in a %s step' % (
                    'prefill' if logits.dim() == 1 else 'decode'))
            return super()._read(logits, ids)

    return FiniteEngine(*args, **kw)


def _graphed(eng):
    """Whether ``eng`` runs CUDA graphs (``aot`` on a CUDA device, the
    only other device type than the CPU the engines take)."""
    return eng.aot_requested and eng.device.type != 'cpu'


def _path_counts(eng, since):
    """A serving path's launches, as ``(counts, tc counts)`` keyed as
    ``ops.launch_counts()`` and ``ops.tc_launch_counts()``: the wrappers'
    counts (eager launches, read now) plus those of ``eng``'s graph
    replays since the replay snapshot ``since`` (``stats()['replays']``;
    replays times the counts recorded at capture).  A graphed engine must
    launch nothing eagerly after its warm-up."""
    from chainermn_tpu_torch import ops
    eager, eager_tc = ops.launch_counts(), ops.tc_launch_counts()
    graph = eng.replayed_launches(since)
    if _graphed(eng) and any(eager.values()):
        raise AssertionError('a graphed engine launched kernels eagerly in '
                             'its window: %s' % {
                                 k: v for k, v in eager.items() if v})
    return ({k: eager[k] + graph.get(k, 0) for k in eager},
            {k: eager_tc[k] + graph.get(k + '.tc', 0) for k in eager_tc})


# kernels launched and finished at the start of a trace whose kernels are
# counted: late in this script the tracer drops the first few kernel
# records of a session (one LayerNorm and one flash forward of a held
# serving window, or one bn_apply of the request-serving window; fewer
# after a prelude of 8, none in a short process), so the prelude's
# records are the ones it drops
TRACE_PRELUDE = 64


def trace_prelude(device):
    """Launch ``TRACE_PRELUDE`` small kernels on ``device`` and wait for
    them: called first inside a ``torch.profiler`` session whose kernels
    are counted."""
    import torch
    x = torch.zeros(1, device=device)
    for _ in range(TRACE_PRELUDE):
        x.add_(1.0)
    torch.cuda.synchronize()

# the serving kernels' events in a profiler trace (CUPTI traces the kernels
# of a graph replay one by one): LayerNorm, the flash forward (tensor-core
# or scalar), the decode kernel's slot and paged instantiations
GEN_EVENTS = {'layer_norm': r'\bln_kernel<',
              'flash_fwd': r'\bflash_fwd_(tc_)?kernel\b',
              'flash_decode': r'\bflash_decode_split_kernel<[^()]*\bfalse>',
              'flash_decode_paged':
                  r'\bflash_decode_split_kernel<[^()]*\btrue>'}


def _hold_trace(what, eng, run):
    """``run()`` under ``torch.profiler``: the LayerNorm, flash forward
    and decode kernels its trace holds must equal ``eng``'s replays in it
    times the launches recorded at each capture, and no wrapper may count
    an eager launch.  ``run()`` follows ``trace_prelude``.  The tracer
    also loses whole sessions now and then: a trace that holds no
    device event, or fewer of these kernels than the replays made, is
    taken again with a new ``run()``, and ``PROFILE_TRIES`` such traces
    fail; a trace that holds more fails at once.  Returns the traced
    counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chainermn_tpu_torch import ops
    for _ in range(PROFILE_TRIES):
        since = eng.stats()['replays']
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            trace_prelude(eng.device)
            run()
            torch.cuda.synchronize()
        if sum(_kernel_times(prof).values()) == 0:
            _say('profile', 'a trace held no device event')
            continue
        want = {k: v for k, v in _path_counts(eng, since)[0].items()
                if k in GEN_EVENTS}
        got = {k: _kernel_count(prof, pattern)
               for k, pattern in GEN_EVENTS.items()}
        if got == want and any(got.values()):
            return got
        if any(got[k] > want[k] for k in got) or not any(want.values()):
            raise AssertionError('%s: the trace holds %s kernels, the '
                                 'replays times the captured launches %s'
                                 % (what, got, want))
        _say('profile', '%s: a trace lost kernel records: it holds %s, the '
             'replays made %s; its kernels by name: %s' % (
                 what, got, want, sorted(
                     (evt.key[:72], evt.count) for evt in prof.key_averages()
                     if evt.device_type == torch.autograd.DeviceType.CUDA
                     and ('ln_' in evt.key or 'flash' in evt.key))))
    raise AssertionError('%s: %d traces without a device event or with '
                         'kernels lost' % (what, PROFILE_TRIES))


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
    the launch counts set to 0 just before and read just after (the
    wrappers' and the graph replays', :func:`_path_counts`).  Returns the
    outputs, the counts, ``stats()``, the wall time, the TTFTs (from
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
    since = eng.stats()['replays']
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
    counts, tc = _path_counts(eng, since)
    return dict(outs=[r.result() for r in reqs], counts=counts, tc=tc,
                stats=eng.stats(), wall=wall,
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


def _warm(eng):
    """Warm ``eng`` up: one CUDA graph per bucket (every bucket must come
    back ``aot``), or one eager run each with ``aot=False``.  Returns its
    buckets, captures, seconds and the memory it allocated, with a log
    line of them (``line``)."""
    import torch
    gc.collect()            # earlier engines' caches, freed by then
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    warm = eng.warmup()
    torch.cuda.synchronize()
    out = dict(seconds=time.perf_counter() - t0,
               buckets=sum(len(b) for b in warm.values()),
               captures=eng.stats()['compile_count'],
               mib=(torch.cuda.memory_allocated() - mem0) / 2 ** 20)
    if _graphed(eng) and not all(all(b.values()) for b in warm.values()):
        raise AssertionError('warmup left buckets uncaptured: %s' % warm)
    out['line'] = ('%(buckets)d buckets, %(captures)d graphs captured in '
                   '%(seconds).2f s (+%(mib).1f MiB allocated)' % out)
    return out


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
    _say('serve', 'TransformerLM %d parameters, bf16 weights and cache, '
         '%d slots x %d positions; %s' % (
             n_params, SERVE_SLOTS, SERVE_CFG['max_len'],
             _warm(eng)['line']))
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
    _say('serve', 'launches %s, all graph replays (per prefill: %d '
         'layer_norm, %d flash_fwd; per decode step: %d layer_norm, %d '
         'flash_decode)' % (counts, 2 * layers + 1, layers, 2 * layers + 1,
                            layers))
    _say('serve', 'traced kernels of 8 requests x 8 tokens, equal to the '
         'replays times the captured launches: %s' % _hold_trace(
             'slot serving', eng, lambda: _drain(eng, queue, [
                 queue.submit(p, 8) for p in prompts[:8]])))
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
    eng8.warmup()
    ops.reset_launch_counts()
    reqs = [queue.submit(p, 8) for p in prompts[:8]]
    _drain(eng8, queue, reqs)
    c8, st8 = _path_counts(eng8, {})[0], eng8.stats()
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
    _say('paged', 'pool %s pages of 16 positions (%d per sequence), %d '
         'slots; %s' % (eng.n_pages, eng.pages_per_seq, SERVE_SLOTS,
                        _warm(eng)['line']))
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
    _say('paged', 'traced kernels of 8 requests x 8 tokens: %s' % _hold_trace(
        'paged serving', eng, lambda: _drain(eng, queue, [
            queue.submit(p, 8) for p in prompts[:8]])))
    profile_decode(eng, queue)
    del eng
    # chunked prefill
    eng = _paged_engine(model, prefill_chunk=32)
    _warm(eng)
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
        _warm(eng)
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
    _say('spec', _warm(eng)['line'])
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
    queue = _paged_queue()
    _say('spec', 'traced kernels of 8 requests x 8 tokens: %s' % _hold_trace(
        'speculative serving', eng, lambda: _drain(eng, queue, [
            queue.submit(p, 8) for p in prompts[:8]])))
    return counts


# ---------------------------------------------------------------------
# TransformerLM training

# ---------------------------------------------------------------------
# the request-serving path: InferenceEngine + open_loop, and the
# generation engine under open_loop_generate

# the serving row's configuration (bench.py --serve): ResNet-50 at 224 px,
# buckets 1..32, a queue of 128, 2x the probed capacity; 300 requests of
# bench.py's 1000
SERVE_INFER_BATCH = 32
SERVE_INFER_INSIZE = 224
SERVE_INFER_REQUESTS = 300
# the generation rows (bench.py --serve --generate): the probe offers
# 2 x 32 requests at once, the open loop 64 (bench.py 384) at 2x capacity
SERVE_GEN_REQUESTS = 64
# the int8 engine's logits against the bf16 engine's: the reference's
# bound (tests/test_serving.py TestInt8Policy), as rtol and atol
INT8_TOL = 5e-2


# the scale given to each bottleneck's last BatchNorm in the int8 branch
# check, which the zoo's initialization (as flax's) starts at zero: with
# zero every residual branch outputs zero and only the stem, the
# projection shortcuts and fc reach the logits; with this the 48 branch
# convs reach them too, without the scales near 1 that make a random
# 50-layer net chaotic
BRANCH_SCALE = 0.2


def _seeded_resnet50(seed=0, branch_scale=None):
    """Full-width ResNet-50 (bf16, ``fused_norm=True``) as bench.py serves
    it: the zoo's own initialization from ``seed`` (each bottleneck's last
    BatchNorm scale starts at zero, as in flax; ``branch_scale`` sets
    those 16 scales instead), with the running statistics set to the
    batch statistics of one seeded batch of ``SERVE_INFER_BATCH`` (a
    train-mode pass with momentum 0), so that eval-mode activations are
    normalized.  Returns the model in eval mode."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import models
    model = models.get_arch('resnet50', num_classes=1000, fused_norm=True,
                            generator=torch.Generator().manual_seed(seed),
                            insize=SERVE_INFER_INSIZE)
    rng = np.random.RandomState(seed)
    norms = [m for m in model.modules() if isinstance(m, models.NormAct)]
    with torch.no_grad():
        zero = [m for m in norms if not bool(m.scale.any())]
        if len(zero) != 16:
            raise AssertionError('ResNet-50: %d BatchNorms start at zero '
                                 'scale, expected 16' % len(zero))
        if branch_scale is not None:
            for m in zero:
                m.scale.fill_(branch_scale)
        for m in norms:
            m.momentum = 0.0
        model.train()
        x = torch.from_numpy(rng.rand(SERVE_INFER_BATCH, SERVE_INFER_INSIZE,
                                      SERVE_INFER_INSIZE, 3)
                             .astype(np.float32)).cuda()
        model(x)
        for m in norms:
            m.momentum = 0.9
    return model.eval()


def _inference_bn_record(gen):
    """Row 2 on the serving path: ``batch_norm_act_inference`` (running
    statistics, one ``bn_apply`` launch) at ResNet-50's stage-1 exit of
    bucket 32, bf16 + residual + relu, against its plain version
    ``_apply_ref`` on the same inputs; timed against it."""
    import torch
    from chainermn_tpu_torch import ops
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    m, c = SERVE_INFER_BATCH * (SERVE_INFER_INSIZE // 4) ** 2, 256
    x = torch.randn((m, c), generator=gen, device='cuda').to(torch.bfloat16)
    res = torch.randn((m, c), generator=gen,
                      device='cuda').to(torch.bfloat16)
    scale, bias, mean = (torch.randn(c, generator=gen, device='cuda')
                         for _ in range(3))
    var = torch.rand(c, generator=gen, device='cuda') + 0.5

    def kernel():
        return ops.batch_norm_act_inference(x, scale, bias, mean, var,
                                            residual=res)

    def plain():
        return bn._apply_ref(x, mean, torch.rsqrt(var + 1e-5), scale, bias,
                             res, True)

    before = ops.bn_apply.launches
    got = kernel()
    if ops.bn_apply.launches - before != 1:
        raise AssertionError('batch_norm_act_inference took %d bn_apply '
                             'launches' % (ops.bn_apply.launches - before))
    want = plain()
    check_close('batch_norm_act_inference vs _apply_ref', got, want,
                *BF16_TOL)
    t = timings(kernel, plain, None)
    b_ms, b_by = bound_ms(3 * m * c * x.element_size() + 4 * c * 4,
                          5 * m * c)
    cold_ms, cold_device_ms = cold_times(kernel, BN_APPLY_EVENT)
    out = dict(inference_case='batch_norm_act_inference (running '
               'statistics) at %s bf16 + residual + relu' % ((m, c),),
               inference_max_abs_err=max_err(got, want),
               inference_bit_equal=bool(torch.equal(got, want)),
               inference_bound_ms=b_ms,
               inference_cold_ms=cold_ms,
               inference_cold_device_ms=cold_device_ms,
               inference_cold_bound_share=(b_ms / cold_device_ms
                                           if cold_device_ms else None),
               **{'inference_' + k: v for k, v in t.items()})
    _say('serve-infer', '%s: max abs err %.3g vs _apply_ref (tolerance %s), '
         'bit-equal %s; %s (warm: its three %.0f MB operands stay in the '
         'L2 between launches); with the L2 flushed before each launch '
         '%.5f ms per call, device only %s ms; bound %.5f ms by %s (%s of '
         'it cold)' % (
             out['inference_case'], out['inference_max_abs_err'], BF16_TOL,
             out['inference_bit_equal'], _fmt(t), m * c * 2 / 1e6, cold_ms,
             _ms(cold_device_ms), b_ms, b_by,
             'not measured' if cold_device_ms is None
             else '%.0f%%' % (100 * b_ms / cold_device_ms)))
    return out


def _hold_serving_interludes(eng, x):
    """Row 2 at every shape the serving path gives it: one eager forward
    of ``eng`` on the padded batch ``x`` with a hook on each ``NormAct``
    of its stateless module, which holds that interlude's output (one
    ``batch_norm_act_inference``, one ``bn_apply`` launch) against the
    plain version ``_apply_ref`` on the same input, residual and running
    statistics, within ``BF16_TOL``.  Returns ``(interludes, worst
    units of BF16_TOL, bit-equal interludes, fewest rows)``."""
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.models import NormAct
    bn = importlib.import_module('chainermn_tpu_torch.ops.batch_norm_act')
    rows, handles, held = [], [], {}

    def pre(mod, args, kwargs):
        res = args[1] if len(args) > 1 else kwargs.get('residual')
        held[id(mod)] = (args[0], res)

    def post(mod, args, out):
        xin, res = held.pop(id(mod))
        c = xin.shape[-1]
        want = bn._apply_ref(
            xin.reshape(-1, c), mod.mean.float(),
            torch.rsqrt(mod.var.float() + mod.epsilon), mod.scale.float(),
            mod.bias.float(), None if res is None else res.reshape(-1, c),
            mod.relu)
        got = out.reshape(-1, c)
        rows.append((got.shape[0], _units(got, want, *BF16_TOL),
                     bool(torch.equal(got, want))))

    for mod in eng.apply_fn.module.modules():
        if isinstance(mod, NormAct):
            handles.append(mod.register_forward_pre_hook(pre,
                                                         with_kwargs=True))
            handles.append(mod.register_forward_hook(post))
    before = ops.bn_apply.launches
    try:
        eng.eager(x)
    finally:
        for h in handles:
            h.remove()
    launched = ops.bn_apply.launches - before
    if len(rows) != BN_PER_STEP or launched != BN_PER_STEP:
        raise AssertionError('bucket %d: %d interludes held, %d bn_apply '
                             'launches, expected %d' % (
                                 x.shape[0], len(rows), launched,
                                 BN_PER_STEP))
    worst = max(r[1] for r in rows)
    if not worst <= 1.0:
        raise AssertionError('bucket %d: batch_norm_act_inference against '
                             '_apply_ref at %.3g of BF16_TOL; by interlude '
                             '(rows, units, bit-equal): %s'
                             % (x.shape[0], worst, rows))
    return (len(rows), worst, sum(r[2] for r in rows),
            min(r[0] for r in rows))


def _hold_int8_weights(eng, state):
    """Every int8 weight of ``eng`` against the f32 weight it was made
    from (``state``, the same tree before quantization): the scale is
    one per output channel (axis 0 of a PyTorch ``weight``), each
    nonzero channel's largest ``|q|`` is 127, and ``q * scale`` is
    within half a step (``scale / 2``, plus 2^-16 of it for the f32
    division) of the weight.  Returns ``(leaves, worst error in half
    steps)``."""
    import torch
    from chainermn_tpu_torch.precision import is_quantized
    want = dict(_flat(state))
    n, worst = 0, 0.0
    for key, leaf in _flat(eng.params):
        if not is_quantized(leaf):
            continue
        w = want[key].double()
        q, s = leaf.q, leaf.scale.double()
        others = tuple(range(1, q.dim()))
        top = q.abs().amax(dim=others)
        if s.shape != (w.shape[0],) or int(top.max()) > 127 or not bool(
                ((top == 127) | (w.abs().amax(dim=others) == 0)).all()):
            raise AssertionError('int8 %s %s: scale %s, |q| <= %d by channel'
                                 % (key, tuple(w.shape), tuple(s.shape),
                                    int(q.abs().amax())))
        half = s.reshape((-1,) + (1,) * len(others)) / 2
        units = float(((q.double() * 2 * half - w).abs() / half).max())
        if not units <= 1.0 + 2.0 ** -16:
            raise AssertionError('int8 %s: q * scale off the weight by %.6g '
                                 'half steps' % (key, units))
        n, worst = n + 1, max(worst, units)
    return n, worst


def _kernel_count(prof, pattern):
    """Kernel events whose name matches ``pattern`` in a
    ``torch.profiler`` run (kernels replayed in a CUDA graph are traced
    one by one)."""
    import torch
    return sum(evt.count for evt in prof.key_averages()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and re.search(pattern, evt.key))


def _map_tree(fn, tree):
    """``fn`` over the leaves of a nested ``dict``."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _engine_bytes(eng):
    """Bytes of an engine's placed weights (int8 ``q`` and f32 scales of
    a quantized leaf)."""
    from chainermn_tpu_torch.precision import is_quantized
    total = 0
    for _, leaf in _flat(eng.params):
        for t in (leaf[:2] if is_quantized(leaf) else (leaf,)):
            total += t.numel() * t.element_size()
    return total


# bn_apply's kernel in a profiler trace (not bn_bwd_apply_kernel)
BN_APPLY_EVENT = r'\bapply_kernel<'


def _serve_window(eng, rate, profiled=False):
    """``open_loop`` over the serving row's queue with the counts set to
    0 just before and read just after.  Returns the report, the wrapper
    counts, the replays by bucket in the window, and (``profiled``: the
    window runs under ``torch.profiler``, after ``trace_prelude``) the
    device's busy share over the window, None when the trace held no
    device event, and the ``bn_apply`` kernels the trace holds (None
    unprofiled)."""
    import contextlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chainermn_tpu_torch import ops, serving
    queue = serving.RequestQueue(max_batch=SERVE_INFER_BATCH,
                                 max_wait=0.005,
                                 max_queue=4 * SERVE_INFER_BATCH)
    replays0 = dict(eng.replays)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    prof = (profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) if profiled
            else contextlib.nullcontext())
    with prof:
        if profiled:
            trace_prelude(eng.device)
        rep = serving.open_loop(eng, queue, rate=rate,
                                n_requests=SERVE_INFER_REQUESTS, seed=0)
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    replays = {b: eng.replays[b] - replays0.get(b, 0) for b in eng.replays}
    busy = traced = None
    if profiled:
        busy_us = sum(_kernel_times(prof).values())
        busy = busy_us / (rep['wall_s'] * 1e6) if busy_us > 0 else None
        traced = _kernel_count(prof, BN_APPLY_EVENT)
    return rep, counts, replays, busy, traced


def _int8_branch_check(example, rng):
    """The int8 path through every conv, and the hot swap, on a
    ResNet-50 whose residual branches reach the logits
    (``branch_scale=BRANCH_SCALE``): an ``Int8Policy.bf16()`` engine
    against a ``Policy.bf16()`` engine over its own dequantized tree (the
    same bf16 weights the int8 forward reads), replays bit-equal at
    buckets 1 and 32, the interludes of both held against ``_apply_ref``;
    the int8 logits' distance from a ``Policy.bf16()`` engine over the
    f32 weights is printed (the quantization's own error; the
    ``INT8_TOL`` check runs on the served model).  Then one
    ``swap_params`` of that bf16 engine to a perturbed tree: its replay
    must equal an engine built on the perturbed tree, with no new
    capture, and a NaN tree must raise ``WeightSwapError``."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import precision, serving
    from chainermn_tpu_torch.serving.engine import module_state
    from chainermn_tpu_torch.utils.failure import WeightSwapError
    model = _seeded_resnet50(branch_scale=BRANCH_SCALE)
    bf16 = precision.Policy.bf16()

    def engine(tree, policy, warm=True):
        eng = serving.InferenceEngine.for_model(
            model, tree, example, max_batch=SERVE_INFER_BATCH, policy=policy,
            edges=(1, SERVE_INFER_BATCH))
        if warm and not all(eng.warmup().values()):
            raise AssertionError('a bucket was not captured')
        return eng

    e8 = engine(None, precision.Int8Policy.bf16())
    ed = engine(precision.dequantize_int8(e8.params, torch.bfloat16), bf16)
    ef = engine(None, bf16)
    for b in (1, SERVE_INFER_BATCH):
        x = rng.rand(b, *example.shape).astype(np.float32)
        y8, yd, yf = e8.infer(x), ed.infer(x), ef.infer(x)
        if not torch.equal(y8, yd):
            raise AssertionError('bucket %d: the int8 engine differs from a '
                                 'bf16 engine over its dequantized weights '
                                 'by %.3g' % (b, max_err(y8, yd)))
        held = [_hold_serving_interludes(e, x) for e in (e8, ed)]
        _say('serve-infer', 'int8 branch check, bucket %2d: int8 replay '
             'bit-equal to the bf16 engine over its dequantized weights; '
             'both engines\' %d interludes within %.3g of BF16_TOL of '
             '_apply_ref; int8 vs bf16 over the f32 weights (quantization '
             'error, printed only): max abs err %.3g, |logit| <= %.3g, '
             'relative L2 %.3g' % (b, held[0][0], max(h[1] for h in held),
                                   max_err(y8, yf), float(yf.abs().max()),
                                   _rel_l2(y8, yf)))
    del e8, ed
    # a hot swap to a perturbed tree: the replay equals a fresh engine's
    # forward on that tree, no new capture; a NaN tree is refused and the
    # engine serves on
    x = rng.rand(SERVE_INFER_BATCH, *example.shape).astype(np.float32)
    before = ef.infer(x)
    compiles = ef.compile_count
    state = module_state(model)
    prng = np.random.RandomState(1)
    perturbed = _map_tree(lambda t: t * float(1.0 + 0.05 * prng.randn()),
                          state)
    version = ef.swap_params(perturbed, version=1)
    after = ef.infer(x)
    want = engine(perturbed, bf16, warm=False).eager(x)
    if not torch.equal(after, want) or torch.equal(before, after) \
            or ef.compile_count != compiles:
        raise AssertionError('swap: %.3g from an engine on the new tree, '
                             'moved %.3g, captures %d -> %d' % (
                                 max_err(after, want),
                                 max_err(after, before), compiles,
                                 ef.compile_count))
    nan = _map_tree(lambda t: torch.full_like(t, float('nan')), state)
    try:
        ef.swap_params(nan, version=2)
    except WeightSwapError:
        pass
    else:
        raise AssertionError('a NaN tree was swapped in')
    if not torch.equal(ef.infer(x), after) or ef.param_version != version:
        raise AssertionError('the refused swap changed the engine')
    _say('serve-infer', 'hot swap to version %d: bucket-%d logits moved by '
         '%.3g and equal an engine built on the new tree, captures %d -> '
         '%d; a NaN tree refused (WeightSwapError), version %d serves on'
         % (version, SERVE_INFER_BATCH, max_err(after, before), compiles,
            ef.compile_count, ef.param_version))


def phase_serve_infer():
    """The request-serving path: ResNet-50 (224 px, ``fused_norm=True``,
    eval) through ``InferenceEngine.for_model(max_batch=32)`` under
    ``Policy.bf16()`` and ``Int8Policy.bf16()``, one CUDA graph per
    bucket, fed by ``open_loop`` at twice the probed capacity.  Returns
    the path's launch counts (a replay counts nothing in the wrappers:
    the ``bn_apply`` kernels are counted in the profiled windows' traces
    and held against the replays times the launches each graph captured)
    and row 2's inference-call reading."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import ops, precision, serving
    from chainermn_tpu_torch.serving.engine import module_state
    gen = torch.Generator(device='cuda').manual_seed(13)
    inference = _inference_bn_record(gen)
    model = _seeded_resnet50()
    example = np.zeros((SERVE_INFER_INSIZE, SERVE_INFER_INSIZE, 3),
                       np.float32)
    rng = np.random.RandomState(0)
    engines, memory = {}, {}
    for name, policy in (('bf16', precision.Policy.bf16()),
                         ('int8', precision.Int8Policy.bf16())):
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        eng = serving.InferenceEngine.for_model(
            model, None, example, max_batch=SERVE_INFER_BATCH, policy=policy)
        t0 = time.perf_counter()
        aot = eng.warmup()
        warm_s = time.perf_counter() - t0
        if sorted(aot) != list(eng.edges) or not all(aot.values()):
            raise AssertionError('%s engine: buckets captured %s' % (name,
                                                                     aot))
        if any(c != {'bn_apply': BN_PER_STEP}
               for c in eng.graph_launches.values()):
            raise AssertionError('%s engine: captured launches %s, expected '
                                 '%d bn_apply a graph' % (
                                     name, eng.graph_launches, BN_PER_STEP))
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated() - base
        x = rng.rand(SERVE_INFER_BATCH, SERVE_INFER_INSIZE,
                                      SERVE_INFER_INSIZE, 3).astype(np.float32)
        torch.cuda.reset_peak_memory_stats()
        now = torch.cuda.memory_allocated()
        eng.eager(x)
        memory[name] = dict(weights=_engine_bytes(eng), resident=resident,
                            eager_peak=torch.cuda.max_memory_allocated()
                            - now)
        engines[name] = eng
        if name == 'int8':
            leaves, units = _hold_int8_weights(eng, module_state(model))
            _say('serve-infer', 'int8 engine: %d weights quantized per '
                 'output channel, q * scale within %.6g half steps of the '
                 'f32 weight at worst' % (leaves, units))
        _say('serve-infer', '%s engine: %d buckets %s captured in %.2f s '
             '(%d bn_apply launches in each graph); weights %.1f MiB, '
             'resident after capture (weights + graph pools) %.1f MiB, an '
             'eager bucket-%d forward peaks %.1f MiB over that' % (
                 name, len(aot), list(eng.edges), warm_s, BN_PER_STEP,
                 memory[name]['weights'] / 2 ** 20, resident / 2 ** 20,
                 SERVE_INFER_BATCH, memory[name]['eager_peak'] / 2 ** 20))
    # every bucket: the replay against an eager forward of the same
    # engine, the int8 engine against the bf16 engine, and the times
    replay_times = {}
    for b in engines['bf16'].edges:
        x = rng.rand(b, *example.shape).astype(np.float32)
        out, held = {}, {}
        for name, eng in engines.items():
            replay, eager = eng.infer(x), eng.eager(x)
            held[name] = _hold_serving_interludes(eng, x)
            if not bool(torch.isfinite(replay).all()) \
                    or tuple(replay.shape) != (b, 1000):
                raise AssertionError('%s bucket %d: logits %s, finite %s'
                                     % (name, b, tuple(replay.shape),
                                        bool(torch.isfinite(replay).all())))
            equal = bool(torch.equal(replay, eager))
            if name == 'bf16' and not equal:
                raise AssertionError('bf16 bucket %d: the replay differs '
                                     'from the eager forward by %.3g'
                                     % (b, max_err(replay, eager)))
            graph, xin = eng._graphs[b][:2]
            xd = xin.clone()
            replay_ms = time_ms(graph.replay, iters=10)
            with torch.no_grad():
                eager_ms = time_ms(lambda: eng._forward(eng.params, xd),
                                   iters=5, warmup=1)
            out[name] = (replay, equal, replay_ms, eager_ms)
            replay_times.setdefault(name, {})[b] = replay_ms
        check_close('int8 vs bf16 logits, bucket %d' % b, out['int8'][0],
                    out['bf16'][0], INT8_TOL, INT8_TOL)
        _say('serve-infer', 'bucket %2d: replay bit-equal to eager: bf16 %s, '
             'int8 %s; int8 vs bf16 logits max abs err %.3g (bound '
             'rtol=atol=%g, |logit| <= %.3g); one replay %.3f ms vs one '
             'eager forward %.3f ms (bf16), %.3f vs %.3f ms (int8)' % (
                 b, out['bf16'][1], out['int8'][1],
                 max_err(out['int8'][0], out['bf16'][0]), INT8_TOL,
                 float(out['bf16'][0].abs().max()), out['bf16'][2],
                 out['bf16'][3], out['int8'][2], out['int8'][3]))
        _say('serve-infer', 'bucket %2d: batch_norm_act_inference against '
             '_apply_ref on each interlude\'s own inputs: %s' % (
                 b, '; '.join(
                     '%s %d interludes from %d rows, worst %.3g of BF16_TOL, '
                     '%d bit-equal' % ((name,) + held[name][:1]
                                       + held[name][3:] + held[name][1:3])
                     for name in held)))
    # the capacity probe (bench.py's), then the open loop at 2x
    paths = {}
    for name, eng in engines.items():
        big = eng.edges[-1]
        x = np.repeat(example[None], big, axis=0)
        eng.infer(x)
        t0 = time.perf_counter()
        for _ in range(6):
            eng.infer(x)
        batch_s = (time.perf_counter() - t0) / 6
        mean_items = (1 + max(1, SERVE_INFER_BATCH // 2)) / 2.0
        capacity = big / batch_s / mean_items
        rep, counts, replays, _, _ = _serve_window(eng, 2.0 * capacity)
        if any(counts.values()):
            raise AssertionError('%s open loop: eager launches %s (every '
                                 'batch must replay a graph)' % (name, counts))
        if rep['served'] + rep['shed_submit'] + rep['shed_deadline'] \
                + rep['errored'] != SERVE_INFER_REQUESTS \
                or rep['errored'] or not rep['served']:
            raise AssertionError('%s open loop: %s' % (name, rep))
        launched = sum(n * eng.graph_launches[b]['bn_apply']
                       for b, n in replays.items())
        if not launched:
            raise AssertionError('%s open loop: no graph replayed' % name)
        # the device's busy share: the window's replays at their measured
        # replay times, and a second window under the profiler, whose
        # trace counts the bn_apply kernels the replays ran: the path's
        # launches, held against the replays times the captured launches
        est = sum(n * replay_times[name][b]
                  for b, n in replays.items()) / (1e3 * rep['wall_s'])
        prep, pcounts, preplays, busy, traced = _serve_window(
            eng, 2.0 * capacity, profiled=True)
        expected = sum(n * eng.graph_launches[b]['bn_apply']
                       for b, n in preplays.items())
        if any(pcounts.values()) or prep['errored'] or not traced \
                or traced != expected:
            raise AssertionError('%s profiled open loop: %d bn_apply kernels '
                                 'in the trace, %d replayed (replays %s x %d '
                                 'a graph); eager launches %s; errored %d' % (
                                     name, traced or 0, expected, preplays,
                                     BN_PER_STEP, pcounts, prep['errored']))
        paths[name] = traced
        _say('serve-infer', '%s open loop: probed capacity %.1f req/s '
             '(bucket %d in %.3f ms), offered %.1f req/s x %d: served %d '
             '(%.1f req/s), shed %d at submit + %d by deadline (shed '
             'fraction %.3f); latency p50 %.2f ms p99 %.2f ms; queue wait '
             'p50 %.2f ms p99 %.2f ms; pad waste %.3f; replays by bucket '
             '%s (%d bn_apply kernels through the graphs); device busy '
             '%.1f%% of the %.3f s window from the replays\' times; under '
             'the profiler a second window served %.1f req/s, device busy '
             '%s, its trace holds %d bn_apply kernels (replays x captured '
             'launches: %d)' % (
                 name, capacity, big, 1e3 * batch_s, 2.0 * capacity,
                 SERVE_INFER_REQUESTS, rep['served'],
                 rep['served_req_per_s'], rep['shed_submit'],
                 rep['shed_deadline'], rep['shed_fraction'],
                 rep['latency_p50_ms'], rep['latency_p99_ms'],
                 rep['queue_wait_p50_ms'], rep['queue_wait_p99_ms'],
                 rep['pad_waste_fraction'],
                 {b: n for b, n in sorted(replays.items()) if n},
                 launched, 100 * est, rep['wall_s'],
                 prep['served_req_per_s'], 'not measured' if busy is None
                 else '%.1f%%' % (100 * busy), traced, expected))
        worst = (rep['worst_request'] or {}).get('worst')
        if worst:
            _say('serve-infer', '%s worst request %s: e2e %.2f ms = %s' % (
                name, worst['request_id'], worst['e2e_ms'], ', '.join(
                    '%s %.2f' % kv for kv in sorted(
                        worst['stage_ms'].items()))))
    _say('serve-infer', 'peak memory, bf16 against int8: weights %.1f vs '
         '%.1f MiB; resident after capture %.1f vs %.1f MiB; an eager '
         'bucket-%d forward over that %.1f vs %.1f MiB' % (
             memory['bf16']['weights'] / 2 ** 20,
             memory['int8']['weights'] / 2 ** 20,
             memory['bf16']['resident'] / 2 ** 20,
             memory['int8']['resident'] / 2 ** 20, SERVE_INFER_BATCH,
             memory['bf16']['eager_peak'] / 2 ** 20,
             memory['int8']['eager_peak'] / 2 ** 20))
    del engines, eng, model
    _int8_branch_check(example, rng)
    counts = dict.fromkeys(ops.KERNELS, 0)
    counts['bn_apply'] = sum(paths.values())
    return counts, inference


def _gen_window(eng, queue, rate, n, seed):
    """``open_loop_generate`` with the counts set to 0 just before and read
    just after (the wrappers' and the graph replays'); the queue records
    the request handles."""
    from chainermn_tpu_torch import ops, serving
    handles = []
    submit = queue.submit

    def recording(*args, **kw):
        req = submit(*args, **kw)
        handles.append(req)
        return req

    queue.submit = recording
    eng.warmup()
    since = eng.stats()['replays']
    ops.reset_launch_counts()
    rep = serving.open_loop_generate(
        eng, queue, rate=rate, n_requests=n, seed=seed,
        prompt_len_range=(4, SERVE_PROMPT), max_new_tokens=SERVE_NEW)
    counts, tc = _path_counts(eng, since)
    return rep, counts, tc, handles


def _check_gen_counts(what, rep, counts, decode):
    from chainermn_tpu_torch import ops
    layers = SERVE_CFG['n_layers']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update({'layer_norm': (2 * layers + 1) * (rep['prefills']
                                                   + rep['decode_steps']),
                 'flash_fwd': layers * rep['prefills'],
                 decode: layers * rep['decode_steps']})
    if counts != want or rep['errored'] or not rep['served']:
        raise AssertionError('%s: launch counts %s over %d prefills and %d '
                             'decode steps, expected %s; report %s' % (
                                 what, counts, rep['prefills'],
                                 rep['decode_steps'], want, rep))


def _say_gen(what, rep):
    _say('serve-loadgen', '%s: offered %.1f req/s x %d, served %d, shed %d '
         '(fraction %.3f); %.1f tokens/s; TTFT p50 %.2f ms p99 %.2f ms; '
         'inter-token p50 %.3f ms p99 %.3f ms; decode step p50 %.3f ms '
         'p99 %.3f ms; %d prefills, %d decode steps in %.3f s' % (
             what, rep['offered_rate'], rep['offered'], rep['served'],
             rep['shed_submit'] + rep['shed_deadline'],
             rep['shed_fraction'], rep['tokens_per_s'], rep['ttft_p50_ms'],
             rep['ttft_p99_ms'], rep['intertoken_p50_ms'],
             rep['intertoken_p99_ms'], rep['decode_step_p50_ms'],
             rep['decode_step_p99_ms'], rep['prefills'],
             rep['decode_steps'], rep['wall_s']))


def phase_serve_loadgen():
    """The full-width serving ``TransformerLM`` under
    ``open_loop_generate`` with ``GenerationEngine.run()`` on its thread:
    bench.py's capacity probe (2 x 32 requests at once), then 64 requests
    at twice that capacity in slot mode and in paged mode, and one
    ``Int8Policy.bf16()`` run of the probe's requests whose greedy
    streams are compared with the bf16 engine's.  Returns each path's
    launch counts."""
    import torch
    from chainermn_tpu_torch import models, precision, serving
    model = models.TransformerLM(**SERVE_CFG,
                                 generator=torch.Generator().manual_seed(0))
    paths = {}

    def engine(policy=precision.Policy.bf16(), **kw):
        eng = serving.GenerationEngine(model, n_slots=SERVE_SLOTS,
                                       max_prompt_len=SERVE_PROMPT,
                                       policy=policy, **kw)
        eng.warmup()
        return eng

    def queue(max_queue, eng):
        return serving.GenerationQueue(
            max_prompt_len=SERVE_PROMPT, max_queue=max_queue,
            page_size=eng.page_size if eng.paged else None)

    eng = engine()
    probe, counts, tc, probe_reqs = _gen_window(
        eng, queue(4 * SERVE_SLOTS, eng), 1e9, 2 * SERVE_SLOTS, 1)
    _check_gen_counts('probe', probe, counts, 'flash_decode')
    _say_gen('bf16 slot probe', probe)
    capacity = probe['tokens_per_s'] / SERVE_NEW
    for mode, kw, decode in (('slot', {}, 'flash_decode'),
                             ('paged', dict(paged=True, page_size=16),
                              'flash_decode_paged')):
        if mode == 'paged':
            eng = engine(**kw)
        rep, counts, tc, _ = _gen_window(
            eng, queue(2 * SERVE_SLOTS, eng), 2.0 * capacity,
            SERVE_GEN_REQUESTS, 0)
        _check_gen_counts(mode, rep, counts, decode)
        paths['lm_loadgen' + ('' if mode == 'slot' else '_paged')] = \
            with_tc('loadgen ' + mode, counts, tc)
        _say_gen('bf16 %s at 2x the probed capacity (%.1f req/s)'
                 % (mode, capacity), rep)
        del eng
    eng8 = engine(precision.Int8Policy.bf16())
    rep8, counts, tc, reqs8 = _gen_window(
        eng8, queue(4 * SERVE_SLOTS, eng8), 1e9, 2 * SERVE_SLOTS, 1)
    _check_gen_counts('int8', rep8, counts, 'flash_decode')
    paths['lm_loadgen_int8'] = with_tc('loadgen int8', counts, tc)
    if not rep8['quantized'] or rep8['served'] != probe['served']:
        raise AssertionError('int8 run: %s' % rep8)
    same = sum(a.result(timeout=0).tolist() == b.result(timeout=0).tolist()
               for a, b in zip(probe_reqs, reqs8))
    _say_gen('Int8Policy.bf16() slot, the probe\'s requests', rep8)
    _say('serve-loadgen', 'int8 weights: %d of %d greedy streams equal the '
         'bf16 engine\'s' % (same, len(reqs8)))
    _say('serve-loadgen', 'traced kernels of a profiled window (16 requests '
         'at once, int8 weights): %s' % _hold_trace(
             'loadgen int8', eng8, lambda: serving.open_loop_generate(
                 eng8, queue(SERVE_REQUESTS, eng8), 1e9, 16, seed=2,
                 prompt_len_range=(4, SERVE_PROMPT), max_new_tokens=8)))
    return paths


# ---------------------------------------------------------------------
# the generation engine's CUDA graphs against the same engine run eagerly

def _recording_engine(model, **kw):
    """A serving-LM ``GenerationEngine`` (32 slots, prompts up to 128)
    that keeps the first logits of each call shape it reads (``first``:
    ``(ndim, rows)`` -> logits): one prefill, one decode step per bucket,
    one verify per bucket."""
    from chainermn_tpu_torch import serving

    class Recording(serving.GenerationEngine):
        def _read(self, logits, ids):
            key = (logits.dim(), logits.shape[0] if logits.dim() > 1 else 1)
            if key not in self.first:
                self.first[key] = logits.clone()
            return super()._read(logits, ids)

    eng = Recording(model, n_slots=SERVE_SLOTS, max_prompt_len=SERVE_PROMPT,
                    **kw)
    eng.first = {}
    return eng


def _every_call(eng):
    """Every prepared call of the idle ``eng`` (each bucket of each
    family, both paged prefill variants) run once more on the warm-up's
    zero operands, which write nothing that is attended: ``{call key:
    logits}``."""
    out = {}
    for key in sorted(eng._calls, key=repr):
        call = eng._calls[key]
        call.stage(eng._zero_operands(key))
        out[key] = call.run()[0].clone()
    return out


def _decode_busy(eng, queue, n=5):
    """The device's busy share over ``n`` decode ticks of a full bucket
    (32 rows of 64-token prompts): the kernels' time in a profiled run of
    ``n`` ticks over the wall time of ``n`` ticks run just before without
    the profiler.  Returns ``(wall ms a tick, device ms a tick, busy
    share)``, the last two None when every trace came back empty.  The
    requests are left in flight."""
    import numpy as np
    import torch
    rng = np.random.RandomState(9)
    for _ in range(eng.n_slots):
        queue.submit(rng.randint(0, SERVE_CFG['vocab_size'],
                                 min(64, SERVE_PROMPT)), 128)
    for _ in range(8):
        eng.step(queue)
        if not eng._prefilling and len(eng._slots) == eng.n_slots:
            break
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        eng.step(queue)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
    _, kernels, _ = profiled(lambda: eng.step(queue), n)
    busy_ms = sum(kernels.values()) / n / 1e3
    if not busy_ms:
        return wall_ms, None, None
    return wall_ms, busy_ms, busy_ms / wall_ms


def _graph_modes():
    """The serving LM's six modes of ``phase_serve_graphs``: engine
    keywords (the draft built once, from seed 7 as in the spec phase)."""
    import torch
    from chainermn_tpu_torch import models, precision
    bf16 = precision.Policy.bf16()
    paged = dict(paged=True, page_size=16)
    draft = models.TransformerLM(**dict(SERVE_CFG, n_layers=3),
                                 generator=torch.Generator().manual_seed(7))
    return {'slot': dict(policy=bf16),
            'paged': dict(policy=bf16, **paged),
            'chunked': dict(policy=bf16, prefill_chunk=32, **paged),
            'spec': dict(policy=bf16, draft_model=draft,
                         draft_params=models.param_tree(draft),
                         spec_tokens=4, **paged),
            'int8_weights': dict(policy=precision.Int8Policy.bf16()),
            'int8_kv': dict(policy=bf16, int8_kv=True)}


def _graph_run(model, kw, aot, prompts, shared):
    """One engine of a mode: warm it up, serve the 64 prompts through
    ``_timed_serve`` (and in paged mode the shared-prefix set), hold a
    graphed engine's traced launches, read the busy share."""
    import torch
    from chainermn_tpu_torch import serving
    gc.collect()
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    eng = _recording_engine(model, aot=aot, **kw)

    def queue():
        return serving.GenerationQueue(
            max_prompt_len=SERVE_PROMPT, max_queue=SERVE_REQUESTS,
            page_size=16 if eng.paged else None)

    out = dict(warm=_warm(eng))
    out['mem_mib'] = (torch.cuda.memory_allocated() - mem0) / 2 ** 20
    out.update(_timed_serve(eng, queue(), prompts))
    out['first'] = dict(eng.first)
    out['shared'] = None
    if shared is not None:
        st0 = eng.stats()
        out['shared'] = _serve_shared(eng, queue(), *shared, n_new=8)
        hits = eng.stats()['prefix_hits'] - st0['prefix_hits']
        if hits != len(shared[1]):
            raise AssertionError('shared prefix: %d hits' % hits)
    out['every_call'] = _every_call(eng)
    if aot:
        q = queue()
        out['traced'] = _hold_trace('graphs', eng, lambda: _drain(
            eng, q, [q.submit(p, 8) for p in prompts[:8]]))
    out['busy'] = _decode_busy(eng, queue())
    del eng
    return out


def _say_graph_run(mode, aot, r):
    st, ttft, decode = r['stats'], r['ttft'], r['decode']
    wall_ms, busy_ms, share = r['busy']
    _say('serve-graphs', '%s %s: %.1f tokens/s; decode-step p50 %.3f ms '
         'p99 %.3f ms (%d ticks without prefill work); TTFT p50 %.2f ms; '
         'busy %s of a full-bucket decode tick (%.3f ms wall, device %s '
         'ms); warm-up %s; engine memory %.1f MiB after it, peak %.3f GiB'
         % (mode, 'graphed' if aot else 'eager',
            st['tokens_generated'] / r['wall'],
            1e3 * decode[len(decode) // 2],
            1e3 * decode[min(len(decode) - 1, int(0.99 * len(decode)))],
            len(decode), 1e3 * ttft[len(ttft) // 2],
            'not measured' if share is None else '%.1f%%' % (100 * share),
            wall_ms, _ms(busy_ms), r['warm']['line'], r['mem_mib'],
            r['peak'] / 2 ** 30))


def phase_serve_graphs():
    """The generation engine's CUDA graphs (``aot=True``) against the same
    engine run eagerly (``aot=False``) on the full-width serving LM, in
    six modes (slot; paged with prefix sharing; paged with
    ``prefill_chunk=32``; speculative with the 3-layer draft, paged;
    ``Int8Policy.bf16()`` weights; ``int8_kv``), over the 64 prompts of
    the serving phases: every stream identical, the first logits of each
    call shape bit-equal (a prefill, one decode step per bucket, one
    verify per bucket), every bucket captured, the graphed engine's
    traced LayerNorm, flash forward and decode kernels equal to its
    replays times the captured launches; tokens/s, decode-step p50/p99,
    TTFT p50, the busy share of a full-bucket decode tick, captures,
    their seconds and the engine's memory, eager against graphed.
    Returns each engine's launch counts by path."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import models
    model = models.TransformerLM(**SERVE_CFG,
                                 generator=torch.Generator().manual_seed(0))
    prompts = _serve_prompts()
    leader, followers = _shared_prefix_prompts(np.random.RandomState(8),
                                               SERVE_SLOTS - 1)
    paths = {}
    for mode, kw in _graph_modes().items():
        shared = (leader, followers) if mode == 'paged' else None
        runs = {aot: _graph_run(model, kw, aot, prompts, shared)
                for aot in (False, True)}
        eager, graphed = runs[False], runs[True]
        outs = [[o.tolist() for o in r['outs']] for r in (eager, graphed)]
        if outs[0] != outs[1] or eager['shared'] != graphed['shared']:
            raise AssertionError('%s: %d of %d streams equal eager and '
                                 'graphed' % (mode, sum(
                                     a == b for a, b in zip(*outs)),
                                     len(outs[0])))
        if eager['first'].keys() != graphed['first'].keys() or not all(
                torch.equal(eager['first'][k], graphed['first'][k])
                for k in eager['first']):
            raise AssertionError('%s: logits differ between eager and '
                                 'graphed at %s' % (mode, sorted(
                                     k for k in eager['first']
                                     if not torch.equal(
                                         eager['first'][k],
                                         graphed['first'].get(k)))))
        calls = eager['every_call']
        if calls.keys() != graphed['every_call'].keys() or not all(
                torch.equal(calls[k], graphed['every_call'][k])
                for k in calls):
            raise AssertionError('%s: a call\'s logits differ between eager '
                                 'and graphed' % mode)
        for aot, r in runs.items():
            _say_graph_run(mode, aot, r)
            path = 'lm_%s_%s' % ('graphs' if aot else 'eager', mode)
            paths[path] = with_tc(path, r['counts'], r['tc'])
        _say('serve-graphs', '%s: all %d streams%s identical, eager and '
             'graphed; the first logits bit-equal at %s (ndim, rows), and '
             'those of all %d calls (every bucket of %s) on the idle '
             'engines; traced launches of 8 requests x 8 tokens %s, equal '
             'to the replays times the captured launches' % (
                 mode, len(outs[0]), ' and the %d shared-prefix followers'
                 % len(followers) if shared else '',
                 sorted(graphed['first']), len(calls),
                 ', '.join(sorted({k[0] for k in calls})),
                 graphed['traced']))
    return paths


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


def _lm_training(comm):
    """The LM training main path's model and updater (``bench.py``'s
    transformer: ``LM_CFG``, Adam 1e-3 through the multi-node optimizer,
    one fixed seeded batch of ``LM_BATCH`` x ``LM_SEQ`` tokens).  Returns
    ``(model, updater)``."""
    import numpy as np
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, training
    model = models.TransformerLM(
        **LM_CFG, device=comm.device,
        generator=torch.Generator().manual_seed(0))
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
    return model, updater


def phase_lm_main():
    """The LM training main path at full width and depth: the entry
    points of the repo's transformer benchmark on one fixed batch."""
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import ops, training
    comm = cmt.create_communicator('xla')
    try:
        model, updater = _lm_training(comm)
        n_params = sum(p.numel() for p in model.parameters())
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


# the LM's parallel axes (phase 11): the full-width TransformerLM at
# 8192 tokens a sequence, one sequence a step (8192 tokens, as the LM
# training path's 8 x 1024), through the train_lm twin and the tensor-
# parallel model of a MeshPlan
LMP_SEQ = 8192
LMP_STEPS = 10                 # the twin's steps under each scheme
LMP_TP_STEPS = 4               # each tensor-parallel updater's calls
# the twin's profiled windows (first, last step): one step each, a try
# each, PROFILE_TRIES of them
LMP_WINDOWS = tuple((2 + 2 * i, 2 + 2 * i) for i in range(PROFILE_TRIES))
LMP_TWIN_ARGV = ['--vocab', '32000', '--d-model', '512', '--n-heads', '8',
                 '--n-layers', '6', '--batchsize', '1', '--mesh', '1x1',
                 '--bind-sp', '--steps', str(LMP_STEPS)]
# each kernel's events in a profiler trace, by wrapper name
LM_EVENTS = {'layer_norm': r'\bln_kernel<',
             'flash_fwd': r'\bflash_fwd_(tc_)?kernel\b',
             'flash_bwd_dq': r'\bflash_bwd_dq_(tc_)?kernel\b',
             'flash_bwd_dkv': r'\bflash_bwd_dkv_(tc_)?kernel\b',
             'cross_entropy': r'::ce_kernel<'}


def _lmp_kernel_cases(gen, records, path='lm_parallel', lead=(1, LMP_SEQ)):
    """Rows 4-8 at a path's shapes (``lead`` = (B, T), default this
    path's): LayerNorm over ``(B * T, 512)`` bf16 rows with f32 gamma /
    beta, the flash forward, dq and dk/dv at ``(B, T, 8, 64)`` bf16
    causal (strided views of one qkv projection), the cross-entropy at
    ``(B * T, 32000)`` f32, each against its plain version within
    ``BF16_TOL`` (the cross-entropy at its f32 1e-5) and timed beside
    ``F.layer_norm``, SDPA (its forward; its whole backward) and
    ``F.cross_entropy``; the times go into each row's ``other_shapes``
    under ``path``."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    fa = importlib.import_module('chainermn_tpu_torch.ops.flash_attention')
    ce = importlib.import_module('chainermn_tpu_torch.ops.cross_entropy')
    by_name = {r['name']: r for r in records}
    h, d = LM_CFG['n_heads'], LM_CFG['d_model'] // LM_CFG['n_heads']
    nb, seq = lead
    rows = nb * seq
    phase = path.replace('_', '-')
    out = {}
    # LayerNorm
    x = (torch.randn((rows, LM_CFG['d_model']), generator=gen,
                     device='cuda') * 3 + 1).to(torch.bfloat16)
    g = torch.randn(LM_CFG['d_model'], generator=gen, device='cuda') + 1
    b = torch.randn(LM_CFG['d_model'], generator=gen, device='cuda')
    got, want = ops.ln_forward(x, g, b), ops.layer_norm_reference(x, g, b)
    check_close('layer_norm %s (%s)' % (tuple(x.shape), path), got, want,
                *BF16_TOL)
    t = timings(lambda: ops.ln_forward(x, g, b),
                lambda: ops.layer_norm_reference(x, g, b),
                lambda: F.layer_norm(x, (x.shape[1],), g.to(x.dtype),
                                     b.to(x.dtype), 1e-6), iters=20)
    n, dm = x.shape
    t.update(zip(('bound_ms', 'bound_by'), bound_ms(
        2 * n * dm * 2 + 2 * dm * 4, 8 * n * dm)))
    out['layer_norm'] = dict(shape=[n, dm], max_abs_err=max_err(got, want),
                             **t)
    # the flash forward and backward
    q, k, v = _strided_qkv(gen, lead, h, d, torch.bfloat16)
    scale = d ** -0.5
    o, lse = ops.flash_fwd(q, k, v, True, scale)
    po, plse = fa._fwd_plain(q, k, v, True, scale)
    check_close('flash_fwd (%d, %d, %d, %d) (%s)' % (nb, seq, h, d, path),
                o, po, *BF16_TOL)
    check_close('flash_fwd lse (%s)' % path, lse, plse, 1e-5, 1e-4)
    lq, lk, lv = (z.transpose(1, 2) for z in (q, k, v))
    t = timings(lambda: ops.flash_fwd(q, k, v, True, scale),
                lambda: fa._fwd_plain(q, k, v, True, scale),
                lambda: F.scaled_dot_product_attention(lq, lk, lv,
                                                       is_causal=True),
                iters=10, plain_iters=2)
    n_bytes, n_ops = _flash_fwd_cost(nb, seq, h, d, 2)
    t.update(zip(('bound_ms', 'bound_by'),
                 bound_ms(n_bytes, n_ops, BF16_TC_FLOPS_PER_S)))
    out['flash_fwd'] = dict(shape=[nb, seq, h, d],
                            max_abs_err=max_err(o, po), **t)
    gg = torch.randn((nb, seq, h, d), generator=gen,
                     device='cuda').to(torch.bfloat16)
    dq, delta = ops.flash_bwd_dq(q, k, v, gg, o, lse, True, scale)
    dk, dv = ops.flash_bwd_dkv(q, k, v, gg, lse, delta, True, scale)
    pdq, pdk, pdv = fa._bwd_plain(q, k, v, o, lse, gg, True, scale)
    for name, a, c in (('dq', dq, pdq), ('dk', dk, pdk), ('dv', dv, pdv)):
        check_close('flash_bwd %s (%d, %d, %d, %d) (%s)'
                    % (name, nb, seq, h, d, path), a, c, *BF16_TOL)
    sq, sk, sv = (z.detach().transpose(1, 2).requires_grad_()
                  for z in (q, k, v))
    sout = F.scaled_dot_product_attention(sq, sk, sv, is_causal=True)
    sg = gg.transpose(1, 2)

    def library():
        return torch.autograd.grad(sout, (sq, sk, sv), sg, retain_graph=True)

    def plain():
        return fa._bwd_plain(q, k, v, o, lse, gg, True, scale)

    pairs = nb * seq * (seq + 1) // 2
    for name, kernel, n_products, err in (
            ('flash_bwd_dq',
             lambda: ops.flash_bwd_dq(q, k, v, gg, o, lse, True, scale), 3,
             max_err(dq, pdq)),
            ('flash_bwd_dkv',
             lambda: ops.flash_bwd_dkv(q, k, v, gg, lse, delta, True, scale),
             4, max(max_err(dk, pdk), max_err(dv, pdv)))):
        t = timings(kernel, plain, library, iters=10, plain_iters=2)
        t.update(zip(('bound_ms', 'bound_by'), bound_ms(
            6 * rows * h * d * 2 + 2 * h * rows * 4,
            n_products * 2 * h * pairs * d, BF16_TC_FLOPS_PER_S)))
        out[name] = dict(shape=[nb, seq, h, d], max_abs_err=err, **t)
    # the cross-entropy of the path's logits
    logits = torch.randn((rows, LM_CFG['vocab_size']), generator=gen,
                         device='cuda') * 3
    labels = torch.randint(0, LM_CFG['vocab_size'], (rows,),
                           generator=gen, device='cuda', dtype=torch.int32)
    loss, lse = ops.ce_forward(logits, labels)
    ploss, plse = ce._ce_forward_plain(logits, labels)
    check_close('cross_entropy (%s) loss' % path, loss, ploss, 1e-5, 1e-5)
    check_close('cross_entropy (%s) lse' % path, lse, plse, 1e-5, 1e-5)
    long_labels = labels.long()
    t = timings(lambda: ops.ce_forward(logits, labels),
                lambda: ce._ce_forward_plain(logits, labels),
                lambda: F.cross_entropy(logits, long_labels,
                                        reduction='none'), iters=10)
    nb, nv = logits.shape
    t.update(zip(('bound_ms', 'bound_by'),
                 bound_ms(nb * nv * 4 + 3 * nb * 4, 4 * nb * nv)))
    out['cross_entropy'] = dict(shape=[nb, nv], max_abs_err=max(
        max_err(loss, ploss), max_err(lse, plse)), **t)
    for name, row in out.items():
        _say(phase, '%s at %s: max err %.3g; %s; bound %.5f ms by %s'
             % (name, tuple(row['shape']), row['max_abs_err'], _fmt(row),
                row['bound_ms'], row['bound_by']))
        rec = by_name[name]
        rec.setdefault('other_shapes', {})[path] = row
        rec['max_abs_err'] = max(rec['max_abs_err'], row['max_abs_err'])


class _TwinWindows:
    """The twin's ``on_step``: a ``torch.profiler`` session over each
    window of ``LMP_WINDOWS`` (after ``trace_prelude``), whose kernels
    are held to the wrappers' counts in it; the first window whose trace
    holds them settles it (a lost trace tries the next), a trace holding
    more fails, and so does the run when every window lost its trace
    (``_lmp_twin``), as ``_hold_trace`` fails after ``PROFILE_TRIES``."""

    def __init__(self, what):
        self.what, self.prof, self.since, self.t0 = what, None, None, None
        self.got = self.busy = None
        self.profiled = set()

    def __call__(self, step, loss):
        import torch
        from torch.profiler import ProfilerActivity, profile
        from chainermn_tpu_torch import ops
        if self.got is not None:
            return
        for first, last in LMP_WINDOWS:
            if step == first - 1:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                trace_prelude('cuda')
                self.since = dict(ops.launch_counts())
                self.t0 = time.perf_counter()
            elif step == last and self.prof is not None:
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - self.t0) * 1e6
                self.prof.__exit__(None, None, None)
                self.profiled.update(range(first, last + 1))
                self._settle(self.prof, wall_us, ops.launch_counts())
                self.prof = None

    def _settle(self, prof, wall_us, now):
        settled = _settle_trace(prof, self.since, now, wall_us, self.what)
        if settled is not None:
            self.got, self.busy = settled


def _settle_trace(prof, since, now, wall_us, what):
    """The LM kernels in a ``torch.profiler`` trace (taken after
    ``trace_prelude``) against the wrappers' launches in it (``now``
    less ``since``): ``(counts, busy share)``, or None when the trace
    lost its device events or kernel records (the caller tries another
    window); a trace holding more kernels than were launched fails.
    The wall starts after the prelude, whose 64 tiny kernels (about 0.1
    ms) stay in the busy time."""
    kernels = _kernel_times(prof)
    if sum(kernels.values()) == 0:
        _say('profile', '%s: a trace held no device event' % what)
        return None
    want = {k: now[k] - since[k] for k in LM_EVENTS}
    got = {k: _kernel_count(prof, pattern)
           for k, pattern in LM_EVENTS.items()}
    if any(got[k] > want[k] for k in got):
        raise AssertionError('%s: the trace holds %s kernels, the wrappers '
                             'launched %s' % (what, got, want))
    if got != want:
        _say('profile', '%s: a trace lost kernel records: it holds %s, the '
             'wrappers launched %s' % (what, got, want))
        return None
    return got, sum(kernels.values()) / wall_us


def _lmp_twin(scheme):
    """The train_lm twin on one card; returns its path counts and its
    readings."""
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.examples.lm import train_lm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    windows = _TwinWindows('lm_parallel_%s' % scheme)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = train_lm.main(LMP_TWIN_ARGV + ['--sp-scheme', scheme,
                                         '--seq-len', str(LMP_SEQ)],
                        on_step=windows)
    torch.cuda.synchronize()
    counts, tc = ops.launch_counts(), ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = out['losses']
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('%s: non-finite loss %s' % (scheme, losses))
    layers = LM_CFG['n_layers']
    attn = layers if scheme == 'ulysses' else 0
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=(2 * layers + 1) * LMP_STEPS,
                flash_fwd=attn * LMP_STEPS, flash_bwd_dq=attn * LMP_STEPS,
                flash_bwd_dkv=attn * LMP_STEPS, cross_entropy=LMP_STEPS)
    if counts != want:
        raise AssertionError('%s: launch counts %s, expected %s'
                             % (scheme, counts, want))
    counts = with_tc('lm_parallel %s' % scheme, counts, tc)
    if windows.got is None:
        raise AssertionError('%s: %d traces without a device event or with '
                             'kernels lost' % (windows.what,
                                               len(LMP_WINDOWS)))
    # the step p50 over the steps after two warm-ups and outside the
    # profiled windows
    steps = [s for i, s in enumerate(out['step_seconds'])
             if i >= 2 and i not in windows.profiled]
    p50 = sorted(steps)[len(steps) // 2]
    tokens = out['tokens_per_step']
    _say('lm-parallel', 'twin --sp-scheme %s --seq-len %d (1 x %d tokens a '
         'step, mesh 1x1, the sequence axis bound): losses %s; step p50 %.2f '
         'ms over %d steps = %.1f tokens/s; peak memory %.2f GiB; busy '
         '%.1f%% over the profiled step; kernels in the trace %s; launches '
         '%s' % (scheme, LMP_SEQ, LMP_SEQ,
                 ', '.join('%.4f' % v for v in losses), 1e3 * p50,
                 len(steps), tokens / p50, peak / 2 ** 30,
                 100 * windows.busy, windows.got, counts))
    return counts, dict(p50_ms=1e3 * p50, tokens_per_s=tokens / p50,
                        peak_gib=peak / 2 ** 30, busy=windows.busy,
                        seq_len=LMP_SEQ)


def _lmp_tp(plan, comm, zero):
    """The tensor-parallel TransformerLM at the plan's degraded (1, 1)
    through ``StandardUpdater(comm=plan.communicator())``; returns the
    losses, the parameters after ``LMP_TP_STEPS`` calls, the counts and
    the step times."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import models, ops, training
    import chainermn_tpu_torch as cmt
    with plan.bind():
        model = models.TransformerLM(
            **dict(LM_CFG, max_len=LMP_SEQ), tp_axis='model',
            generator=torch.Generator().manual_seed(0))
    opt = torch.optim.Adam(model.parameters(), lr=1e-3)
    if not zero:
        opt = cmt.create_multi_node_optimizer(opt, comm)
    rng = np.random.RandomState(1)
    data = [(rng.randint(0, LM_CFG['vocab_size'], LMP_SEQ).astype(np.int32),
             rng.randint(0, LM_CFG['vocab_size'], LMP_SEQ).astype(np.int32))]
    up = training.StandardUpdater(
        training.SerialIterator(data, 1, shuffle=False), opt,
        models.lm_loss(model), model, comm, zero=zero)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, times = [], []
    for _ in range(LMP_TP_STEPS):
        t0 = time.perf_counter()
        losses.append(up.update()['loss'])
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    counts, tc = ops.launch_counts(), ops.tc_launch_counts()
    params = [p.detach().clone() for p in model.parameters()]
    state = sum(v.numel() for s in (up._zero.optimizer if zero
                                     else opt.actual_optimizer).state.values()
                for v in s.values() if torch.is_tensor(v) and v.dim())
    return losses, params, counts, tc, times, state


def phase_lm_parallel(records):
    """The LM's parallel axes at full width on one card: rows 4-8 at the
    path's shapes; the train_lm twin at ``--seq-len 8192 --batchsize 1``
    under Ulysses and under the ring (each scheme over a ring of one, the
    sequence axis bound); then the tensor-parallel TransformerLM on the
    plan's degraded (1, 1) through ``StandardUpdater(comm=
    plan.communicator())`` with ``zero=False`` and ``zero=True``, whose
    trajectories must be bit-equal in a world of one (deterministic
    algorithms on: the embedding's backward adds rows in a fixed
    order)."""
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import MeshPlan
    gen = torch.Generator(device='cuda').manual_seed(16)
    _lmp_kernel_cases(gen, records)
    paths, readings = {}, {}
    paths['lm_parallel_ulysses'], readings['ulysses'] = _lmp_twin('ulysses')
    paths['lm_parallel_ring'], readings['ring'] = _lmp_twin('ring')
    gc.collect()
    torch.cuda.empty_cache()
    plan = MeshPlan.create(tp=2)
    comm = plan.communicator()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = {z: _lmp_tp(plan, comm, z) for z in (False, True)}
    finally:
        torch.use_deterministic_algorithms(False)
        comm.close()
    (l0, p0, c0, tc0, t0, s0), (l1, p1, c1, tc1, t1, s1) = (runs[False],
                                                             runs[True])
    if plan.describe()['axes'] != {'data': 1, 'model': 1}:
        raise AssertionError('a plan of tp=2 on one card: %s'
                             % plan.describe())
    if l0 != l1 or not all(torch.equal(a, b) for a, b in zip(p0, p1)):
        raise AssertionError('zero=True left the zero=False trajectory: '
                             'losses %s vs %s' % (l0, l1))
    if not all(math.isfinite(v) for v in l0) or not l0[-1] < l0[1]:
        raise AssertionError('tp losses %s' % l0)
    layers = LM_CFG['n_layers']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=(2 * layers + 1) * LMP_TP_STEPS,
                flash_fwd=layers * LMP_TP_STEPS,
                flash_bwd_dq=layers * LMP_TP_STEPS,
                flash_bwd_dkv=layers * LMP_TP_STEPS,
                cross_entropy=LMP_TP_STEPS)
    for c in (c0, c1):
        if c != want:
            raise AssertionError('tp launch counts %s, expected %s'
                                 % (c, want))
    counts = {k: c0[k] + c1[k] for k in c0}
    paths['lm_parallel_tp'] = with_tc(
        'lm_parallel tp', counts, {k: tc0[k] + tc1[k] for k in tc0})
    _say('lm-parallel', 'tensor-parallel TransformerLM on the plan %s '
         '(requested tp 2): zero=False and zero=True over %d calls bit-equal '
         '(losses %s); Adam state %d elements either way (N = 1); call ms '
         'zero=False %s, zero=True %s' % (
             plan.describe()['axes'], LMP_TP_STEPS,
             ', '.join('%.4f' % v for v in l0), s0,
             ', '.join('%.1f' % (1e3 * t) for t in t0),
             ', '.join('%.1f' % (1e3 * t) for t in t1)))
    if s0 != s1:
        raise AssertionError('Adam state %d vs %d elements at N = 1'
                             % (s0, s1))
    _say('lm-parallel', 'readings %s' % json.dumps(readings))
    return paths


# the pipeline (phase 12): the LM path's widths and its 8 x 1024 tokens
# a step through MeshPipelineUpdater on the plan's degraded (1, 1, 1),
# n_micro 4, Policy.bf16(), AdamW; three runs of LMPP_STEPS steps
LMPP_MICRO = 4
LMPP_STEPS = 10
LMPP_RUNS = (('gpipe', 'gpipe', False), ('remat', 'gpipe', True),
             ('1f1b', '1f1b', False))
# the steps whose trace is held to the wrappers' counts: the first whose
# trace holds them settles it, as the twin's windows do
LMPP_PROFILED = tuple(3 + 2 * i for i in range(PROFILE_TRIES))
LMPP_TWIN_ARGV = ['--stages', '1', '--vocab', '32000', '--d-model', '512',
                  '--n-heads', '8', '--layers-per-stage', '6', '--seq-len',
                  '1024', '--batchsize', '8', '--micro', '4', '--steps',
                  str(LMPP_STEPS)]
LMPP_MNIST_ARGV = ['--stages', '1', '--epoch', '1']


def _lmpp_want(schedule, remat, steps, guard=False):
    """The kernel launches of ``steps`` pipelined steps of the LM at one
    stage, worked from the schedules' code (L layers, M micro-batches):
    gpipe runs each micro-batch's forward once (2 LayerNorms and a flash
    forward a layer), the loss once over the stacked outputs (the final
    LayerNorm, one cross-entropy), and one flash backward a layer and
    micro-batch; ``remat`` runs every forward twice; 1F1B's forward slot
    on the last stage only stashes its input (its output is never
    read), its backward slot recomputes the forward and evaluates the
    loss per micro-batch.  ``guard``: plus 1F1B's first-step probes of
    the stage body (forward and backward of one micro-batch) and the
    loss (forward)."""
    from chainermn_tpu_torch import ops
    layers, m = LM_CFG['n_layers'], LMPP_MICRO
    fwd = layers * m * (2 if remat else 1)
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=2 * fwd + (1 if schedule == 'gpipe' else m),
                flash_fwd=fwd, flash_bwd_dq=layers * m,
                flash_bwd_dkv=layers * m,
                cross_entropy=1 if schedule == 'gpipe' else m)
    want = {k: v * steps for k, v in want.items()}
    if guard:
        for k, v in (('layer_norm', 2 * layers + 1), ('flash_fwd', layers),
                     ('flash_bwd_dq', layers), ('flash_bwd_dkv', layers),
                     ('cross_entropy', 1)):
            want[k] += v
    return want


def _lmpp_batch(seed=0):
    import numpy as np
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, LM_CFG['vocab_size'],
                       (LM_BATCH, LM_SEQ)).astype(np.int32)
    tgts = rng.randint(0, LM_CFG['vocab_size'],
                       (LM_BATCH, LM_SEQ)).astype(np.int32)
    return [(toks[i], tgts[i]) for i in range(LM_BATCH)]


def _adamw(params):
    import torch
    return torch.optim.AdamW(params, lr=1e-3)


def _lmpp_updater(plan, model, schedule, remat, optimizer=_adamw):
    """``MeshPipelineUpdater`` over ``pipeline_parts(model, None, 1)``
    (gpipe with the global loss, 1F1B with the local one: the same value
    at one data replica), bf16 with f32 masters, AdamW 1e-3."""
    from chainermn_tpu_torch import models, training
    from chainermn_tpu_torch.precision import Policy
    sf, pro, ll, st, ex = models.pipeline_parts(
        model, None, plan.pipe_size, local_loss=schedule == '1f1b')
    return training.MeshPipelineUpdater(
        iter([]), optimizer, sf, ll, st, plan, n_micro=LMPP_MICRO,
        schedule=schedule, remat=remat, prologue=pro, extra_params=ex,
        policy=Policy.bf16())


def _traced_step(what, step):
    """``step()`` under ``torch.profiler`` (after ``trace_prelude``),
    held by ``_settle_trace``, whose ``(counts, busy share)`` or None it
    returns.  Logs the step's device ms and its host ops with the most
    self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from chainermn_tpu_torch import ops
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trace_prelude('cuda')
        since = dict(ops.launch_counts())
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    settled = _settle_trace(prof, since, ops.launch_counts(), wall_us, what)
    if settled is None:
        return None
    host = sorted(((e.self_cpu_time_total, e.key) for e in
                   prof.key_averages() if e.device_type ==
                   torch.autograd.DeviceType.CPU), reverse=True)
    kernels = sorted(((us, k) for k, us in _kernel_times(prof).items()),
                     reverse=True)
    _say('profile', '%s: device %.2f ms of a %.2f ms profiled step; host '
         'ops by self ms: %s; kernels by device ms: %s' % (
             what, settled[1] * wall_us / 1e3, wall_us / 1e3,
             ', '.join('%s %.2f' % (k[:40], us / 1e3)
                       for us, k in host[:8]),
             ', '.join('%s %.2f' % (k[:60], us / 1e3)
                       for us, k in kernels[:8])))
    return settled


def _lmpp_run(name, upd, batch, schedule, remat):
    """``LMPP_STEPS`` steps of one updater on one fixed batch: the path's
    launch counts (set to 0 just before, read just after), the losses,
    the step p50 after two warm-ups outside the profiled step, peak
    memory and the busy share of a profiled step whose kernels are held
    to the schedule's launches."""
    import torch
    from chainermn_tpu_torch import ops
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    losses, seconds, traced, profiled = [], [], None, set()
    for s in range(LMPP_STEPS):
        def step():
            losses.append(float(upd.update_core(upd.shard_batch(batch))
                                ['loss']))
        if traced is None and s in LMPP_PROFILED:
            profiled.add(s)
            traced = _traced_step('lm_pipeline_%s' % name, step)
            if traced is not None:
                want = _lmpp_want(schedule, remat, 1)
                if traced[0] != {k: want[k] for k in LM_EVENTS}:
                    raise AssertionError(
                        '%s: a step launched %s, the schedule implies %s'
                        % (name, traced[0], want))
            continue
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        seconds.append((s, time.perf_counter() - t0))
    torch.cuda.synchronize()
    counts, tc = ops.launch_counts(), ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = _lmpp_want(schedule, remat, LMPP_STEPS,
                      guard=schedule == '1f1b')
    if counts != want:
        raise AssertionError('%s: launch counts %s, expected %s'
                             % (name, counts, want))
    if traced is None:
        raise AssertionError('%s: %d traces without a device event or with '
                             'kernels lost' % (name, len(LMPP_PROFILED)))
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError('%s: losses %s' % (name, losses))
    steps = sorted(t for s, t in seconds if s >= 2)
    p50 = steps[len(steps) // 2]
    tokens = LM_BATCH * LM_SEQ
    reading = dict(p50_ms=1e3 * p50, tokens_per_s=tokens / p50,
                   peak_gib=peak / 2 ** 30, busy=traced[1])
    _say('lm-pipeline', '%s (schedule %s, remat %s, n_micro %d): losses %s; '
         'step p50 %.2f ms over %d steps = %.1f tokens/s; peak memory '
         '%.2f GiB; busy %.1f%% over a profiled step; kernels in its trace '
         '%s; launches %s' % (
             name, schedule, remat, LMPP_MICRO,
             ', '.join('%.4f' % v for v in losses), reading['p50_ms'],
             len(steps), reading['tokens_per_s'], reading['peak_gib'],
             100 * reading['busy'], traced[0], counts))
    return with_tc('lm_pipeline %s' % name, counts, tc), reading


def _hold_leaves(what, got, want, rtol=5e-2):
    """Each leaf of ``got`` within ``rtol`` of the largest entry of the
    same leaf of ``want`` (name -> tensor): bf16 rounding in another
    order moves entries that cancel to about 0 by their own size."""
    worst = ('', 0.0)
    for key, w in want.items():
        g = got[key].float().cpu()
        w = w.float().cpu()
        err = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        worst = max(worst, (key, err), key=lambda kv: kv[1])
        if not err <= rtol:
            raise AssertionError('%s: %s off by %.3g of its largest entry '
                                 '(rtol %g)' % (what, key, err, rtol))
    return worst


def _stage_named(upd, leaf_fn):
    """The pipeline updater's leaves by the unpipelined model's names
    (one stage: the stacked leaves' row i is ``block_i``)."""
    out = {}
    names = {'embedding': 'embed.embedding', 'lm_head': 'lm_head'}
    for path, p in _flat(upd.stage_params):
        for i in range(p.shape[0]):
            out['block_%d.%s' % (i, path.replace('/', '.'))] = \
                leaf_fn(p)[i]
    for path, p in _flat(upd.extra_params):
        head, _, rest = path.partition('/')
        key = names.get(head, head) + ('.' + rest if rest else '')
        out[key] = leaf_fn(p)
    return out


def _sgd(params):
    import torch
    return torch.optim.SGD(params, lr=0.1)


def _lmpp_one_step(plan, model):
    """One step of gpipe, of 1F1B and of the unpipelined
    ``StandardUpdater`` (``lm_loss``, the same weights, bf16 with f32
    masters) on one batch: the gradients and the step's update of the
    f32 masters (after less before), gpipe against 1F1B and against the
    unpipelined step.  The update is held, not the parameters after it:
    next to the weights it is too small for a relative hold of the
    parameters to see a skipped, doubled or misscaled step.  The step is
    SGD: an Adam first step moves every entry by about its learning rate
    in the sign of its gradient, so the rounding noise of a gradient
    that is 0 in exact arithmetic (the key bias's) would move it by a
    whole step either way."""
    import copy
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, training
    from chainermn_tpu_torch.precision import Policy
    batch = _lmpp_batch(1)
    grads, updates = {}, {}
    for schedule in ('gpipe', '1f1b'):
        upd = _lmpp_updater(plan, model, schedule, False, _sgd)
        before = _stage_named(upd, lambda p: p.detach().clone())
        upd.update_core(upd.shard_batch(batch))
        grads[schedule] = _stage_named(upd, lambda p: p.grad)
        updates[schedule] = {k: p - before[k] for k, p in _stage_named(
            upd, lambda p: p.detach()).items()}
        del upd
    comm = cmt.create_communicator('xla')
    try:
        twin = copy.deepcopy(model)
        before = {k: p.detach().clone() for k, p in twin.named_parameters()}
        up = training.StandardUpdater(
            training.SerialIterator(batch, LM_BATCH, shuffle=False),
            _sgd(twin.parameters()), models.lm_loss(twin), twin, comm,
            policy=Policy.bf16())
        up.update()
    finally:
        comm.close()
    grads['plain'] = {k: p.grad for k, p in twin.named_parameters()}
    updates['plain'] = {k: p.detach() - before[k]
                        for k, p in twin.named_parameters()}
    out = {}
    for other in ('1f1b', 'plain'):
        out['grads gpipe vs %s' % other] = _hold_leaves(
            'gradients, gpipe vs %s' % other, grads['gpipe'], grads[other])
        out['updates gpipe vs %s' % other] = _hold_leaves(
            'the step\'s update, gpipe vs %s' % other,
            updates['gpipe'], updates[other])
    _say('lm-pipeline', 'one step on one batch, each leaf within 5e-2 of '
         'its largest entry (worst leaf, error): %s' % out)


def _lmpp_twins():
    """The twins in-process: ``train_lm_pipeline`` at the LM path's
    widths (f32, as the JAX example: the scalar flash kernels) and
    ``train_mnist_pipeline`` for one epoch under both schedules."""
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.examples.lm import train_lm_pipeline
    from chainermn_tpu_torch.examples.mnist import train_mnist_pipeline
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    out = train_lm_pipeline.main(LMPP_TWIN_ARGV)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = _lmpp_want('gpipe', False, LMPP_STEPS)
    if counts != want:
        raise AssertionError('train_lm_pipeline: launch counts %s, expected '
                             '%s' % (counts, want))
    losses = out['losses']
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError('train_lm_pipeline: losses %s' % losses)
    steps = sorted(out['step_seconds'][2:])
    p50 = steps[len(steps) // 2]
    _say('lm-pipeline', 'twin train_lm_pipeline %s (f32): losses %s; step '
         'p50 %.2f ms = %.1f tokens/s; peak memory %.2f GiB; launches %s'
         % (' '.join(LMPP_TWIN_ARGV), ', '.join('%.4f' % v for v in losses),
            1e3 * p50, out['tokens_per_step'] / p50, peak / 2 ** 30, counts))
    del out
    for schedule in ('gpipe', '1f1b'):
        t0 = time.perf_counter()
        res = train_mnist_pipeline.main(LMPP_MNIST_ARGV + ['--schedule',
                                                           schedule])
        seconds = time.perf_counter() - t0
        val = res['validation']
        losses = res['losses']
        if not (all(math.isfinite(v) for v in losses)
                and losses[-1] < losses[0] and val['accuracy'] > 0.9):
            raise AssertionError('train_mnist_pipeline --schedule %s: first '
                                 'loss %r, last %r, validation %s'
                                 % (schedule, losses[0], losses[-1], val))
        _say('lm-pipeline', 'twin train_mnist_pipeline %s --schedule %s: %d '
             'updates, loss %.4f -> %.4f, validation %s, %.1f s'
             % (' '.join(LMPP_MNIST_ARGV), schedule, len(losses), losses[0],
                losses[-1], val, seconds))
    return counts


def phase_lm_pipeline(records):
    """Pipeline parallelism at the LM path's full width on one card:
    rows 4-8 at the micro-batch shapes (``(2, 1024, 8, 64)``, 2048 rows);
    ``MeshPipelineUpdater`` on ``MeshPlan.create(tp=1, pp=2)``'s
    degraded ``(1, 1, 1)`` under gpipe, gpipe with ``remat`` and 1F1B,
    with the launches of each run and of a profiled step held to the
    schedule's; one step of gpipe against 1F1B and against the
    unpipelined step; the twins."""
    import torch
    import torch.distributed as dist
    from chainermn_tpu_torch import models
    from chainermn_tpu_torch.parallel import MeshPlan
    gen = torch.Generator(device='cuda').manual_seed(17)
    _lmp_kernel_cases(gen, records, 'lm_pipeline',
                      (LM_BATCH // LMPP_MICRO, LM_SEQ))
    plan = MeshPlan.create(tp=1, pp=2)
    made = plan._owns_group
    try:
        _say('lm-pipeline', 'plan %s' % json.dumps(plan.describe()))
        if plan.describe()['axes'] != {'data': 1, 'model': 1, 'pipe': 1}:
            raise AssertionError('a plan of pp=2 on one card: %s'
                                 % plan.describe())
        model = models.TransformerLM(
            **LM_CFG, generator=torch.Generator().manual_seed(0))
        _lmpp_one_step(plan, model)
        paths, readings = {}, {}
        batch = _lmpp_batch()
        for name, schedule, remat in LMPP_RUNS:
            upd = _lmpp_updater(plan, model, schedule, remat)
            paths['lm_pipeline_' + name], readings[name] = _lmpp_run(
                name, upd, batch, schedule, remat)
            del upd
        del model
        paths['lm_pipeline_twin'] = _lmpp_twins()
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    _say('lm-pipeline', 'readings %s' % json.dumps(readings))
    return paths


# expert parallelism (phase `moe`): six moe_transformer_blocks at the LM
# path's widths (d 512, 8 heads of 64), 8 experts of d_ff 2048 each,
# capacity factor 1.25, on MeshPlan.create(ep=8)'s degraded (1, 1)
MOE_EXPERTS = 8
MOE_FF = 2048
MOE_CF = 1.25
MOE_AUX = 0.01                 # the aux loss's weight in the loss
MOE_WARMUP = 2
MOE_STEPS = 10
MOE_CHECK_BATCH = 2            # hold B: one f32 block, card vs CPU
MOE_CHECK_TOL = (1e-4, 1e-5)
MOE_GAP = 1e-6                 # a top-two gap under it may flip a route


def _moe_tree(seed):
    """The six blocks' GLOBAL parameter trees (numpy, from ``seed``):
    LayerNorms at 1 / 0, ``wqkv`` and ``wo`` drawn at ``d ** -0.5``, ``bo``
    0, and ``MoELayer.init_params`` for the experts."""
    import numpy as np
    from chainermn_tpu_torch.parallel import MoELayer
    d, h = LM_CFG['d_model'], LM_CFG['n_heads']
    rng = np.random.RandomState(seed)
    layer = MoELayer(capacity_factor=MOE_CF)
    blocks = []
    for i in range(LM_CFG['n_layers']):
        blocks.append({
            'ln1_scale': np.ones(d, np.float32),
            'ln1_bias': np.zeros(d, np.float32),
            'wqkv': (rng.standard_normal((d, 3, h, d // h))
                     * d ** -0.5).astype(np.float32),
            'wo': (rng.standard_normal((d, d)) * d ** -0.5).astype(
                np.float32),
            'bo': np.zeros(d, np.float32),
            'ln2_scale': np.ones(d, np.float32),
            'ln2_bias': np.zeros(d, np.float32),
            'moe': layer.init_params(seed * 100 + i, d, MOE_FF, MOE_EXPERTS,
                                     MOE_EXPERTS)})
    return blocks


def _moe_local(plan, block, device):
    """This process's shard of one block's tree (the experts cut by
    ``MeshPlan.expert_param_specs``) as f32 parameters on ``device``."""
    import torch
    from chainermn_tpu_torch import models
    moe = block['moe']
    local = models.shard_variables(moe, plan.expert_param_specs(moe),
                                   plan.mesh)

    def own(v):
        return torch.nn.Parameter(torch.from_numpy(v).to(device))

    out = {k: own(v) for k, v in block.items() if k != 'moe'}
    out['moe'] = {k: own(v) for k, v in local.items()}
    return out


def _moe_hold_dispatch(gen):
    """Hold A: ``sort_dispatch`` bit-equal to ``dense_dispatch_reference``
    on the card in f32 at ``(8192, 512)``, with a third of the rows sent
    to expert 0 and a capacity of 1024 (rows a expert at capacity factor
    1), so that expert drops rows."""
    import torch
    from chainermn_tpu_torch.parallel import (dense_dispatch_reference,
                                              sort_dispatch)
    rows, d, e = LM_BATCH * LM_SEQ, LM_CFG['d_model'], MOE_EXPERTS
    cap = rows // e
    x = torch.randn((rows, d), generator=gen, device='cuda')
    idx = torch.where(
        torch.rand(rows, generator=gen, device='cuda') < 1 / 3,
        torch.zeros(rows, dtype=torch.long, device='cuda'),
        torch.randint(0, e, (rows,), generator=gen, device='cuda'))
    out = torch.randn((e, cap, d), generator=gen, device='cuda')
    s_in, s_comb, s_keep = sort_dispatch(x, idx, e, cap)
    d_in, d_comb, d_keep = dense_dispatch_reference(x, idx, e, cap)
    for what, a, b in (('expert_in', s_in, d_in), ('keep', s_keep, d_keep),
                       ('combine', s_comb(out), d_comb(out))):
        if not torch.equal(a, b):
            raise AssertionError('moe: sort_dispatch %s differs from the '
                                 'dense reference (max %.3g)' % (
                                     what, max_err(a.float(), b.float())))
    dropped = 1.0 - float(s_keep.float().mean())
    if not dropped > 0:
        raise AssertionError('moe: the dispatch hold dropped no row')
    _say('moe', 'hold A: sort_dispatch bit-equal to the dense reference at '
         '(%d, %d) f32, %d experts, capacity %d, %.4f of the rows dropped'
         % (rows, d, e, cap, dropped))


def _moe_hold_block(plan, tree):
    """Hold B: block 0 in f32 on the card (kernels) against the same block
    on the CPU (plain versions) at batch ``MOE_CHECK_BATCH``: the routes
    (a token whose expert differs fails unless its top-two gap is under
    ``MOE_GAP``, then it is reported and left out), the output, the aux
    loss and the dropped fraction within ``MOE_CHECK_TOL``."""
    import numpy as np
    import torch
    from chainermn_tpu_torch.parallel import MoELayer, moe as moe_mod
    from chainermn_tpu_torch.parallel import moe_transformer_block
    d = LM_CFG['d_model']
    rng = np.random.RandomState(3)
    x = rng.standard_normal((MOE_CHECK_BATCH, LM_SEQ, d)).astype(np.float32)
    layer = MoELayer(capacity_factor=MOE_CF)
    routes, outs = [], {}
    route = moe_mod._route

    def capture(params, xx, k=1):
        got = route(params, xx, k)
        routes.append(tuple(t.detach().cpu() for t in got))
        return got

    moe_mod._route = capture
    try:
        for dev in ('cuda', 'cpu'):
            params = _moe_local(plan, tree[0], dev)
            with plan.bind(), torch.no_grad():
                y, aux = moe_transformer_block(
                    torch.from_numpy(x).to(dev), params, layer,
                    n_heads=LM_CFG['n_heads'])
            outs[dev] = (y.cpu(), float(aux['aux_loss']),
                         float(aux['dropped_fraction']))
    finally:
        moe_mod._route = route
    (_, idx_c, _), (probs, idx_p, _) = routes
    differ = (idx_c != idx_p).any(-1)
    top2 = probs.float().sort(-1, descending=True).values
    gap = top2[:, 0] - top2[:, 1]
    flipped = differ & (gap >= MOE_GAP)
    if bool(flipped.any()):
        raise AssertionError('moe: %d tokens routed to another expert on the '
                             'card than on the CPU with a top-two gap of at '
                             'least %g' % (int(flipped.sum()), MOE_GAP))
    keep = ~differ.reshape(MOE_CHECK_BATCH, LM_SEQ)
    check_close('moe block (f32, card vs CPU)', outs['cuda'][0][keep],
                outs['cpu'][0][keep], *MOE_CHECK_TOL)
    for i, what in ((1, 'aux_loss'), (2, 'dropped_fraction')):
        check_close('moe block %s' % what, torch.tensor(outs['cuda'][i]),
                    torch.tensor(outs['cpu'][i]), *MOE_CHECK_TOL)
    _say('moe', 'hold B: block 0 at (%d, %d, %d) f32, card vs CPU: output '
         'max err %.3g over %d tokens, %d near-tie routes left out (gap < '
         '%g), aux %.6f / %.6f, dropped %.4f / %.4f' % (
             MOE_CHECK_BATCH, LM_SEQ, d,
             max_err(outs['cuda'][0][keep], outs['cpu'][0][keep]),
             int(keep.sum()), int(differ.sum()), MOE_GAP, outs['cuda'][1],
             outs['cpu'][1], outs['cuda'][2], outs['cpu'][2]))


def _moe_want(steps):
    """A step's launches: two LayerNorms and one flash forward, dq and
    dk/dv a block."""
    from chainermn_tpu_torch import ops
    layers = LM_CFG['n_layers']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=2 * layers * steps, flash_fwd=layers * steps,
                flash_bwd_dq=layers * steps, flash_bwd_dkv=layers * steps)
    return want


def _moe_run(plan, tree, k):
    """The path ``moe_k<k>``: the six blocks driven as the JAX tests drive
    them (a loss, its backward, the replicated leaves' gradients summed
    over the expert axis, a plain optimizer step): ``Policy.bf16()``
    compute over f32 masters, AdamW 1e-3, the loss ``sum(y**2)`` over the
    global element count plus ``MOE_AUX`` times the blocks' aux losses
    (each process's share), on one fixed input ``(8, 1024, 512)``.
    ``MOE_WARMUP`` + ``MOE_STEPS`` timed steps, then a profiled one."""
    import numpy as np
    import torch
    from chainermn_tpu_torch import ops
    from chainermn_tpu_torch.parallel import (MoELayer, moe_transformer_block,
                                              sum_grads)
    from chainermn_tpu_torch.precision import Policy
    policy = Policy.bf16()
    ep = plan.expert_size
    blocks = [_moe_local(plan, b, 'cuda') for b in tree]
    params = [p for b in blocks for _, p in _flat(b)]
    replicated = [p for b in blocks for key, p in _flat(b)
                  if key not in ('moe/w_in', 'moe/w_out')]
    opt = torch.optim.AdamW(params, lr=1e-3)
    layer = MoELayer(capacity_factor=MOE_CF, k=k)
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.standard_normal(
        (LM_BATCH, LM_SEQ, LM_CFG['d_model'])).astype(np.float32)).to(
            'cuda', torch.bfloat16)
    losses, drops = [], []

    def step():
        opt.zero_grad(set_to_none=True)
        with plan.bind():
            h, auxes, dropped = x, [], []
            for b in blocks:
                h, aux = moe_transformer_block(
                    h, policy.cast_to_compute(b), layer,
                    n_heads=LM_CFG['n_heads'])
                auxes.append(aux['aux_loss'])
                dropped.append(aux['dropped_fraction'])
            loss = (h.float().square().sum() / (h.numel() * ep)
                    + MOE_AUX * torch.stack(auxes).sum() / ep)
            loss.backward()
        sum_grads(replicated, plan.mesh, axes=('expert',))
        opt.step()
        losses.append(loss.detach())
        drops.append(torch.stack(dropped).mean())

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    seconds = []
    for s in range(MOE_WARMUP + MOE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        if s >= MOE_WARMUP:
            seconds.append(time.perf_counter() - t0)
    traced, n = None, MOE_WARMUP + MOE_STEPS
    for _ in range(PROFILE_TRIES):
        traced = _traced_step('moe_k%d' % k, step)
        n += 1
        if traced is not None:
            break
    torch.cuda.synchronize()
    counts, tc = ops.launch_counts(), ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    name = 'moe_k%d' % k
    if counts != _moe_want(n):
        raise AssertionError('%s: launch counts %s over %d steps, expected '
                             '%s' % (name, counts, n, _moe_want(n)))
    if traced is None:
        raise AssertionError('%s: %d traces without a device event or with '
                             'kernels lost' % (name, PROFILE_TRIES))
    if traced[0] != {key: _moe_want(1)[key] for key in LM_EVENTS}:
        raise AssertionError('%s: a traced step launched %s' % (name,
                                                               traced[0]))
    losses = [float(v) for v in losses]
    drops = [float(v) for v in drops]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError('%s: losses %s' % (name, losses))
    if not all(0.0 <= v < 1.0 for v in drops):
        raise AssertionError('%s: dropped fractions %s' % (name, drops))
    p50 = sorted(seconds)[len(seconds) // 2]
    tokens = LM_BATCH * LM_SEQ
    reading = dict(p50_ms=1e3 * p50, tokens_per_s=tokens / p50,
                   peak_gib=peak / 2 ** 30, busy=traced[1],
                   dropped_fraction=drops[-1],
                   launches_per_step=_moe_want(1))
    _say('moe', '%s (k %d, %d experts of d_ff %d, capacity factor %.2f, '
         'capacity %d a block): losses %s; dropped fraction %s; step p50 '
         '%.2f ms over %d steps = %.1f tokens/s; peak memory %.2f GiB; busy '
         '%.1f%% over a profiled step; launches %s over %d steps' % (
             name, k, MOE_EXPERTS, MOE_FF, MOE_CF,
             max(1, int(MOE_CF * tokens * k // MOE_EXPERTS)),
             ', '.join('%.4f' % v for v in losses),
             ', '.join('%.4f' % v for v in drops), reading['p50_ms'],
             len(seconds), reading['tokens_per_s'], reading['peak_gib'],
             100 * reading['busy'], counts, n))
    return with_tc(name, counts, tc), reading


def _ln_policy_case(gen, records, path):
    """LayerNorm at the path's ``(8192, 512)`` bf16 rows with bf16 gamma /
    beta (what a ``Policy.bf16()`` cast hands it) against its plain
    version within ``BF16_TOL``, timed beside ``F.layer_norm`` (the row's
    ``other_shapes[path]``)."""
    import torch
    import torch.nn.functional as F
    from chainermn_tpu_torch import ops
    rows, d = LM_BATCH * LM_SEQ, LM_CFG['d_model']
    x = (torch.randn((rows, d), generator=gen, device='cuda') * 3
         + 1).to(torch.bfloat16)
    g = (torch.randn(d, generator=gen, device='cuda') + 1).to(torch.bfloat16)
    b = torch.randn(d, generator=gen, device='cuda').to(torch.bfloat16)
    got, want = ops.ln_forward(x, g, b), ops.layer_norm_reference(x, g, b)
    check_close('layer_norm %s bf16 gamma (%s)' % ((rows, d), path), got,
                want, *BF16_TOL)
    t = timings(lambda: ops.ln_forward(x, g, b),
                lambda: ops.layer_norm_reference(x, g, b),
                lambda: F.layer_norm(x, (d,), g, b, 1e-6), iters=20)
    t.update(zip(('bound_ms', 'bound_by'), bound_ms(
        2 * rows * d * 2 + 2 * d * 2, 8 * rows * d)))
    row = dict(shape=[rows, d], gamma='bfloat16',
               max_abs_err=max_err(got, want), **t)
    _say(path.replace('_', '-'), 'layer_norm at %s, bf16 gamma: max err '
         '%.3g; %s; bound %.5f ms by %s' % (
             (rows, d), row['max_abs_err'], _fmt(row), row['bound_ms'],
             row['bound_by']))
    rec = {r['name']: r for r in records}['layer_norm']
    rec.setdefault('other_shapes', {})[path] = row
    rec['max_abs_err'] = max(rec['max_abs_err'], row['max_abs_err'])


def phase_moe(records):
    """Expert parallelism at the LM path's widths on one card: hold A
    (the dispatch) and hold B (a block, card vs CPU), LayerNorm with the
    policy's bf16 gamma, then the paths ``moe_k1`` and ``moe_k2``."""
    import torch
    import torch.distributed as dist
    from chainermn_tpu_torch.parallel import MeshPlan
    gen = torch.Generator(device='cuda').manual_seed(23)
    _moe_hold_dispatch(gen)
    _ln_policy_case(gen, records, 'moe')
    plan = MeshPlan.create(ep=MOE_EXPERTS)
    made = plan._owns_group
    try:
        d = plan.describe()
        _say('moe', 'plan %s' % json.dumps(d))
        if d['axes'] != {'data': 1, 'expert': 1} or d['requested_ep'] != \
                MOE_EXPERTS or plan.model_size != 1:
            raise AssertionError('a plan of ep=%d on one card: %s'
                                 % (MOE_EXPERTS, d))
        tree = _moe_tree(0)
        _moe_hold_block(plan, tree)
        paths, readings = {}, {}
        for k in (1, 2):
            paths['moe_k%d' % k], readings['moe_k%d' % k] = _moe_run(
                plan, tree, k)
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
    _say('moe', 'readings %s' % json.dumps(readings))
    return paths


# mesh-aware trust ratios under ZeRO-1 (phase `zero_trust`)
ZT_WARMUP = 2
ZT_STEPS = 10
ZT_SNAPSHOT = 5                # (c): the straight run's step to snapshot
LARS_KW = dict(weight_decay=5e-5, trust_coefficient=0.001, momentum=0.9)
LARS_LR = 2.0
LAMB_LR = 1e-3
LAMB_WD = 0.01


def _zt_calls(up, batch_of, n, after=None):
    """``n`` calls of ``up.update_core`` on the fixed batch; returns the
    losses (device scalars) and each call's seconds; ``after(i)`` runs
    after call ``i``, outside its time."""
    import torch
    losses, seconds = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(up.update_core(batch_of(up))['loss'])
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        if after is not None:
            after(i)
    return losses, seconds


def _zt_resnet(comm, train):
    """(a) the path ``resnet_lars``: ResNet-50 ``fused_norm=True`` at batch
    64, ``StandardUpdater(zero=True, policy=Policy.bf16())`` over
    ``zero.lars`` on the slice plan's communicator: one broadcast call,
    ``ZT_WARMUP`` warm-ups, ``ZT_STEPS`` timed steps."""
    import torch
    from chainermn_tpu_torch import models, ops, training
    from chainermn_tpu_torch.parallel import zero
    from chainermn_tpu_torch.precision import Policy
    _free()
    torch.manual_seed(0)
    model = models.ResNet50(fused_norm=True)
    clf = models.StatefulClassifier(model)
    up = training.StandardUpdater(
        iter([]), zero.lars(model.parameters(), LARS_LR, **LARS_KW),
        clf.loss, model, comm, zero=True, policy=Policy.bf16())
    batch = up.shard_batch(train[:BATCH])
    start = [p.detach().clone() for p in model.parameters()]
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    n = 1 + ZT_WARMUP + ZT_STEPS
    losses, seconds = _zt_calls(up, lambda _: batch, n)
    counts, tc = ops.launch_counts(), ops.tc_launch_counts()
    peak = torch.cuda.max_memory_allocated()
    _check_counts('resnet_lars', counts, _want(n, n, 0))
    losses = [float(v) for v in losses]
    moved = max(float((p.detach() - q).abs().max())
                for p, q in zip(model.parameters(), start))
    if not all(math.isfinite(v) for v in losses) or not moved > 0:
        raise AssertionError('resnet_lars: losses %s, moved %g'
                             % (losses, moved))
    # the first call broadcasts instead of stepping
    if abs(losses[0] - losses[1]) > 1e-3 * max(1.0, abs(losses[0])):
        raise AssertionError('resnet_lars: loss at call 0 %r != call 1 %r'
                             % (losses[0], losses[1]))
    if not losses[-1] < losses[1]:
        raise AssertionError('resnet_lars: the loss did not fall: %s'
                             % losses)
    timed = sorted(seconds[1 + ZT_WARMUP:])
    p50 = timed[len(timed) // 2]
    reading = dict(p50_ms=1e3 * p50, images_per_s=BATCH / p50,
                   peak_gib=peak / 2 ** 30)
    _say('zero-trust', 'resnet_lars (ResNet-50 fused_norm, batch %d, bf16 '
         'compute, f32 masters, ZeRO-1 over %d data processes, zero.lars lr '
         '%g %s): losses %s; step p50 %.2f ms over %d steps = %.1f images/s; '
         'peak memory %.2f GiB; launches %s over %d calls' % (
             BATCH, comm.size, LARS_LR, LARS_KW,
             ', '.join('%.4f' % v for v in losses), reading['p50_ms'],
             len(timed), reading['images_per_s'], reading['peak_gib'],
             counts, n))
    return with_tc('resnet_lars', counts, tc), reading


def _zt_lm(comm):
    """The LM training path's model, LAMB and updater: ``StandardUpdater(
    zero=True, policy=Policy.bf16())`` over ``zero.lamb``."""
    import torch
    from chainermn_tpu_torch import models, training
    from chainermn_tpu_torch.parallel import zero
    from chainermn_tpu_torch.precision import Policy
    model = models.TransformerLM(
        **LM_CFG, generator=torch.Generator().manual_seed(0))
    return training.StandardUpdater(
        training.SerialIterator(_lmpp_batch(), LM_BATCH, shuffle=False),
        zero.lamb(model.parameters(), LAMB_LR, weight_decay=LAMB_WD),
        models.lm_loss(model), model, comm, zero=True, policy=Policy.bf16())


def _zt_lm_run(comm):
    """(b) the path ``lm_lamb`` and (c) its snapshot: the LM with LAMB,
    one broadcast call, ``ZT_WARMUP`` warm-ups and ``ZT_STEPS`` timed
    steps on one fixed batch; after step ``ZT_SNAPSHOT`` a snapshot
    (``serializers.updater_state``, npz with the manifest) is written
    outside the step's time, then resumed with ``resume_updater(
    elastic=True)`` into a fresh updater whose following steps must be
    bit-equal to the straight run's (losses and parameters), with
    ``resharded`` False."""
    import shutil
    import tempfile
    import torch
    from chainermn_tpu_torch import ops, serializers
    up = _zt_lm(comm)
    tmp = tempfile.mkdtemp(prefix='zero_trust_')
    path = os.path.join(tmp, 'lm_lamb.npz')

    def snapshot(i):
        if i == ZT_SNAPSHOT:
            serializers.save_npz(path, serializers.updater_state(up),
                                 mesh_shape=serializers.mesh_shape_of(up))

    def batch_of(u):
        return u.shard_batch(next(u.iterator))

    try:
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        n = 1 + ZT_WARMUP + ZT_STEPS
        losses, seconds = _zt_calls(up, batch_of, n, after=snapshot)
        counts, tc = ops.launch_counts(), ops.tc_launch_counts()
        peak = torch.cuda.max_memory_allocated()
        params = [p.detach().clone() for p in up.model.parameters()]
        del up
        _free()
        fresh = _zt_lm(comm)
        info = serializers.resume_updater(path, fresh, elastic=True)
        resumed, _ = _zt_calls(fresh, batch_of, n - ZT_SNAPSHOT - 1)
        mb = os.path.getsize(path) / 2 ** 20
        same = all(torch.equal(p.detach(), q) for p, q in zip(
            fresh.model.parameters(), params))
        del fresh
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    layers = LM_CFG['n_layers']
    want = dict.fromkeys(ops.KERNELS, 0)
    want.update(layer_norm=(2 * layers + 1) * n, flash_fwd=layers * n,
                flash_bwd_dq=layers * n, flash_bwd_dkv=layers * n,
                cross_entropy=n)
    _check_counts('lm_lamb', counts, want)
    losses = [float(v) for v in losses]
    resumed = [float(v) for v in resumed]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[1]:
        raise AssertionError('lm_lamb: losses %s' % losses)
    if info['resharded'] or info['iteration'] != ZT_SNAPSHOT + 1:
        raise AssertionError('lm_lamb: resume gave %s' % {
            k: v for k, v in info.items() if k != 'manifest'})
    if resumed != losses[ZT_SNAPSHOT + 1:] or not same:
        raise AssertionError(
            'lm_lamb: the resumed steps are not bit-equal to the straight '
            'run: losses %s vs %s, parameters equal %s'
            % (resumed, losses[ZT_SNAPSHOT + 1:], same))
    timed = sorted(seconds[1 + ZT_WARMUP:])
    p50 = timed[len(timed) // 2]
    tokens = LM_BATCH * LM_SEQ
    reading = dict(p50_ms=1e3 * p50, tokens_per_s=tokens / p50,
                   peak_gib=peak / 2 ** 30, snapshot_mib=mb)
    _say('zero-trust', 'lm_lamb (TransformerLM, %d x %d tokens, bf16 compute, '
         'f32 masters, ZeRO-1, zero.lamb %g weight_decay %g): losses %s; step '
         'p50 %.2f ms over %d steps = %.1f tokens/s; peak memory %.2f GiB; '
         'launches %s over %d calls' % (
             LM_BATCH, LM_SEQ, LAMB_LR, LAMB_WD,
             ', '.join('%.4f' % v for v in losses), reading['p50_ms'],
             len(timed), reading['tokens_per_s'], reading['peak_gib'],
             counts, n))
    _say('zero-trust', 'snapshot after call %d (%.1f MiB, manifest mesh_shape '
         '%s) resumed with resharded %s: calls %d..%d bit-equal to the '
         'straight run (losses %s), parameters bit-equal' % (
             ZT_SNAPSHOT + 1, mb, info['manifest']['mesh_shape'],
             info['resharded'], ZT_SNAPSHOT + 2, n,
             ', '.join('%.6f' % v for v in resumed)))
    return with_tc('lm_lamb', counts, tc), reading


def phase_zero_trust():
    """Mesh-aware LARS / LAMB under ZeRO-1 with a policy, on the slice
    plan ``MeshPlan.create(slices=2)`` degraded to ``(1, 1, 1)``: the
    paths ``resnet_lars`` and ``lm_lamb``, and a snapshot resumed
    through the elastic path."""
    import torch.distributed as dist
    from chainermn_tpu_torch.parallel import MeshPlan
    plan = MeshPlan.create(slices=2)
    made = plan._owns_group
    comm = plan.communicator()
    try:
        d = plan.describe()
        _say('zero-trust', 'plan %s' % json.dumps(d))
        if d['axes'] != {'slice': 1, 'data': 1, 'model': 1} or \
                d['requested_slices'] != 2 or comm.data_axes != (
                    'slice', 'data'):
            raise AssertionError('a plan of slices=2 on one card: %s' % d)
        paths, readings = {}, {}
        paths['resnet_lars'], readings['resnet_lars'] = _zt_resnet(
            comm, _precision_batch())
        _free()
        paths['lm_lamb'], readings['lm_lamb'] = _zt_lm_run(comm)
    finally:
        comm.close()
        if made and dist.is_initialized():
            dist.destroy_process_group()
    _say('zero-trust', 'readings %s' % json.dumps(readings))
    return paths


# fault-tolerant training (phase 15): the LM training path of phase 10
# under the port's supervisor, one worker process on the card a scenario
SUP_STEPS = 8                  # update() calls: 1 broadcast + 7 steps
# (name, chaos spec, checkpoint interval, the failure's cause, resumed at)
SUP_SCENARIOS = (('a', None, 0, None, None),
                 ('b', 'sigterm_step=@3', 0, 'preempted', 4),
                 ('c', 'kill_step=@5', 2, 'killed', 4),
                 ('d', 'hang_step=@4', 2, 'hang', 4))
SUP_STALL = 6.0                # s without an iteration advance is a hang
SUP_GRACE = 240.0              # s a new worker may take to its first step
SUP_TERM_GRACE = 3.0           # s between the SIGTERM and the SIGKILL
SUP_TIMED = 5                  # steps timed in each checkpoint mode
SUP_DIR = os.path.join('build', 'chip_smoke_supervised')


def _params_digest(tree):
    """sha256 over a numpy tree's leaves in path order (path, dtype,
    shape, bytes): equal digests are bit-equal trees."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()

    def walk(node, prefix):
        for key in sorted(node):
            value = node[key]
            if isinstance(value, dict):
                walk(value, prefix + key + '/')
                continue
            a = np.ascontiguousarray(value)
            h.update(('%s%s %s %s' % (prefix, key, a.dtype,
                                      a.shape)).encode())
            h.update(a.tobytes())

    walk(tree, '')
    return h.hexdigest()


def supervised_worker():
    """The supervised worker (``python3 chip_smoke.py --supervised-worker``,
    started by the ``supervised`` phase's ``Supervisor``): join the world
    from the ``CMN_SUP_*`` handout (NCCL on the card), heartbeat into
    ``$CMN_SUP_LIVE``, build the LM training path of phase 10, resume the
    newest valid snapshot (``auto_resume``), then run to ``CMN_SUP_STEPS``
    calls with a ``PreemptionHandler`` (asynchronous writes, each waited
    for) and a checkpoint every ``CMN_SUP_CKPT_EVERY`` steps.  After every
    call ``workers/a<N>-rank<R>.json`` is rewritten with the losses by
    iteration and the kernel launch counts so far, so a killed attempt
    leaves its record; the last write adds the final parameters' digest.
    Returns ``'preempted'`` after a preemption snapshot.  ``marks`` are the
    wall times the start-up reached: this function, the imports, the
    process group, the model and updater, the resume."""
    marks = {'entry': time.time()}
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import ops, telemetry
    from chainermn_tpu_torch.training import recovery
    from chainermn_tpu_torch.training import supervisor as sup
    from chainermn_tpu_torch.utils import failure
    marks['imported'] = time.time()
    device = sup.handout_device()
    rank, _ = sup.init_process_group(device)
    out = os.environ[sup.ENV_OUT]
    attempt = int(os.environ[sup.ENV_ATTEMPT])
    steps = int(os.environ[sup.ENV_STEPS])
    ckpt_every = int(os.environ[sup.ENV_CKPT_EVERY])
    hb = failure.Heartbeat(os.path.join(
        os.environ[sup.ENV_LIVE], 'heartbeat-%d.json' % rank),
        interval=0.2).start()
    comm = cmt.create_communicator('xla', device=device)
    marks['group'] = time.time()
    preempted = False
    try:
        _, updater = _lm_training(comm)
        marks['model'] = time.time()
        ckdir = os.path.join(out, 'state')
        handler = recovery.PreemptionHandler(updater, out=ckdir,
                                             async_=True)
        resumed = recovery.auto_resume(updater, ckdir)
        marks['resumed'] = time.time()
        res = {'attempt': attempt, 'resumed_at': resumed, 'marks': marks,
               'losses': {}}
        sup.write_worker_json(out, attempt, rank, res)
        hb.beat(updater.iteration)
        ops.reset_launch_counts()
        while updater.iteration < steps:
            it = updater.iteration
            res['losses'][str(it)] = updater.update()['loss']
            marks.setdefault('first_step', time.time())
            res['calls'] = res.get('calls', 0) + 1
            res['counts'] = ops.launch_counts()
            res['tc'] = ops.tc_launch_counts()
            hb.beat(updater.iteration)
            sup.write_worker_json(out, attempt, rank, res)
            if handler.maybe_checkpoint():
                preempted = True
                break
            if (ckpt_every and updater.iteration < steps
                    and updater.iteration % ckpt_every == 0):
                handler.checkpoint()
                handler.wait()
        torch.cuda.synchronize()
        res.update(final_iteration=updater.iteration,
                   snapshot=handler.checkpoint_path,
                   digest=_params_digest(updater.params))
        sup.write_worker_json(out, attempt, rank, res)
    finally:
        hb.stop()
        comm.close()
    telemetry.flush()
    return 'preempted' if preempted else None


def _sup_attempts(out):
    """The worker records of a scenario's attempts, in order."""
    import glob
    paths = sorted(glob.glob(os.path.join(out, 'workers', 'a*-rank0.json')),
                   key=lambda p: int(os.path.basename(p)[1:].split('-')[0]))
    records = []
    for path in paths:
        with open(path) as f:
            records.append(json.load(f))
    return records


def _sup_log_tail(out, n=40):
    import glob
    tails = []
    for path in sorted(glob.glob(os.path.join(out, 'logs', '*.log'))):
        with open(path, errors='replace') as f:
            lines = f.read().splitlines()[-n:]
        tails.append('--- %s\n%s' % (path, '\n'.join(lines)))
    return '\n'.join(tails)


def _sup_scenario(name, spec, ckpt_every):
    """One ``Supervisor(nprocs=1)`` run of the worker under ``spec``;
    returns ``(ledger entries, attempts' records, supervisor seconds)``."""
    import shutil
    from chainermn_tpu_torch.training.supervisor import (
        RestartPolicy, Supervisor)
    from chainermn_tpu_torch.utils import failure
    from chainermn_tpu_torch.utils.ledger import Ledger
    out = os.path.abspath(os.path.join(SUP_DIR, name))
    shutil.rmtree(out, ignore_errors=True)
    env = {k: v for k, v in os.environ.items()
           if k != 'CHAINERMN_TPU_CHAOS'}
    if spec:
        env['CHAINERMN_TPU_CHAOS'] = spec
    sup = Supervisor(
        nprocs=1, out=out,
        worker_argv=[sys.executable, os.path.abspath(__file__),
                     '--supervised-worker'],
        steps=SUP_STEPS, ckpt_every=ckpt_every,
        policy=RestartPolicy(max_restarts=2, backoff=failure.Backoff(
            initial=0.1, max_delay=1.0)),
        stall_timeout=SUP_STALL, startup_grace=SUP_GRACE,
        term_grace=SUP_TERM_GRACE, drain_grace=SUP_TERM_GRACE,
        attempt_timeout=600.0, poll_interval=0.1, oracle=False, env=env,
        device='cuda')
    t0 = time.perf_counter()
    rc = sup.run()
    wall = time.perf_counter() - t0
    ledger = Ledger.read(sup.ledger.path)
    if rc != 0:
        raise AssertionError('scenario %s: the supervisor exited %d; ledger '
                             '%s\n%s' % (name, rc, ledger, _sup_log_tail(out)))
    return out, ledger, _sup_attempts(out), wall


def _startup_split(marks, launched):
    """Seconds from the launch to each start-up mark, mark by mark."""
    out, last = {}, launched
    for key in ('entry', 'imported', 'group', 'model', 'resumed',
                'first_step'):
        out[key] = round(marks[key] - last, 3)
        last = marks[key]
    return out


def _sup_events(ledger, kind):
    return [e for e in ledger if e.get('event') == kind]


def _hold_scenario(name, cause, resumed_at, ledger, attempts, oracle):
    """The ledger's events and the worker records of one scenario against
    the contract: one failure of ``cause`` (none for the oracle), a
    restart, the recovery at ``resumed_at``, completion; every loss by
    iteration and the final parameters bit-equal to the oracle's."""
    fails = _sup_events(ledger, 'failure')
    comp = _sup_events(ledger, 'complete')
    if len(comp) != 1:
        raise AssertionError('%s: complete events %s' % (name, comp))
    if cause is None:
        if fails or len(attempts) != 1:
            raise AssertionError('%s: the oracle failed: %s' % (name, fails))
    else:
        if len(fails) != 1 or fails[0]['cause'] != cause \
                or fails[0]['rank'] != 0:
            raise AssertionError('%s: failures %s, expected one %r of rank '
                                 '0' % (name, fails, cause))
        f = fails[0]
        if cause == 'preempted' and f['rank_exit_codes'] != {'0': 71}:
            raise AssertionError('%s: exit codes %s' % (
                name, f['rank_exit_codes']))
        if cause == 'killed' and not (f.get('chaos_site') == 'kill_step'
                                      and f.get('doctor_agrees') is True):
            raise AssertionError('%s: %s' % (name, f))
        if cause == 'hang' and not (
                f.get('chaos_site') == 'hang_step'
                and f['exit_classes']['0'] in ('signal:SIGKILL',
                                               'signal:SIGTERM')):
            raise AssertionError('%s: %s' % (name, f))
        decs = _sup_events(ledger, 'decision')
        recs = _sup_events(ledger, 'recovered')
        if [d['action'] for d in decs] != ['restart'] or len(recs) != 1 \
                or recs[0]['resumed_step'] != resumed_at \
                or not recs[0]['downtime_s'] > 0 \
                or comp[0]['restarts'] != 1 \
                or comp[0]['mttr_s'] != recs[0]['downtime_s'] \
                or len(attempts) != 2 \
                or attempts[1]['resumed_at'] != resumed_at:
            raise AssertionError('%s: decisions %s, recovered %s, complete '
                                 '%s, resumed %s' % (
                                     name, decs, recs, comp,
                                     [a['resumed_at'] for a in attempts]))
    last = attempts[-1]
    if last['final_iteration'] != SUP_STEPS:
        raise AssertionError('%s: ended at %s' % (name,
                                                  last['final_iteration']))
    if oracle is not None:
        for a in attempts:
            for it, loss in a['losses'].items():
                if loss != oracle['losses'][it]:
                    raise AssertionError(
                        '%s: attempt %d loss at iteration %s %r != the '
                        "oracle's %r" % (name, a['attempt'], it, loss,
                                         oracle['losses'][it]))
        if last['digest'] != oracle['digest']:
            raise AssertionError('%s: final parameters differ from the '
                                 "oracle's" % name)


def _sup_counts(name, attempts):
    """A scenario's kernel launches over its attempts (``<name>.tc``
    beside), each attempt held to its calls: 13 LayerNorm, 6 of each
    flash kernel (on the tensor cores) and 1 cross-entropy a call."""
    total = {}
    layers = LM_CFG['n_layers']
    per_call = dict(layer_norm=2 * layers + 1, flash_fwd=layers,
                    flash_bwd_dq=layers, flash_bwd_dkv=layers,
                    cross_entropy=1)
    for a in attempts:
        want = {k: per_call.get(k, 0) * a['calls'] for k in a['counts']}
        if a['counts'] != want:
            raise AssertionError('%s attempt %d: launches %s, expected %s'
                                 % (name, a['attempt'], a['counts'], want))
        for k, v in with_tc('supervised_%s' % name, a['counts'],
                            a['tc']).items():
            total[k] = total.get(k, 0) + v
    return total


def _sup_checkpoint_modes():
    """In this process, outside the supervisor: the LM step's p50 with no
    checkpoint, with a synchronous ``checkpoint()`` every step and with
    ``async_=True`` every step (its time to return: the host copy and the
    hand-over), the writer's drain after the last, and the snapshot's
    size."""
    import shutil
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch.training import recovery
    out = os.path.abspath(os.path.join(SUP_DIR, 'modes'))
    shutil.rmtree(out, ignore_errors=True)
    comm = cmt.create_communicator('xla')
    try:
        _, updater = _lm_training(comm)
        sync = recovery.PreemptionHandler(
            updater, out=os.path.join(out, 'sync'), signals=())
        asyn = recovery.PreemptionHandler(
            updater, out=os.path.join(out, 'async'), signals=(),
            async_=True)
        for _ in range(3):                 # the broadcast call, 2 warm-ups
            updater.update()
        times = {}
        for mode, handler in (('none', None), ('sync', sync),
                              ('async', asyn)):
            ts = []
            for _ in range(SUP_TIMED):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                updater.update()
                if handler is not None:
                    handler.checkpoint()
                torch.cuda.synchronize()
                ts.append(time.perf_counter() - t0)
            times[mode] = sorted(ts)[len(ts) // 2]
        t0 = time.perf_counter()
        asyn.wait()
        drain = time.perf_counter() - t0
        size = os.path.getsize(sync.checkpoint_path)
        writer = asyn.writer
        readings = {
            'step_p50_ms': {k: 1e3 * v for k, v in times.items()},
            'async_drain_s': drain, 'snapshot_bytes': size,
            'async_submitted': writer.submitted,
            'async_committed': writer.committed,
            'async_coalesced': writer.coalesced}
    finally:
        comm.close()
        shutil.rmtree(out, ignore_errors=True)
    return readings


def phase_supervised():
    """Fault-tolerant training on the card: the LM training path of
    phase 10 (full width, 8 x 1024 tokens a step, Adam) as the
    supervisor's custom worker, one process on NCCL, under four
    scenarios: (a) no fault, the oracle; (b) ``sigterm_step=@3``: the
    preemption snapshot, exit 71, a restart that resumes; (c)
    ``kill_step=@5`` with a checkpoint every 2 steps: ``killed``, rank 0,
    site ``kill_step``, the doctor agreeing, resumed at 4; (d)
    ``hang_step=@4``: the frozen iteration caught after ``SUP_STALL``,
    SIGTERM then SIGKILL, cause ``hang``, resumed.  Each supervisor must
    exit 0; (b)-(d)'s losses and final parameters must be bit-equal to
    (a)'s.  Prints each recovery's downtime, the goodput share, the
    workers' start-up to their first step, the snapshot size and the
    step p50 by checkpoint mode."""
    import shutil
    from chainermn_tpu_torch.telemetry import goodput
    _free()
    paths, readings, oracle = {}, {}, None
    try:
        for name, spec, every, cause, resumed_at in SUP_SCENARIOS:
            out, ledger, attempts, wall = _sup_scenario(name, spec, every)
            if oracle is None:
                oracle = attempts[0]
            _hold_scenario(name, cause, resumed_at, ledger, attempts,
                           None if cause is None else oracle)
            paths['supervised_%s' % name] = _sup_counts(name, attempts)
            launches = {a['attempt']: e['t'] for a, e in zip(
                attempts, _sup_events(ledger, 'launch'))}
            gp = goodput.build_goodput(out)
            rec = _sup_events(ledger, 'recovered')
            readings[name] = {
                'spec': spec, 'supervisor_s': wall,
                'cause': cause,
                'downtime_s': rec[0]['downtime_s'] if rec else None,
                'mttr_s': _sup_events(ledger, 'complete')[0]['mttr_s'],
                'goodput_fraction': gp.get('goodput_fraction'),
                'buckets_s': gp.get('buckets_s'),
                'startup_s': [a['marks']['first_step']
                              - launches[a['attempt']] for a in attempts],
                'startup_split_s': [_startup_split(
                    a['marks'], launches[a['attempt']]) for a in attempts],
                'snapshot': attempts[-1].get('snapshot')}
            _say('supervised', '%s %s: %s' % (name, spec or 'no fault',
                                              json.dumps(readings[name])))
            if name == 'b':
                readings['snapshot_mib'] = os.path.getsize(
                    attempts[0]['snapshot']) / 2 ** 20
            shutil.rmtree(os.path.join(out, 'state'), ignore_errors=True)
        readings['modes'] = _sup_checkpoint_modes()
    finally:
        shutil.rmtree(SUP_DIR, ignore_errors=True)
    _say('supervised', 'MTTR by cause (s): %s; goodput %s' % (
        ', '.join('%s %.3f' % (readings[n]['cause'], readings[n]['mttr_s'])
                  for n in 'bcd'),
        ', '.join('%s %.4f' % (n, readings[n]['goodput_fraction'])
                  for n in 'abcd')))
    _say('supervised', 'start-up to the first step (s): %s' % ', '.join(
        '%s %s' % (n, ' / '.join('%.2f' % t
                                 for t in readings[n]['startup_s']))
        for n in 'abcd'))
    _say('supervised', 'start-up split, launch to each mark (s): a %s; '
         'c after the kill %s' % (json.dumps(readings['a'][
             'startup_split_s'][0]), json.dumps(readings['c'][
                 'startup_split_s'][-1])))
    modes = readings['modes']
    _say('supervised', 'snapshot %.1f MiB; LM step p50 ms: no checkpoint '
         '%.2f, sync checkpoint every step %.2f, async every step %.2f '
         '(drain %.2f s; %d submitted, %d committed, %d coalesced)' % (
             readings['snapshot_mib'], modes['step_p50_ms']['none'],
             modes['step_p50_ms']['sync'], modes['step_p50_ms']['async'],
             modes['async_drain_s'], modes['async_submitted'],
             modes['async_committed'], modes['async_coalesced']))
    return paths


# ---------------------------------------------------------------------
# the replica fleet (serving/fleet.py) at full width

FLEET_SLOTS = 8
FLEET_PROMPT = 128             # max_prompt_len; traffic prompts 4..128
FLEET_NEW = 32
FLEET_KILL_PROMPT = 96         # (c): prompt + emitted prefix fits 128
FLEET_PINNED = (40, 57, 72, 88, FLEET_KILL_PROMPT)   # (c): pinned lengths
FLEET_CANARY_S = 4.0
FLEET_SLOW = 0.12              # (b): serve_slow on the canary, s a call
# s between the canary judge's readings: the slowed canary prefills its
# first admissions (up to 8 x FLEET_SLOW) before its first decode tick,
# so a first reading at 2 s holds inter-token samples, not only TTFT ones
FLEET_JUDGE_S = 2.0
# (b)'s offered req/s: the slowed canary must drain what it admitted
# before it swaps back (nothing is shed), so it gets a light load
FLEET_BREACH_RATE = 10.0
# the canary judge's latency floor (ms): healthy replicas' TTFT p99 moved
# by up to ~75 ms between windows on the card, while a FLEET_SLOW canary
# is hundreds of ms over its incumbent
FLEET_FLOOR_MS = 100.0
FLEET_BURST = 64               # listener cost: requests of a burst
FLEET_DIR = os.path.join('build', 'chip_smoke_fleet')
FLEET_CLI_ARGV = ['--model', 'serve', '--replicas', '2', '--n-slots', '8',
                  '--max-prompt-len', '128', '--max-new-tokens', '32',
                  '--rate', '20', '--debounce', '0.2', '--duration', '1',
                  '--canary-seconds', '2', '--min-events', '4',
                  '--latency-floor-ms', '%g' % FLEET_FLOOR_MS,
                  '--roll-timeout', '150']


def _fleet_counts(engines, since, fresh=()):
    """A fleet window's launches: the wrappers' counts (the swap
    validations' and the trainer's eager launches, and the warm-up runs
    of engines built in the window, less what those engines' captures
    recorded) plus every engine's graph replays since ``since`` (``{id:
    stats()['replays']}``) times the launches captured."""
    from chainermn_tpu_torch import ops
    counts, tc = dict(ops.launch_counts()), dict(ops.tc_launch_counts())
    for eng in engines:
        graph = eng.replayed_launches(since.get(id(eng)))
        for k in counts:
            counts[k] += graph.get(k, 0)
        for k in tc:
            tc[k] += graph.get(k + '.tc', 0)
    for eng in fresh:
        for call in eng._calls.values():
            if call.graph is None:
                continue
            for k, n in call.launches.items():
                if k.endswith('.tc'):
                    tc[k[:-3]] -= n
                else:
                    counts[k] -= n
    out = dict(counts)
    out.update(('%s.tc' % k, n) for k, n in tc.items() if n)
    return out


def _fleet_since(engines):
    return {id(e): e.stats()['replays'] for e in engines}


def _fleet_captures(replicas):
    return [r.engine.stats()['compile_count'] for r in replicas]


class _TokenClock:
    """Samples a traffic generator's served tokens every 50 ms on a
    thread: tokens/s over any wall-clock interval."""

    def __init__(self, traffic):
        import threading
        self.traffic = traffic
        self.samples = [(time.time(), 0)]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.05):
            self.samples.append((time.time(), self.traffic.tokens))

    def at(self, t):
        best = self.samples[0]
        for s in self.samples:
            if s[0] <= t:
                best = s
        return best

    def rate(self, t0, t1):
        a, b = self.at(t0), self.at(t1)
        return (b[1] - a[1]) / max(b[0] - a[0], 1e-9)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=5.0)


def _slo_line(ev):
    """TTFT and inter-token p50 / p99 (ms) of a replica's SLO evaluation,
    from its fast window."""
    rows = (ev or {}).get('slos') or {}

    def pair(name):
        fast = (rows.get(name) or {}).get('fast') or {}
        if not fast.get('count'):
            return 'no samples'
        return 'p50 %.3f p99 %.3f ms (n %d)' % (
            fast['p50'] * 1e3, fast['p99'] * 1e3, fast['count'])
    return 'TTFT %s; inter-token %s' % (pair('ttft_p99'),
                                        pair('intertoken_p99'))


def _fleet_roll(ctl, ck, version, traffic=None, timeout=180.0):
    """A snapshot at ``version`` written by ``demo_train`` (full width, on
    the card) while the controller runs; returns when it was handled."""
    import threading
    from chainermn_tpu_torch.serving import fleet
    stop = threading.Event()
    thread = threading.Thread(target=ctl.run, args=(stop,), daemon=True)
    thread.start()
    try:
        fleet.demo_train(ck, steps=2, snapshot_every=2,
                         config=fleet.SERVE_MODEL)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if ctl.last_handled_version == version:
                break
            time.sleep(0.05)
    finally:
        stop.set()
        thread.join(timeout=60.0)
    if thread.is_alive() or ctl.last_handled_version != version:
        raise AssertionError('fleet: the roll of version %d was not handled '
                             '(last %r)' % (version, ctl.last_handled_version))


def _fleet_burst(front):
    """``FLEET_BURST`` requests at once through the front: tokens/s to
    the last result."""
    import numpy as np
    from chainermn_tpu_torch.serving import fleet
    rng = np.random.RandomState(5)
    vocab = fleet.SERVE_MODEL['vocab_size']
    t0 = time.perf_counter()
    handles = [front.submit(rng.randint(0, vocab, size=n), FLEET_NEW)
               for n in rng.randint(4, FLEET_PROMPT + 1, size=FLEET_BURST)]
    tokens = sum(len(h.result(timeout=120.0)) for h in handles)
    return tokens / (time.perf_counter() - t0)


def _fleet_fresh_streams(path, version, prompts):
    """The prompts one at a time through a fresh engine booted from
    snapshot ``path`` (the fleet's geometry and policy, its own graphs)."""
    import torch
    from chainermn_tpu_torch import precision, serving
    from chainermn_tpu_torch.serving import fleet
    model, template = fleet.demo_params(config=fleet.SERVE_MODEL,
                                        device='meta', dtype=torch.bfloat16)
    eng = serving.GenerationEngine.from_checkpoint(
        path, model, template, n_slots=FLEET_SLOTS,
        max_prompt_len=FLEET_PROMPT, policy=precision.Policy.bf16(),
        version=version)
    eng.warmup()
    out = []
    for p in prompts:
        q = serving.GenerationQueue(FLEET_PROMPT)
        req = q.submit(p, FLEET_NEW)
        _drain(eng, q, [req])
        out.append(req.result(timeout=0).tolist())
    return out


def _fleet_rolls(smi, say):
    """(b) then (a): the in-process bf16 fleet.  Returns its paths and
    readings."""
    import numpy as np
    from chainermn_tpu_torch import ops, precision, serving
    from chainermn_tpu_torch.serving import fleet
    from chainermn_tpu_torch.telemetry.slo import default_slos
    from chainermn_tpu_torch.utils import chaos
    from chainermn_tpu_torch.utils.ledger import Ledger, events
    ck = os.path.join(FLEET_DIR, 'ckpt')
    out = os.path.join(FLEET_DIR, 'roll')
    paths = {}
    fleet.demo_train(ck, steps=2, snapshot_every=2, config=fleet.SERVE_MODEL)
    boot = os.path.join(ck, 'snapshot_iter_2.npz')
    policy = precision.Policy.bf16()
    # the capacity probe, as phase serve_loadgen's: 2 x slots at once
    model, template = fleet.demo_params(config=fleet.SERVE_MODEL,
                                        device='meta',
                                        dtype=policy.compute_dtype)
    probe_eng = serving.GenerationEngine.from_checkpoint(
        boot, model, template, n_slots=FLEET_SLOTS,
        max_prompt_len=FLEET_PROMPT, policy=policy)
    probe_eng.warmup()
    probe = serving.open_loop_generate(
        probe_eng, serving.GenerationQueue(FLEET_PROMPT, max_queue=256),
        rate=1e9, n_requests=2 * FLEET_SLOTS, seed=1,
        prompt_len_range=(4, FLEET_PROMPT), max_new_tokens=FLEET_NEW)
    del probe_eng
    capacity = probe['tokens_per_s'] / FLEET_NEW
    rate = 0.5 * capacity
    say('capacity probe of one replica (%d slots, %d requests at once): '
        '%.1f tokens/s = %.2f req/s; traffic at half of it, %.2f req/s'
        % (FLEET_SLOTS, 2 * FLEET_SLOTS, probe['tokens_per_s'], capacity,
           rate))
    ctl = fleet.build_local_fleet(
        ck, out, n_replicas=2, n_slots=FLEET_SLOTS,
        max_prompt_len=FLEET_PROMPT, max_queue=256, slos=default_slos(),
        engine_kw=dict(policy=policy), config=fleet.SERVE_MODEL,
        canary_seconds=FLEET_CANARY_S, judge_interval=FLEET_JUDGE_S,
        drain_timeout=60.0, judge=fleet.CanaryJudge(
            latency_ratio=1.5, latency_floor_ms=FLEET_FLOOR_MS,
            min_events=4))
    ctl.watcher.debounce_s = 0.2
    ctl.start()
    engines = [r.engine for r in ctl.replicas]
    caps0 = _fleet_captures(ctl.replicas)
    readings = {'captures_boot': caps0}
    traffic = None
    try:
        def start_traffic(r, seed):
            return fleet._TrafficGen(
                ctl.front, rate=r, max_new_tokens=FLEET_NEW,
                prompt_len_range=(4, FLEET_PROMPT),
                vocab_size=fleet.SERVE_MODEL['vocab_size'],
                seed=seed).start()

        # (b) the canary breach at the boot version
        since = _fleet_since(engines)
        ops.reset_launch_counts()
        traffic = start_traffic(FLEET_BREACH_RATE, 10)
        chaos.install(chaos.FaultInjector('serve_slow=*:%s' % FLEET_SLOW))
        try:
            t0 = time.time()
            _fleet_roll(ctl, ck, 4)
            t1 = time.time()
        finally:
            chaos.uninstall()
        traffic.stop()
        breach_traffic = traffic.stats()
        paths['fleet_breach'] = _fleet_counts(engines, since)
        led = Ledger.read(os.path.join(out, fleet.LEDGER_NAME))
        cv = [e for e in events(led, 'canary_verdict') if e['version'] == 4]
        rb = [e for e in events(led, 'rollback') if e['version'] == 4]
        conv = events(led, 'converged')[-1]
        if not (cv and cv[0]['verdict'] == 'breach'
                and any('intertoken_p99' in x for x in cv[0]['reasons'])
                and rb and rb[0]['to_version'] == 2
                and conv['version'] == 2
                and set(conv['replicas'].values()) == {2}
                and ctl.rollbacks == 1 and ctl.promotes == 0):
            raise AssertionError('fleet (b): no breach and rollback to 2: '
                                 '%s' % [e for e in led
                                         if e['event'] != 'start'])
        say('(b) serve_slow=*:%s on the canary, traffic at %.1f req/s: '
            'verdict %s (%s), rolled back to 2 %.2f s after the trainer '
            'started on 4 (the canary drained for %.2f s); converged %s; '
            'traffic %s; %s' % (
                FLEET_SLOW, FLEET_BREACH_RATE, cv[0]['verdict'],
                '; '.join(cv[0]['reasons']), t1 - t0,
                [e for e in events(led, 'replica_swap')
                 if e.get('rollback')][-1]['drain_s'],
                conv['replicas'], breach_traffic, smi))
        # steady at half of one replica's capacity: no monitor attached,
        # then each replica's (replica, 2)
        traffic = start_traffic(rate, 11)
        clock = _TokenClock(traffic)
        time.sleep(0.5)
        t_a = time.time()
        time.sleep(2.0)
        t_b = time.time()
        for r in ctl.replicas:
            r.reset_slo()
        time.sleep(2.0)
        t_c = time.time()
        steady = (clock.rate(t_a, t_b), clock.rate(t_b, t_c))
        say('steady tokens/s under traffic at %.2f req/s: %.1f without '
            'monitors, %.1f with (open loop: both are the offered load); '
            '%s' % (rate, steady[0], steady[1], smi))
        for r in ctl.replicas:
            say('%s version %d steady: %s; %s' % (
                r.name, r.version, _slo_line(r.slo_eval()), smi))
        # (a) a healthy roll through canary -> promote
        since = _fleet_since(engines)
        ops.reset_launch_counts()
        _fleet_roll(ctl, ck, 6)
        paths['fleet_roll'] = _fleet_counts(engines, since)
        led = Ledger.read(os.path.join(out, fleet.LEDGER_NAME))
        v6 = [e for e in led if e.get('version') == 6
              or e.get('roll_version') == 6]
        names = [e['event'] for e in v6]
        if not ('promote' in names and names.index('version_seen')
                < names.index('roll_start') < names.index('canary_verdict')
                < names.index('promote') < names.index('converged')
                and set(events(v6, 'converged')[-1]['replicas'].values())
                == {6}):
            raise AssertionError('fleet (a): no promote ladder: %s' % v6)
        swaps = [e for e in events(led, 'replica_swap')
                 if e['roll_version'] == 6]
        for s in swaps:
            say('(a) roll of 6, %s: drain %.3f s, swap %.3f s, rejoin '
                '%.3f s (out of rotation %.3f s, shed during it %d); %s' % (
                    s['replica'], s['drain_s'], s['swap_s'],
                    max(0.0, s['out_of_rotation_s'] - s['drain_s']
                        - s['swap_s']),
                    s['out_of_rotation_s'], s['shed_during_swap'], smi))
        first = [e['t'] for e in v6 if e['event'] == 'version_seen'][0]
        last = [e['t'] for e in v6 if e['event'] == 'converged'][-1]
        during = clock.rate(first, last)
        for r, version, window in ((ctl.replicas[0], 6, 'the canary, '
                                    'from its swap on'),
                                   (ctl.replicas[1], 2, 'the incumbent, '
                                    'the canary window')):
            say('%s version %d (%s): %s; %s' % (
                r.name, version, window, _slo_line(r.slo_eval()), smi))
        ctl.replicas[1].reset_slo()     # the promoted incumbent at 6
        time.sleep(2.0)
        say('replica-1 version 6 after the promote: %s; %s' % (
            _slo_line(ctl.replicas[1].slo_eval()), smi))
        say('tokens/s during the roll of 6 (version_seen to converged, '
            '%.2f s): %.1f against %.1f steady; %s' % (
                last - first, during, steady[0], smi))
        traffic.stop()
        clock.stop()
        st = traffic.stats()
        caps = _fleet_captures(ctl.replicas)
        if any(t['shed_submit'] or t['shed_result'] or t['errors']
               or not t['served'] for t in (breach_traffic, st)) \
                or ctl.dropped_during_swap or caps != caps0:
            raise AssertionError('fleet (a)/(b): traffic %s and %s, dropped '
                                 'during swaps %d, captures %s -> %s' % (
                                     breach_traffic, st,
                                     ctl.dropped_during_swap, caps0, caps))
        say('traffic through the steady windows and (a): %s; captures %s '
            'before and after a rollback and a promote; dropped during '
            'swaps %d; %s' % (st, caps, ctl.dropped_during_swap, smi))
        # version 6 after the swaps: a fresh engine booted from snapshot 6
        rng = np.random.RandomState(3)
        prompts = [rng.randint(0, fleet.SERVE_MODEL['vocab_size'], size=n)
                   for n in (4, 17, 64, 128)]
        want = _fleet_fresh_streams(os.path.join(ck, 'snapshot_iter_6.npz'),
                                    6, prompts)
        for r in ctl.replicas:
            # one at a time, as the fresh engine ran them: the same buckets
            got = [r.submit(p, FLEET_NEW).result(timeout=60.0).tolist()
                   for p in prompts]
            if got != want:
                raise AssertionError('fleet: %s at version 6 differs from a '
                                     'fresh engine from snapshot 6' % r.name)
        say('both replicas at version 6 emit exactly what a fresh engine '
            'booted from snapshot 6 emits (%d prompts, one at a time)'
            % len(prompts))
        # the listener's cost: bursts through the front, in turns
        rates = {'off': [], 'on': []}
        for turn in ('off', 'on', 'on', 'off'):
            for r in ctl.replicas:
                if turn == 'on':
                    r.reset_slo()
                elif r._monitor is not None:
                    r._monitor.detach()
                    r._monitor = None
            rates[turn].append(_fleet_burst(ctl.front))
        say('tokens/s of %d requests at once through the front, in turns '
            '(off, on, on, off): without the SLO monitors %s, with %s; %s'
            % (FLEET_BURST, ', '.join('%.1f' % x for x in rates['off']),
               ', '.join('%.1f' % x for x in rates['on']), smi))
        readings.update(steady=steady, during=during, bursts=rates)
    finally:
        if traffic is not None:
            traffic.stop()
        ctl.close()
    return paths, readings


def _fleet_prompts(rng):
    """Five prompts of 40..96 tokens sharing a 24-token prefix (the
    paged mode's radix index shares its pages)."""
    import numpy as np
    from chainermn_tpu_torch.serving import fleet
    vocab = fleet.SERVE_MODEL['vocab_size']
    base = rng.randint(0, vocab, size=24)
    return [np.concatenate([base, rng.randint(0, vocab, size=n - 24)])
            for n in FLEET_PINNED]


def _fleet_kill(mode, bf16, smi, say):
    """(c): a hard kill of the replica serving >= 4 pinned streams,
    mid-decode, under live traffic; returns (counts, equal streams,
    readings)."""
    import numpy as np
    from chainermn_tpu_torch import models, ops, precision, serving
    from chainermn_tpu_torch.serving import fleet
    from chainermn_tpu_torch.training import recovery
    from chainermn_tpu_torch.utils.ledger import Ledger, events
    ck = os.path.join(FLEET_DIR, 'ckpt')
    out = os.path.join(FLEET_DIR, 'kill_%s%s' % (mode, '_bf16' if bf16
                                                 else ''))
    kind, path, it = recovery.latest_snapshot(ck)
    engine_kw = dict(policy=precision.Policy.bf16()) if bf16 else {}
    if mode == 'paged_prefix':
        engine_kw.update(paged=True, page_size=8)
    elif mode == 'speculative':
        draft = fleet.demo_model(config=dict(fleet.SERVE_MODEL, n_layers=1),
                                 seed=1)
        engine_kw.update(draft_model=draft,
                         draft_params=models.param_tree(draft))
    prompts = _fleet_prompts(np.random.RandomState(7))
    # the uninterrupted oracle: the same engine configuration, alone
    model, template = fleet.demo_params(
        config=fleet.SERVE_MODEL, device='meta',
        dtype=fleet._compute_dtype(engine_kw))
    oracle_eng = serving.GenerationEngine.from_checkpoint(
        path, model, template, n_slots=FLEET_SLOTS,
        max_prompt_len=FLEET_PROMPT, **engine_kw)
    oracle_eng.warmup()
    q = serving.GenerationQueue(
        FLEET_PROMPT, page_size=8 if mode == 'paged_prefix' else None)
    reqs = [q.submit(p, FLEET_NEW) for p in prompts]
    _drain(oracle_eng, q, reqs)
    oracle = [r.result(timeout=0).tolist() for r in reqs]
    del oracle_eng
    ctl = fleet.build_local_fleet(
        ck, out, n_replicas=2, n_slots=FLEET_SLOTS,
        max_prompt_len=FLEET_PROMPT, journal=True, engine_kw=engine_kw,
        config=fleet.SERVE_MODEL)
    spawn = fleet.local_respawn_fn(
        n_slots=FLEET_SLOTS, max_prompt_len=FLEET_PROMPT,
        engine_kw=engine_kw, config=fleet.SERVE_MODEL)
    respawned, respawn_s = [], []

    def timed_spawn(**kw):
        t0 = time.perf_counter()
        rep = spawn(**kw)
        respawn_s.append(time.perf_counter() - t0)
        respawned.append(rep.engine)
        return rep

    ctl.start()
    sup = fleet.ReplicaSupervisor(ctl, spawn_fn=timed_spawn)
    front = ctl.front
    engines = [r.engine for r in ctl.replicas]
    traffic = None
    try:
        since = _fleet_since(engines)
        ops.reset_launch_counts()
        traffic = fleet._TrafficGen(
            front, rate=20.0, max_new_tokens=FLEET_NEW,
            prompt_len_range=(4, 64),
            vocab_size=fleet.SERVE_MODEL['vocab_size'], seed=13).start()
        front.replicas[0].state = 'draining'      # pin to replica-1
        handles = [front.submit(p, FLEET_NEW) for p in prompts]
        front.replicas[0].state = 'serving'
        pinned = {h.request_id for h in handles}
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            inf = front.journal.inflight(replica='replica-1')
            if any(inf[rid]['emitted'] for rid in pinned if rid in inf):
                break
            time.sleep(0.001)
        t_kill = time.time()
        front.replicas[1].kill()
        inflight = front.journal.inflight(replica='replica-1')
        n_pinned = len(pinned & set(inflight))
        if n_pinned < 4:
            raise AssertionError('fleet (c) %s: the kill caught %d pinned '
                                 'streams in flight' % (mode, n_pinned))
        sup.check()                   # requeue, then respawn (captures)
        results = [h.result(timeout=120.0).tolist() for h in handles]
        time.sleep(1.5)               # the replacement takes traffic
        traffic.stop()
        st = traffic.stats()
        paths = _fleet_counts(engines + respawned, since, fresh=respawned)
        entries = Ledger.read(os.path.join(out, fleet.LEDGER_NAME))
        requeues = events(entries, 'requeue')
        rec = events(entries, 'recovered')[0]
        replacement = front.replicas[1]
        lost = sup.describe()['lost_requests']
        rst = replacement.engine.stats()
        bad = [what for what, failed in (
            ('unattributed requeues', rec['request_ids']
             != [e['request_id'] for e in requeues]),
            ('requeues shed', rec['shed']), ('lost requests', lost),
            ('traffic errors or sheds', st['errors'] or st['shed_result']),
            ('respawns', len(events(entries, 'respawn')) != 1),
            ('the replacement not serving the incumbent version',
             replacement.version != it or replacement.state != 'serving'),
            ('the replacement served nothing', not rst['prefills']),
            ('the replacement captured no graph',
             _graphed(replacement.engine) and not rst['compile_count']))
            if failed]
        if bad:
            raise AssertionError('fleet (c) %s: %s; ledger %s; traffic %s; '
                                 'lost %s; replacement %s' % (
                                     mode, bad, entries, st, lost, rst))
        # the first token journaled after its own request's requeue
        # (bench.py's MTTR: the victim's last frames do not count)
        journal = Ledger.read(os.path.join(out, fleet.JOURNAL_NAME))
        mttr = min(e['t'] for rq in requeues for e in journal
                   if e.get('event') == 'token'
                   and e['request_id'] == rq['request_id']
                   and e['t'] >= rq['t']) - t_kill
        equal = sum(a == b for a, b in zip(results, oracle))
        say('(c) %s%s: kill of replica-1 with %d requests in flight (%d '
            'pinned); %d requeued, 0 lost; MTTR (kill to the first '
            'journaled token of a continuation) %.3f s; respawn with its '
            'graph captures %.3f s (%d captures) under traffic; %d of %d '
            'pinned streams equal the uninterrupted engine\'s; traffic %s; '
            '%s' % (mode, ' bf16' if bf16 else ' f32', len(inflight),
                    n_pinned, len(rec['request_ids']), mttr, respawn_s[0],
                    replacement.engine.stats()['compile_count'], equal,
                    len(results), st, smi))
        return paths, equal, {'mttr_s': mttr, 'respawn_s': respawn_s[0]}
    finally:
        if traffic is not None:
            traffic.stop()
        sup.stop()
        ctl.close()


def _fleet_orphans(out):
    """PIDs of replica workers still alive whose command line names
    ``out`` (read from /proc)."""
    pids = []
    for pid in os.listdir('/proc'):
        if not pid.isdigit():
            continue
        try:
            with open('/proc/%s/cmdline' % pid, 'rb') as f:
                cmd = f.read().decode(errors='replace')
        except OSError:
            continue
        if '--replica' in cmd and 'serving.fleet' in cmd and out in cmd:
            pids.append(int(pid))
    return pids


def _fleet_cli(smi, say):
    """(d): the CLI with two replica processes on the card: one run whose
    first roll promotes and whose second the chaos ``swap_kill`` cuts
    mid-roll, then a restart that converges."""
    from chainermn_tpu_torch.serving import fleet
    from chainermn_tpu_torch.utils.ledger import Ledger, events
    out = os.path.abspath(os.path.join(FLEET_DIR, 'cli'))
    env = {k: v for k, v in os.environ.items()
           if k not in ('CHAINERMN_TPU_CHAOS', 'CHAINERMN_TPU_TELEMETRY',
                        'CHAINERMN_TPU_REPLICA')}
    env['PYTHONPATH'] = (os.path.dirname(os.path.abspath(__file__))
                         + os.pathsep + env.get('PYTHONPATH', ''))
    ledger_path = os.path.join(out, fleet.LEDGER_NAME)

    def run(extra, chaos_spec=None):
        e = dict(env)
        if chaos_spec:
            e['CHAINERMN_TPU_CHAOS'] = chaos_spec
        n0 = len(Ledger.read(ledger_path))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'chainermn_tpu_torch.serving.fleet',
             '--out', out] + FLEET_CLI_ARGV + extra, env=e,
            capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        deadline = time.monotonic() + 20.0
        while _fleet_orphans(out) and time.monotonic() < deadline:
            time.sleep(0.2)
        left = _fleet_orphans(out)
        if left:
            raise AssertionError('fleet (d): replica workers %s outlived '
                                 'their controller' % left)
        return proc, Ledger.read(ledger_path)[n0:], wall

    # one run: roll 4 promotes (swap points 0 and 1), then swap_kill's
    # occurrence 3, roll 6's first promote swap, kills the controller
    proc, led, wall = run(['--rolls', '2'], chaos_spec='swap_kill=@3:44')
    names = [e['event'] for e in led]
    if (proc.returncode != 44
            or [e['version'] for e in events(led, 'promote')] != [4]
            or [e['version'] for e in events(led, 'roll_start')] != [4, 6]
            or names[-2:] != ['replica_swap', 'canary_verdict']):
        raise AssertionError('fleet (d) roll and swap_kill: rc %s; %s\n%s'
                             % (proc.returncode, led, proc.stderr[-3000:]))
    say('(d) CLI, two replica processes: promoted 4, then swap_kill=@3:44 '
        'killed the controller mid-roll of 6 (exit 44 after %.1f s; the '
        'canary on 6, the incumbent on 4); %s' % (wall, smi))
    proc, led, wall = run(['--rolls', '0'])
    conv = events(led, 'converged')
    comp = events(led, 'complete')
    if (proc.returncode != 0 or len(conv) != 1 or conv[0]['version'] != 6
            or conv[0].get('recovered_roll') != 6
            or set(conv[0]['replicas'].values()) != {6} or not comp
            or comp[0]['traffic']['errors'] or comp[0]['traffic'][
                'shed_result'] or not comp[0]['traffic']['served']):
        raise AssertionError('fleet (d) restart: rc %s; %s\n%s' % (
            proc.returncode, led, proc.stderr[-3000:]))
    boots = [r.get('boot_s') for r in comp[0]['front']['replicas']]
    say('(d) the restart converged on %s (recovered roll %s) and served %s '
        'in %.1f s (exit 0); a replica process\'s start-up (launch to its '
        'warmed engine\'s first answer) %s s; %s' % (
            conv[0]['replicas'], conv[0]['recovered_roll'],
            comp[0]['traffic'], wall, boots, smi))
    return boots


def phase_fleet(smi):
    """The replica fleet (``serving/fleet.py``) at full width on the card:
    the serving ``TransformerLM`` (``fleet.SERVE_MODEL``), snapshots
    written by ``fleet.demo_train`` at that geometry on the card.
    (b) and (a): two ``LocalReplica`` s of ``Policy.bf16()`` engines (8
    slots, prompts 4..128, 32 new tokens) under open-loop traffic at half
    of one replica's probed capacity; a ``serve_slow=*:0.12`` canary
    breaches, rolls back and converges on 2; a healthy roll promotes 6
    with nothing shed, captures flat, and each replica at 6 emitting
    exactly what a fresh engine from snapshot 6 emits; the SLO monitors'
    cost in bursts taken in turns.  (c) f32, journal and
    ``ReplicaSupervisor``: a replica holding >= 4 pinned streams killed
    mid-decode in slab, paged_prefix (page 8) and speculative (a one-layer
    draft) modes, every stream equal to the uninterrupted engine's,
    nothing lost, the respawn capturing its graphs while the survivor
    serves; then slab in bf16 (equal streams counted).  (d) the CLI with
    two replica processes.  Returns the paths' launch counts."""
    import shutil
    from chainermn_tpu_torch import telemetry
    t0 = time.perf_counter()
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    os.makedirs(FLEET_DIR)

    def say(msg):
        _say('fleet', msg)

    marks = [('start', time.perf_counter())]
    installed = telemetry.active() is None
    telemetry.enable()
    try:
        paths, readings = _fleet_rolls(smi, say)
        marks.append(('(b) and (a)', time.perf_counter()))
        for mode in ('slab', 'paged_prefix', 'speculative'):
            counts, equal, r = _fleet_kill(mode, False, smi, say)
            if equal != len(FLEET_PINNED):
                raise AssertionError('fleet (c) %s f32: %d streams equal '
                                     'the oracle\'s' % (mode, equal))
            paths['fleet_kill_' + mode] = counts
            readings['kill_' + mode] = r
        counts, equal, r = _fleet_kill('slab', True, smi, say)
        paths['fleet_kill_slab_bf16'] = counts
        readings['kill_slab_bf16'] = dict(r, equal=equal)
        marks.append(('(c)', time.perf_counter()))
    finally:
        if installed:
            telemetry.disable()
    readings['cli_boot_s'] = _fleet_cli(smi, say)
    marks.append(('(d)', time.perf_counter()))
    say('seconds by part: %s' % ', '.join(
        '%s %.1f' % (name, t - marks[i][1])
        for i, (name, t) in enumerate(marks[1:])))
    for name, counts in sorted(paths.items()):
        say('%s launches: %s' % (name, {k: v for k, v in counts.items()
                                         if v}))
    for need in ('layer_norm', 'flash_fwd', 'flash_decode'):
        if not paths['fleet_roll'].get(need):
            raise AssertionError('fleet_roll launched no %s' % need)
    if not paths['fleet_kill_paged_prefix'].get('flash_decode_paged'):
        raise AssertionError('fleet_kill_paged_prefix launched no '
                             'flash_decode_paged')
    say('the phase %.1f s; %s' % (time.perf_counter() - t0, smi))
    with open(os.path.join(FLEET_DIR, 'readings.json'), 'w') as f:
        json.dump(readings, f, indent=1, default=repr)
    return paths


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
    paths.update(_timed(phase_precision))
    paths['mnist_training'] = _timed(phase_mnist)
    paths['imagenet_training'], thread = _timed(phase_imagenet)
    paths.update(_timed(phase_input, thread))
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
    paths['resnet_serving'], inference = _timed(phase_serve_infer)
    paths.update(_timed(phase_serve_loadgen))
    paths.update(_timed(phase_serve_graphs))
    _timed(phase_lm_check)
    paths['lm_training'] = _timed(phase_lm_main)
    paths.update(_timed(phase_lm_parallel, records))
    paths.update(_timed(phase_lm_pipeline, records))
    paths.update(_timed(phase_moe, records))
    paths.update(_timed(phase_zero_trust))
    paths.update(_timed(phase_supervised))
    paths.update(_timed(phase_fleet, smi))
    _say('time', 'all phases %.1f s' % (time.perf_counter() - t_start))
    for rec in records:
        by_path = {path: counts[rec['name']]
                   for path, counts in paths.items()
                   if counts.get(rec['name'])}
        if not by_path:
            raise AssertionError('no main path launched %s' % rec['name'])
        rec['launches'] = sum(by_path.values())
        rec['launches_by_path'] = by_path
        if rec['name'] == 'bn_apply':
            rec.update(inference)
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
    if sys.argv[1:2] == ['--supervised-worker']:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        from chainermn_tpu_torch.training.supervisor import worker_main
        worker_main(supervised_worker)
    sys.exit(main())
