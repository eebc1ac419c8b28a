"""Inference engine over bucketed batch shapes, one CUDA graph per bucket.

Counterpart of ``chainermn_tpu/serving/engine.py``.  Every request mix is
a new batch shape; the engine serves a fixed set of them:

- **One CUDA graph per bucket.**  For every bucket edge the batcher can
  emit, ``warmup()`` runs the forward twice on a side stream (cuDNN's
  algorithm choice, lazy allocations and the kernels' builds happen
  there) and then captures it once as a ``torch.cuda.CUDAGraph`` over a
  static input and output buffer -- the port's counterpart of the JAX
  engine's per-bucket AOT executable.  ``infer()`` copies the padded
  batch into its bucket's input buffer, replays the graph and returns a
  copy of the output.  A failed capture raises: there is no eager
  fallback on the card.  On the CPU (or with ``aot=False``) the engine
  runs eagerly and reports ``aot`` False for every bucket, as the JAX
  engine does on a runtime without AOT.
- **No-recompile guard.**  The engine refuses any batch whose shape and
  dtype are not one of the bucket signatures (``RuntimeError``) instead
  of capturing a new graph mid-traffic.
- **Weights under a graph.**  A graph reads fixed parameter addresses, so
  :meth:`swap_params` validates a new tree with an eager forward on the
  largest bucket and then copies it into the captured storage in place,
  under the engine's lock and on its stream: a replay already queued
  finishes on the old weights, the next reads the new ones, and no graph
  is captured again.

``policy``: a float :class:`~chainermn_tpu_torch.precision.Policy` casts
the weights at load (an inference engine keeps no f32 masters); an
:class:`~chainermn_tpu_torch.precision.Int8Policy` quantizes them at load
and dequantizes each weight just before the layer that reads it, so the
forward holds the int8 weights and one layer's dequantized weight.

Telemetry: per-batch ``serve_h2d`` / ``serve_execute`` spans and the
``serve_queue_wait`` event; raw-sample histograms ``serve_queue_wait``,
``serve_h2d``, ``serve_execute``, ``serve_pad_waste``,
``serve_batch_items`` and the per-request ``serve_latency_seconds``; and
each request's trace stages ``queue_wait`` -> ``bucket_pack`` ->
``execute`` -> ``complete``.

The chaos site ``serve_slow`` sleeps on the host before an execute of
an engine serving a hot-swapped version (the graph is unchanged); its
queue's ``serve_burst`` is in :mod:`~chainermn_tpu_torch.serving.
batcher`.  No counterpart yet: ``cache_dir`` (a CUDA graph cannot be
persisted, so it is accepted and ``cache_persistent`` stays False) and
sharded serving (``plan`` / ``param_specs`` raise, ROADMAP.md A7).
"""

import contextlib
import copy
import gc
import itertools
import threading
import time

import numpy as np
import torch
from torch import nn
from torch.func import functional_call
from torch.nn.utils import parametrize

from chainermn_tpu_torch import ops
from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.ops import _common
from chainermn_tpu_torch.ops._common import resolve_device
from chainermn_tpu_torch.ops.int8_matmul import dequant
from chainermn_tpu_torch.precision import (
    cast_floating, dequantized_view, is_quantized)
from chainermn_tpu_torch.serving.batcher import bucket_edges
from chainermn_tpu_torch.utils import chaos as _chaos
from chainermn_tpu_torch.utils.failure import WeightSwapError

#: forwards run on a side stream before a bucket's capture
WARM_RUNS = 2


def load_params(path, template, prefix='params'):
    """Read the ``prefix`` subtree of an npz snapshot
    (:func:`chainermn_tpu_torch.serializers.save_npz`) into
    ``template``'s structure, each leaf checked against the template's
    shape and dtype and its crc32; integrity failures raise the typed
    ``CheckpointCorruptError``."""
    from chainermn_tpu_torch import serializers
    by_key, _manifest = serializers.read_npz(path)
    return serializers._fetch_tree(by_key, template, prefix, path)


def module_state(model):
    """A module's parameters and buffers as a nested ``dict`` keyed by
    their attribute paths (``{'fc': {'weight': ..., 'bias': ...}}``),
    the tensors themselves (detached), not copies."""
    out = {}
    for key, t in itertools.chain(model.named_parameters(),
                                  model.named_buffers()):
        path = key.split('.')
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = t.detach()
    return out


def _flat(tree, prefix=''):
    for k, v in tree.items():
        key = prefix + str(k)
        if isinstance(v, dict):
            yield from _flat(v, key + '.')
        else:
            yield key, v


def _walk(fn, tree):
    """``fn`` over the leaves of a nested ``dict`` (a
    :class:`QuantizedLeaf` is one leaf)."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v) for k, v in tree.items()}
    return fn(tree)


def _torch_dtype(dtype):
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype


def _signature(shape, dtype):
    return (tuple(shape), str(dtype).replace('torch.', ''))


def _tensors(y):
    return list(y) if isinstance(y, (tuple, list)) else [y]


def _clone(y):
    if isinstance(y, (tuple, list)):
        return type(y)(t.clone() for t in y)
    return y.clone()


def _host(t):
    """A CPU tensor as numpy where numpy has its dtype (bf16 stays a
    tensor)."""
    return t if t.dtype == torch.bfloat16 else t.numpy()


def params_template(tree):
    """Shapes and dtypes of a tree, as meta tensors: what a checkpoint is
    read against (no copy of the values is kept)."""
    return _walk(lambda x: torch.empty(tuple(x.shape), device='meta',
                                       dtype=_torch_dtype(x.dtype)), tree)


def place_params(tree, device, policy):
    """The load-time transform shared by the serving engines: copy every
    leaf to ``device`` (never aliasing the caller's storage), then
    quantize (an :class:`~chainermn_tpu_torch.precision.Int8Policy`:
    :class:`QuantizedLeaf` s, the other floating leaves in the compute
    dtype) or cast (a float policy) to the compute dtype."""
    def place(x):
        if torch.is_tensor(x):
            return x.detach().to(device, copy=True)
        return torch.from_numpy(np.array(x)).to(device)

    placed = _walk(place, tree)
    if policy is None:
        return placed
    if getattr(policy, 'quantize', None) is not None:
        placed = policy.quantize(placed)

        def cast(x):
            if torch.is_tensor(x) and x.is_floating_point():
                return x.to(policy.compute_dtype)
            return x

        return _walk(cast, placed)
    return cast_floating(placed, policy.compute_dtype)


def copy_params_(dst, src):
    """Copy tree ``src`` into tree ``dst`` leaf by leaf, in place.  Raises
    ``ValueError`` when their structures, shapes or dtypes differ."""
    a, b = dict(_flat(dst)), dict(_flat(src))
    if a.keys() != b.keys():
        raise ValueError('parameter trees differ: %s' % sorted(
            set(a) ^ set(b)))
    pairs = []
    for key, d in a.items():
        s = b[key]
        if is_quantized(d) != is_quantized(s):
            raise ValueError('%s: quantized in one tree only' % key)
        for dt, st in (zip(d[:2], s[:2]) if is_quantized(d)
                       else [(d, s)]):
            if dt.shape != st.shape or dt.dtype != st.dtype:
                raise ValueError('%s: %s %s, new %s %s' % (
                    key, tuple(dt.shape), dt.dtype, tuple(st.shape),
                    st.dtype))
            pairs.append((dt, st))
    for dt, st in pairs:
        dt.copy_(st)


class CaptureGate:
    """Orders the CUDA graph captures of a process against the serving
    calls of its other threads: a capture (:meth:`capture`) waits for the
    calls in flight and holds new ones until it ends, while calls
    (:meth:`call`) run side by side.  The replicas of one process share
    its CUDA context, and a capture on one thread beside another thread's
    replays and copies can be invalidated
    (``cudaErrorStreamCaptureInvalidated``).  While a capture holds it the
    interpreter's cyclic garbage collector is off, so that no thread frees
    CUDA objects of collected cycles inside the capture.  The thread that
    captures may make calls and nested captures; a thread inside a call
    may not capture."""

    def __init__(self):
        self._cond = threading.Condition()
        self._calls = 0
        self._owner = None       # the thread capturing now
        self._depth = 0
        self._gc_was_enabled = False
        self._mine = threading.local()

    @contextlib.contextmanager
    def call(self):
        me = threading.get_ident()
        with self._cond:
            counted = self._owner != me
            if counted:
                while self._owner is not None:
                    self._cond.wait()
                self._calls += 1
        self._mine.calls = getattr(self._mine, 'calls', 0) + 1
        try:
            yield
        finally:
            self._mine.calls -= 1
            if counted:
                with self._cond:
                    self._calls -= 1
                    if not self._calls:
                        self._cond.notify_all()

    @contextlib.contextmanager
    def capture(self):
        me = threading.get_ident()
        with self._cond:
            if self._owner != me:
                if getattr(self._mine, 'calls', 0):
                    raise RuntimeError('a capture inside a serving call '
                                       'would wait for itself')
                while self._owner is not None or self._calls:
                    self._cond.wait()
                self._owner = me
                self._gc_was_enabled = gc.isenabled()
                gc.disable()
            self._depth += 1
        try:
            yield
        finally:
            with self._cond:
                self._depth -= 1
                if not self._depth:
                    self._owner = None
                    if self._gc_was_enabled:
                        gc.enable()
                    self._cond.notify_all()


#: the process's gate: every serving engine's calls and captures pass it
GATE = CaptureGate()


def capture_graph(fn, device, stream=None, pool=None, warm_runs=WARM_RUNS):
    """Capture ``fn()`` as one ``torch.cuda.CUDAGraph`` (the pattern both
    serving engines use).  ``fn`` first runs ``warm_runs`` times on the
    side stream ``stream`` (default: a new one), where the lazy set-up
    happens outside the capture: the kernels' builds, cuBLAS's workspace
    for that stream, cuDNN's algorithm choice and the ticket counters of
    the kernels that take them; then it is captured once on that stream,
    into ``pool`` (a ``torch.cuda.graph_pool_handle()`` shared by graphs
    that never replay at once; None: a pool of its own).  The ticket
    counters the warm-up took become the graph's own
    (:func:`~chainermn_tpu_torch.ops._common.capture_tickets`).  The
    capture is thread-local: another thread's CUDA calls (a replica of the
    same process serving, or validating a hot swap) neither invalidate it
    nor fail.

    Returns ``(graph, out, launches, counters)``: ``out`` what the
    captured call returned (its tensors are the graph's outputs, which
    every replay overwrites -- and, in a shared pool, so may another
    graph's replay: read them before the next), ``launches`` the kernel
    wrappers' counts recorded during the capture (``{name: n}``, with
    ``'<name>.tc'`` for the tensor-core routes; a replay counts nothing
    in Python, so a path's launches are these times its replays), and
    ``counters`` the ticket counters to keep alive with the graph.  A
    failed capture raises; nothing falls back to an eager run.  The whole
    of it holds :data:`GATE` exclusively."""
    with GATE.capture():
        return _capture_graph(fn, device, stream, pool, warm_runs)


def _capture_graph(fn, device, stream, pool, warm_runs):
    side = stream if stream is not None else torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(warm_runs):
            fn()
    counters = _common.release_tickets(side)
    graph = torch.cuda.CUDAGraph()
    before = _launch_counts()
    with torch.cuda.stream(side), _common.capture_tickets(counters):
        graph.capture_begin(pool=pool, capture_error_mode='thread_local')
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass      # the capture was invalidated by the failure
            raise
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    after = _launch_counts()
    launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    return graph, out, launches, counters


def _launch_counts():
    """Every wrapper's launches, with ``'<name>.tc'`` for the tensor-core
    routes."""
    out = dict(ops.launch_counts())
    out.update(('%s.tc' % k, n) for k, n in ops.tc_launch_counts().items())
    return out


class _Dequant(nn.Module):
    """Parametrization of a quantized weight: the module reads
    ``q.to(dtype) * scale`` each time it reads the weight."""

    def __init__(self, channels, dtype, axis):
        super().__init__()
        self.dtype = dtype
        self.axis = axis
        self.register_buffer('scale', torch.empty(channels, device='meta'))

    def forward(self, q):
        return dequant(q, self.scale, self.dtype, axis=self.axis)


class _ModuleApply:
    """The ``apply_fn`` of :meth:`InferenceEngine.for_model`: the forward
    of a stateless copy of the module (its tensors on the meta device)
    through ``torch.func.functional_call`` over the engine's tree.  A
    quantized weight becomes a parametrization of its module, so it is
    dequantized when the module reads it, just before it is used."""

    #: the engine hands this the quantized tree itself, not a view
    reads_quantized_tree = True

    def __init__(self, model, apply_kwargs, compute_dtype):
        memo = {id(t): nn.Parameter(torch.empty_like(t, device='meta'),
                                    requires_grad=False)
                for t in model.parameters()}
        memo.update({id(t): torch.empty_like(t, device='meta')
                     for t in model.buffers()})
        self.module = copy.deepcopy(model, memo).eval()
        self.kwargs = dict(apply_kwargs or {})
        self.dtype = compute_dtype
        self._parametrized = set()

    def _state(self, tree):
        state = {}
        for key, leaf in _flat(tree):
            if not is_quantized(leaf):
                state[key] = leaf
                continue
            owner, _, name = key.rpartition('.')
            if key not in self._parametrized:
                sub = self.module.get_submodule(owner)
                parametrize.register_parametrization(
                    sub, name, _Dequant(leaf.scale.numel(), self.dtype,
                                        leaf.axis), unsafe=True)
                self._parametrized.add(key)
            base = '%s.parametrizations.%s.' % (owner, name) if owner \
                else 'parametrizations.%s.' % name
            state[base + 'original'] = leaf.q
            state[base + '0.scale'] = leaf.scale
        return state

    def __call__(self, tree, x):
        return functional_call(self.module, self._state(tree), (x,),
                               self.kwargs, strict=True)


class InferenceEngine:
    """Forward-only serving over one model, one CUDA graph per bucket.

    Args:
      apply_fn: ``apply_fn(params, x) -> y``, the forward.  Under an
        :class:`~chainermn_tpu_torch.precision.Int8Policy` it is handed
        a view of the tree whose quantized leaves dequantize when read.
      params: the parameter tree (nested dicts of tensors or numpy
        arrays); the engine places its own copy.
      example: ONE item (no batch dim), a tensor or an array: the shape
        and dtype the buckets are built for.
      max_batch / edges: bucket geometry (power-of-two by default).
      policy: optional float or int8 policy (module docstring).
      plan / param_specs: sharded serving -- not ported (ROADMAP.md A7).
      cache_dir: accepted; a CUDA graph cannot be persisted, so
        ``cache_persistent`` stays False.  ``aot=False`` runs every
        bucket eagerly on the card too.
      label / version: replica identity: with a ``label`` every serve
        record carries ``replica`` / ``version``; ``version`` is the boot
        parameter version (:meth:`swap_params` advances it).
      device: where the engine runs (default the current CUDA device;
        raises when there is none).
    """

    def __init__(self, apply_fn, params, example, max_batch=32,
                 edges=None, policy=None, plan=None, param_specs=None,
                 cache_dir=None, aot=True, label=None, version=0,
                 device=None):
        if plan is not None or param_specs is not None:
            raise NotImplementedError(
                'sharded serving (plan=, param_specs=) is not ported yet '
                '(ROADMAP.md A7)')
        self.apply_fn = apply_fn
        self.policy = policy
        self.plan = None
        self.label = label
        self.param_version = int(version)
        self._boot_version = self.param_version
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.edges = tuple(edges) if edges else bucket_edges(max_batch)
        self.cache_dir = cache_dir
        self.cache_persistent = False
        self.aot_requested = bool(aot)
        self._graphed = self.aot_requested and self.device.type == 'cuda'

        self._item_shape = tuple(example.shape)
        in_dtype = _torch_dtype(example.dtype)
        if policy is not None and in_dtype.is_floating_point:
            in_dtype = policy.compute_dtype
        self._in_dtype = in_dtype
        self._signatures = {b: _signature((b,) + self._item_shape, in_dtype)
                            for b in self.edges}

        self.quantized = getattr(policy, 'quantize', None) is not None
        self._view = self.quantized and not getattr(
            apply_fn, 'reads_quantized_tree', False)
        # shapes and dtypes of the untransformed tree: what a checkpoint
        # for a later hot-swap is read against (no copy is kept)
        self._params_template = params_template(params)
        self.params = place_params(params, self.device, policy)

        # bucket -> (CUDAGraph, input, output, its ticket counters)
        self._graphs = {}
        self._aot = {}          # bucket -> True when captured
        self._lock = threading.Lock()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == 'cuda' else None)
        self.trace_count = 0    # forwards recorded into a graph
        self.compile_count = 0  # captures
        self.executions = 0     # batches run (replays on the card)
        self.replays = {}       # bucket -> replays
        #: bucket -> {kernel: launches recorded in its graph}: the
        #: wrappers count at capture, a replay counts nothing
        self.graph_launches = {}
        self._batch_index = 0

    # -- forward -------------------------------------------------------
    def _forward(self, params, x):
        policy = self.policy
        if self._view:
            params = dequantized_view(params, policy.compute_dtype)
        y = self.apply_fn(params, x)
        if policy is not None:
            out = policy.output_dtype or policy.compute_dtype
            y = (type(y)(t.to(out) for t in y)
                 if isinstance(y, (tuple, list)) else y.to(out))
        return y

    def _ident(self):
        if self.label is None:
            return {}
        return {'replica': self.label, 'version': self.param_version}

    def _zeros(self, bucket):
        return torch.zeros((bucket,) + self._item_shape,
                           dtype=self._in_dtype, device=self.device)

    def _capture(self, bucket):
        """Capture the forward once over a static input buffer
        (:func:`capture_graph`: a side-stream warm-up first)."""
        with GATE.capture():
            x = self._zeros(bucket)

            def forward():
                with torch.no_grad():
                    return self._forward(self.params, x)

            graph, y, launches, counters = capture_graph(forward,
                                                         self.device)
        self.graph_launches[bucket] = launches
        self._graphs[bucket] = (graph, x, y, counters)
        self.trace_count += 1
        self.compile_count += 1

    def _prepare(self, bucket):
        if self._graphed:
            self._capture(bucket)
        else:
            # eager: one run now, so that lazy set-up is not paid by the
            # first request
            with torch.no_grad():
                self._forward(self.params, self._zeros(bucket))
        self._aot[bucket] = self._graphed
        self.replays.setdefault(bucket, 0)

    # -- public surface ------------------------------------------------
    def warmup(self):
        """Prepare every bucket, largest first: capture its graph on the
        card (or run it once eagerly).  Returns ``{bucket: aot?}``."""
        reg = _telemetry.registry()
        with self._lock:
            for bucket in sorted(self.edges, reverse=True):
                if bucket in self._aot:
                    continue
                with _telemetry.span('serve_warmup', kind='serve',
                                     bucket=bucket):
                    t0 = time.perf_counter()
                    self._prepare(bucket)
                    if reg is not None:
                        reg.histogram(
                            'serve_warmup_seconds',
                            help='per-bucket warmup capture time'
                        ).observe(time.perf_counter() - t0)
        return dict(self._aot)

    def eager(self, x):
        """One eager forward of the padded batch ``x`` on the engine's
        weights, outside any graph (what a replay is checked against)."""
        x = self._as_batch(x)
        with self._lock, GATE.call(), self._on_stream(), torch.no_grad():
            y = _clone(self._forward(self.params, x.to(self.device)))
            self._sync()
        return y

    def swap_params(self, params, version=None, validate=True):
        """Hot-swap the served weights without capturing again.

        The new tree goes through the load-time transform, then (with
        ``validate``) one eager forward of the largest bucket on zeros
        must give finite outputs; only then is it copied into the
        engine's storage in place, so that ``compile_count`` stays flat.
        Both run under the lock and on the engine's stream.  A failed
        validation raises :class:`~chainermn_tpu_torch.utils.failure.
        WeightSwapError` and leaves the engine serving the old version."""
        new = place_params(params, self.device, self.policy)
        # the module is shared and ``functional_call`` swaps its
        # attributes in place: the validation forward holds the lock, as
        # every other forward does
        with self._lock, GATE.call():
            if self._stream is not None:
                self._stream.wait_stream(
                    torch.cuda.current_stream(self.device))
            with self._on_stream():
                if validate:
                    self._validate(new, version)
                try:
                    copy_params_(self.params, new)
                except ValueError as e:
                    raise WeightSwapError(
                        'swap refused: %s' % e, version=version) from e
            self._sync()
            self.param_version = (int(version) if version is not None
                                  else self.param_version + 1)
        _telemetry.event('weight_swap', kind='serve', **self._ident())
        return self.param_version

    def _validate(self, new, version):
        """One eager forward of the largest bucket on zeros with the tree
        ``new``; raises ``WeightSwapError`` unless its outputs are
        finite."""
        bucket = max(self._aot) if self._aot else max(self.edges)
        try:
            with torch.no_grad():
                probe = _tensors(self._forward(new, self._zeros(bucket)))
            finite = all(bool(torch.isfinite(t).all()) for t in probe)
        except Exception as e:
            raise WeightSwapError(
                'swap validation forward failed (%s: %s) -- keeping '
                'the incumbent parameters' % (type(e).__name__, e),
                version=version) from e
        if not finite:
            raise WeightSwapError(
                'swap validation produced non-finite outputs -- '
                'refusing cutover to version %r' % (version,),
                version=version)

    def swap_from_checkpoint(self, path, version=None, validate=True):
        """:meth:`swap_params` fed from an npz snapshot read against the
        boot tree's shapes and dtypes (a changed architecture fails
        typed, before any cutover)."""
        return self.swap_params(load_params(path, self._params_template),
                                version=version, validate=validate)

    def allowed_signatures(self):
        return set(self._signatures.values())

    def guard_signature(self, x):
        """Refuse a batch whose shape and dtype are not one of the bucket
        signatures: it would need a graph nobody captured."""
        sig = _signature(x.shape, x.dtype)
        if sig not in self.allowed_signatures():
            raise RuntimeError(
                'no-recompile guard: batch signature %r is outside the '
                'bucket set %r -- the batcher and engine disagree on bucket '
                'geometry' % (sig, sorted(self._signatures)))
        return sig

    def _as_batch(self, x):
        x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if x.is_floating_point() and x.dtype != self._in_dtype:
            x = x.to(self._in_dtype)
        return x

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _sync(self):
        if self._stream is not None:
            self._stream.synchronize()

    def infer(self, x):
        """Run one padded batch (leading dim a bucket edge): a graph
        replay on the card, an eager forward on the CPU.  Prepares the
        bucket on first use if ``warmup`` was skipped.  Returns the
        output on the engine's device."""
        x = self._as_batch(x)
        bucket = x.shape[0]
        if bucket not in self._aot:
            if bucket not in self.edges:
                raise RuntimeError('batch of %d items is not a bucket edge '
                                   '%r' % (bucket, list(self.edges)))
            with self._lock:
                if bucket not in self._aot:
                    self._prepare(bucket)
        self.guard_signature(x)
        if _chaos._active is not None:
            _chaos.on_serve_slow(self.param_version != self._boot_version)
        with self._lock, GATE.call(), self._on_stream():
            entry = self._graphs.get(bucket)
            with _telemetry.span('serve_h2d', kind='h2d', bucket=bucket):
                if entry is not None:
                    entry[1].copy_(x)
                else:
                    xd = x.to(self.device)
            with _telemetry.span('serve_execute', kind='serve',
                                 bucket=bucket, iteration=self._batch_index,
                                 **self._ident()) as sp:
                if entry is not None:
                    entry[0].replay()
                    y = _clone(entry[2])
                else:
                    with torch.no_grad():
                        y = self._forward(self.params, xd)
                self._sync()
                sp.set(aot=entry is not None)
            self.replays[bucket] = self.replays.get(bucket, 0) + 1
            self.executions += 1
            self._batch_index += 1
        return y

    def serve_packed(self, pb, clock=None):
        """Run one :class:`~chainermn_tpu_torch.serving.batcher.
        PackedBatch`: collate and pad on the host (in the policy's
        compute dtype), run the bucket, split the output rows back to the
        member requests, and record the serve telemetry (histograms,
        per-request latency, and the trace stages ``queue_wait`` ->
        ``bucket_pack`` -> ``execute`` -> ``complete``, tiled so that the
        stage budgets sum to the end-to-end latency)."""
        clock = clock or time.monotonic
        rec = _telemetry.active()
        reg = _telemetry.registry()
        ident = self._ident()
        t_exec0 = clock()
        queue_wait = t_exec0 - min(r.t_submit for r in pb.requests)
        _telemetry.event('serve_queue_wait', kind='serve',
                         seconds=queue_wait, bucket=pb.bucket,
                         iteration=self._batch_index)
        t_pack0 = rec.now() if rec is not None else None
        if rec is not None:
            pad = pb.pad_waste()
            for req in pb.requests:
                t0 = req.t_trace0
                if t0 is None:
                    t0 = t_pack0 - (clock() - req.t_submit)
                rec.child_span(req.request_id, 'queue_wait', t0, t_pack0,
                               seq=req.seq, **ident)
        try:
            x, _mask = pb.collate(dtype=self.policy.compute_dtype
                                  if self.policy is not None else None)
            t_h2d0 = clock()
            t_exe0 = rec.now() if rec is not None else None
            if rec is not None:
                for req in pb.requests:
                    rec.child_span(req.request_id, 'bucket_pack', t_pack0,
                                   t_exe0, bucket=pb.bucket,
                                   pad_fraction=round(pad, 4), items=req.n,
                                   **ident)
            y = self.infer(x)
            t_done = clock()
            y_host = _tensors(y)[0].cpu()
            off = 0
            for req in pb.requests:
                req.set_result(_host(y_host[off:off + req.n]))
                off += req.n
            if rec is not None:
                t_done_tele = rec.now()
                for req in pb.requests:
                    rec.child_span(req.request_id, 'execute', t_exe0,
                                   t_done_tele, bucket=pb.bucket, **ident)
                    rec.event('complete', kind='request',
                              request_id=req.request_id, bucket=pb.bucket,
                              **ident)
        except Exception as e:
            for req in pb.requests:
                if not req.done():
                    req.set_error(e)
                    if rec is not None:
                        rec.event('error', kind='request',
                                  request_id=req.request_id,
                                  error=type(e).__name__, **ident)
            raise
        if reg is not None:
            reg.histogram(
                'serve_queue_wait',
                help='oldest-request queue wait per served batch (s)'
            ).observe(queue_wait)
            reg.histogram(
                'serve_h2d',
                help='host collation + device placement + execute '
                     'dispatch per batch (s)').observe(t_h2d0 - t_exec0)
            reg.histogram(
                'serve_execute',
                help='bucket run to completion per batch (s)'
            ).observe(t_done - t_h2d0)
            reg.histogram(
                'serve_pad_waste',
                help='padding fraction of each served batch'
            ).observe(pb.pad_waste())
            reg.histogram('serve_batch_items',
                          help='valid items per served batch'
                          ).observe(pb.total)
            lat = reg.histogram(
                'serve_latency_seconds',
                help='submit-to-response latency per request (s)')
            now = clock()
            for req in pb.requests:
                lat.observe(now - req.t_submit)
            reg.counter('serve_requests_total',
                        help='requests answered with a result'
                        ).inc(len(pb.requests))
            reg.counter('serve_batches_total', help='bucket executions'
                        ).inc()
        return y_host

    def run(self, queue, stop=None, take_timeout=0.05):
        """Drain ``queue`` until ``stop`` is set and the queue is empty --
        the serving worker loop (a thread of its own in the load
        generator; errors land on the affected requests and never end the
        loop).  The thread takes the engine's device as its current one
        (the current CUDA device and stream are per thread)."""
        if self.device.type == 'cuda':
            torch.cuda.set_device(self.device)
        while True:
            batches = queue.take(timeout=take_timeout)
            if not batches:
                if stop is not None and stop.is_set() \
                        and queue.depth() == 0:
                    return
                continue
            for pb in batches:
                try:
                    self.serve_packed(pb)
                except Exception:
                    continue  # the requests already carry the error

    def stats(self):
        return {
            'buckets': sorted(self._aot),
            'edges': list(self.edges),
            'label': self.label,
            'param_version': self.param_version,
            'aot': dict(self._aot),
            'aot_requested': self.aot_requested,
            'cache_dir': self.cache_dir,
            'cache_persistent': self.cache_persistent,
            'quantized': self.quantized,
            'trace_count': self.trace_count,
            'compile_count': self.compile_count,
            'executions': self.executions,
            'replays': dict(self.replays),
            'graph_launches': {b: dict(c)
                               for b, c in self.graph_launches.items()},
            'device': str(self.device),
        }

    # -- constructors --------------------------------------------------
    @classmethod
    def for_model(cls, model, variables, example, apply_kwargs=None, **kw):
        """Engine over an ``nn.Module`` (the zoo models): ``variables`` is
        its parameter and buffer tree (:func:`module_state`'s layout, in
        the module's own tensor layouts), or None for the module's own.
        The forward runs a stateless eval-mode copy of the module
        (``apply_kwargs`` go to its ``forward``); the module itself is not
        changed.  A quantized weight is scaled per output channel on axis
        0 of a ``weight`` (the layout rule of
        :func:`~chainermn_tpu_torch.precision.quantize_int8`)."""
        if variables is None:
            variables = module_state(model)
        policy = kw.get('policy')
        dtype = policy.compute_dtype if policy is not None else None
        return cls(_ModuleApply(model, apply_kwargs, dtype),
                   dict(variables), example, **kw)

    @classmethod
    def from_checkpoint(cls, path, model, variables_template, example,
                        apply_kwargs=None, **kw):
        """Engine loaded from an npz snapshot whose ``params`` entry is a
        tree in :meth:`for_model`'s layout, read against
        ``variables_template`` (None: the module's own tree)."""
        template = (module_state(model) if variables_template is None
                    else variables_template)
        return cls.for_model(model, load_params(path, template), example,
                             apply_kwargs=apply_kwargs, **kw)
