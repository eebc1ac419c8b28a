"""Autoregressive generation: bucketed KV-cache decode with continuous
token-level batching, over a slot cache or a paged one, optionally
speculative.

Counterpart of ``chainermn_tpu/serving/generate.py``:

- **Prefill** runs one prompt per call, padded to a power-of-two
  PROMPT-LENGTH bucket, and banks every layer's K/V in the cache
  (:func:`chainermn_tpu_torch.models.prefill` into one slot, or
  :func:`~chainermn_tpu_torch.models.prefill_paged` into pages).
- **Decode** runs one token per live sequence, padded to a power-of-two
  ACTIVE-SLOT-COUNT bucket, over the same persistent cache
  (:func:`~chainermn_tpu_torch.models.decode_step` /
  :func:`~chainermn_tpu_torch.models.decode_step_paged`).  The full slot
  bucket reads the cache in place (row i IS slot i); a smaller one
  carries a row -> slot map; paged rows carry their page tables.
- **Continuous batching**: a sequence that finishes (or whose deadline
  expires mid-generation) frees its slot, and the slot is refilled from
  the queue at the NEXT step; the rest of the batch never waits.
- **Paged mode** (``paged=True``): a pool of pages shared by every
  sequence (:mod:`~chainermn_tpu_torch.serving.paged`), with a radix
  index over finished prompts (a request whose prompt starts with a
  banked prefix retains its full pages and copies the boundary page
  once), LRU eviction when the pool runs dry, typed ``kv_pages``
  shedding when nothing is evictable, and chunked prefill
  (``prefill_chunk=C``: one C-token chunk per sequence per tick,
  interleaved with decode steps).  Unchunked and without prefix hits,
  greedy outputs equal the slot engine's; a banked context goes through
  the chunk op's f32 merge and one more rounding, so in bf16 a near-tie
  may resolve to another token (in f32 they are equal).
- **Speculative decoding** (``draft_model=``): a small draft proposes
  ``spec_tokens`` tokens a tick, the target scores the window in one
  verify pass (:func:`~chainermn_tpu_torch.models.spec_verify` /
  :func:`~chainermn_tpu_torch.models.spec_verify_paged`), and each row
  commits the longest agreeing draft prefix plus the target's own next
  token.  In f32 the greedy outputs equal the non-speculative
  engine's; in bf16 the verify's merge rounds once more, so a near-tie
  may resolve to another token.  The acceptance rate moves only
  throughput.

Decoding is greedy (argmax on the device; only the token ids come back
to the host).  The caches are updated in place, which is what the JAX
package's buffer donation buys there.

- **One CUDA graph per bucket** (``aot=True``, the default, on a CUDA
  device): the port's counterpart of the JAX engine's per-bucket AOT
  executables.  Each prefill width (in paged mode two graphs a width: a
  prompt's first chunk and a continued one), decode bucket, and on a
  speculative engine each draft prefill width, draft decode bucket and
  verify bucket is captured once (:meth:`GenerationEngine.warmup`, or
  the bucket's first use) over static int32 operand buffers, with the
  greedy argmax inside the graph; a tick copies its operands into the
  buffers (one host-to-device copy a call), replays the graph, and reads
  back only the token ids.  A failed capture raises: there is no eager
  fallback on the card.  On the CPU, or with ``aot=False``, the same
  bodies run eagerly over the same buffers and every bucket reports
  ``aot`` False.  :meth:`GenerationEngine.guard_signature` refuses any
  operand signature outside the bucket set (the JAX package's
  ``abstract_signature``), so no graph is captured mid-traffic for a
  shape the geometry does not have.  The page copy of copy-on-write
  runs eagerly (once per copy, not once per step).

An :class:`~chainermn_tpu_torch.precision.Int8Policy` quantizes the
weights at load; each weight is dequantized when the model function
reads it, just before the layer that uses it
(:func:`~chainermn_tpu_torch.precision.dequantized_view`).
:meth:`GenerationEngine.run` is the scheduler loop the load generator
drives; :meth:`~GenerationEngine.swap_params` hot-swaps the weights of a
drained engine.  Telemetry: the raw-sample histograms
``serve_ttft_seconds``, ``serve_intertoken_seconds`` and
``serve_decode_seconds``, the ``serve_tokens_total`` counter, the queue
gauges, each request's trace stages (``queue_wait`` -> ``bucket_pack``
-> ``prefill`` -> one ``decode`` a tick) and its ``complete`` / ``shed``
events.

Replica identity: with a ``label`` every serve record (request stages
and events, the ``serve_prefill`` / ``serve_decode`` / ``serve_draft`` /
``serve_verify`` spans, the ``serve_spec`` event, sheds and swaps)
carries ``replica`` and ``version``, which the fleet's per-replica SLO
monitors filter on.  The chaos sites: the queue's ``serve_burst``,
``serve_slow`` (a host sleep before a prefill, chunk, decode or
speculative tick of an engine serving a hot-swapped version; no graph
changes), and in :meth:`GenerationEngine.step` ``serve_cancel`` and
``replica_kill`` (decode ticks only).  The engine's in-flight request
table is a flight-dump source (``serve_requests``).

Not ported yet: tensor-parallel serving (``plan`` / ``param_specs``
raise ``NotImplementedError``, ROADMAP.md A7).  ``cache_dir`` is
accepted, but a CUDA graph cannot be persisted, so ``cache_persistent``
stays False.
"""

import threading
import time

import numpy as np
import torch

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.models.flax_weights import param_tree
from chainermn_tpu_torch.models.transformer import (
    decode_step, decode_step_paged, init_kv_cache, init_paged_kv_cache,
    prefill, prefill_paged, spec_verify, spec_verify_paged)
from chainermn_tpu_torch.ops._common import resolve_device
from chainermn_tpu_torch.precision import cast_floating, dequantized_view
from chainermn_tpu_torch.serving.batcher import (
    bucket_edges, bucket_of, next_request_id, record_shed)
from chainermn_tpu_torch.serving.engine import (
    GATE, capture_graph, copy_params_, load_params, params_template,
    place_params)
from chainermn_tpu_torch.serving.paged import (PagePool, RadixPrefixIndex,
                                               prefix_key)
from chainermn_tpu_torch.utils import chaos as _chaos
from chainermn_tpu_torch.utils.failure import OverloadError, WeightSwapError

#: default admission knobs (the generation twins of batcher's)
DEFAULT_MAX_QUEUE = 256


class GenRequest:
    """One in-flight generation request: ``prompt`` (1-D int32 token
    ids), ``max_new_tokens``, optional absolute ``deadline``
    (``clock()`` units, enforced at admission AND between decode steps),
    and a one-shot completion cell filled with the generated token ids
    or a typed error.  ``prefix_key`` (stamped by a paged engine's queue)
    is a stable hash of the page-aligned prompt prefix.  ``on_token``
    (optional) is called as ``on_token(request_id, [int, ...])`` each
    time tokens are emitted.  ``t_trace0`` is the admission instant on the
    telemetry recorder's clock (None when telemetry was off), the start of
    the request's ``queue_wait`` stage.  ``synthetic`` marks a copy the
    ``serve_burst`` chaos site added."""

    __slots__ = ('prompt', 'max_new_tokens', 'deadline', 'seq',
                 't_submit', 'synthetic', 'request_id', 't_trace0',
                 'prefix_key', 'on_token', '_done', '_result', '_error')

    def __init__(self, prompt, max_new_tokens, deadline=None, seq=0,
                 t_submit=0.0, synthetic=False, request_id=None,
                 prefix_key=None, on_token=None):
        self.prompt = np.asarray(prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError('empty prompt')
        if max_new_tokens < 1:
            raise ValueError('max_new_tokens must be >= 1, got %d'
                             % max_new_tokens)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.seq = seq
        self.t_submit = t_submit
        self.synthetic = synthetic
        self.prefix_key = prefix_key
        self.on_token = on_token
        self.request_id = request_id or next_request_id()
        rec = _telemetry.active()
        self.t_trace0 = rec.now() if rec is not None else None
        self._done = threading.Event()
        self._result = None
        self._error = None

    def set_result(self, tokens):
        self._result = np.asarray(tokens, np.int32)
        self._done.set()

    def notify_tokens(self, tokens):
        """Stream newly committed tokens to ``on_token``.  Guarded: a
        callback failure never takes the scheduler down; the request
        still completes through ``set_result``."""
        if self.on_token is None or not tokens:
            return
        try:
            self.on_token(self.request_id, [int(t) for t in tokens])
        except Exception:
            pass

    def set_error(self, exc):
        self._error = exc
        self._done.set()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block for the generated tokens; re-raises the typed shed
        error (``OverloadError`` with reason queue_full / deadline /
        kv_pages / shutdown)."""
        if not self._done.wait(timeout):
            raise TimeoutError('request %d not completed within %rs'
                               % (self.seq, timeout))
        if self._error is not None:
            raise self._error
        return self._result


class GenerationQueue:
    """Bounded admission queue for generation requests: the engine pops
    AT MOST as many requests as it has free cache slots each step; a
    full or closed queue sheds typed (``OverloadError``).

    ``page_size`` (set when feeding a paged engine) stamps each request's
    :attr:`GenRequest.prefix_key` and unlocks ``pop(...,
    group_prefix=True)`` co-admission.  ``label`` (a fleet replica's
    name) goes on its shed records; the chaos ``serve_burst`` site adds
    synthetic copies of a submit through the same bounded admission."""

    def __init__(self, max_prompt_len, max_queue=DEFAULT_MAX_QUEUE,
                 clock=time.monotonic, label=None, page_size=None):
        self.label = label
        self.max_prompt_len = int(max_prompt_len)
        self.page_size = int(page_size) if page_size else None
        self.max_queue = int(max_queue)
        self._clock = clock
        self._lock = threading.Lock()
        self._waiting = []
        self._seq = 0
        self._closed = False
        self.submitted = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0

    def submit(self, prompt, max_new_tokens, deadline=None,
               request_id=None, on_token=None):
        """Enqueue one prompt; returns the :class:`GenRequest`.
        Over-length prompts raise ``ValueError`` before touching queue
        state; a full or closed queue sheds typed."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size > self.max_prompt_len:
            raise ValueError(
                'prompt of %d tokens exceeds max_prompt_len %d; '
                'truncate client-side or raise the engine limit'
                % (prompt.size, self.max_prompt_len))
        burst = (_chaos.on_serve_submit()
                 if _chaos._active is not None else 0)
        with self._lock:
            req = self._admit(prompt, max_new_tokens, deadline,
                              request_id=request_id, on_token=on_token)
            for _ in range(burst):
                try:
                    self._admit(prompt, max_new_tokens, deadline,
                                synthetic=True)
                except OverloadError:
                    break   # the burst past capacity sheds
        return req

    def _admit(self, prompt, max_new_tokens, deadline, synthetic=False,
               request_id=None, on_token=None):
        if self._closed:
            raise OverloadError('generation queue is shut down',
                                reason='shutdown',
                                queue_depth=len(self._waiting))
        if len(self._waiting) >= self.max_queue:
            self.shed_queue_full += 1
            record_shed('queue_full',
                        request_id=request_id or next_request_id(),
                        queue_depth=len(self._waiting),
                        **self._shed_attrs())
            raise OverloadError(
                'generation queue full (%d waiting); retry with '
                'backoff' % len(self._waiting),
                reason='queue_full', queue_depth=len(self._waiting))
        self._seq += 1
        self.submitted += 1
        key = (prefix_key(prompt, self.page_size)
               if self.page_size is not None else None)
        req = GenRequest(prompt, max_new_tokens, deadline=deadline,
                         seq=self._seq, t_submit=self._clock(),
                         synthetic=synthetic, request_id=request_id,
                         prefix_key=key, on_token=on_token)
        self._waiting.append(req)
        return req

    def _shed_attrs(self):
        return {'replica': self.label} if self.label else {}

    def pop(self, k, group_prefix=False):
        """Up to ``k`` live requests in arrival order; requests whose
        deadline already expired while queued are shed typed here.

        ``group_prefix=True`` (the paged engine's admission): after the
        head request is taken in arrival order, later waiters sharing
        its ``prefix_key`` are pulled forward into the same admission
        wave.  Order within a key group is kept, and requests without a
        key are never reordered past each other."""
        now = self._clock()
        out = []
        with self._lock:
            head_key = None
            while self._waiting and len(out) < k:
                idx = 0
                if group_prefix and head_key is not None:
                    idx = next((j for j, r in enumerate(self._waiting)
                                if r.prefix_key == head_key), 0)
                req = self._waiting.pop(idx)
                if req.deadline is not None and now > req.deadline:
                    self.shed_deadline += 1
                    record_shed('deadline', request_id=req.request_id,
                                queue_depth=len(self._waiting),
                                waited_ms=round((now - req.t_submit) * 1e3,
                                                3),
                                **self._shed_attrs())
                    req.set_error(OverloadError(
                        'deadline expired after %.1f ms in queue'
                        % ((now - req.t_submit) * 1e3), reason='deadline'))
                    continue
                if not out and group_prefix:
                    head_key = req.prefix_key
                out.append(req)
        return out

    def depth(self):
        with self._lock:
            return len(self._waiting)

    def close(self):
        with self._lock:
            self._closed = True
            pending, self._waiting = self._waiting, []
        for req in pending:
            record_shed('shutdown', request_id=req.request_id,
                        queue_depth=len(pending), count_total=False,
                        **self._shed_attrs())
            req.set_error(OverloadError('generation queue shut down',
                                        reason='shutdown'))

    def stats(self):
        return {'submitted': self.submitted,
                'shed_queue_full': self.shed_queue_full,
                'shed_deadline': self.shed_deadline,
                'depth': self.depth()}


class _Slot:
    """Host-side state of one cache slot in its decode phase."""

    __slots__ = ('request', 'position', 'remaining', 'generated',
                 't_last_token', 't_stage_end', 'pages')

    def __init__(self, request, position, remaining, first_token, t_now,
                 t_stage_end=None, pages=None):
        self.request = request
        self.position = position          # next token's position
        self.remaining = remaining        # tokens still to generate
        self.generated = [first_token]
        self.t_last_token = t_now         # clock() of the newest token
        # telemetry-clock end of the request's newest trace stage (None:
        # telemetry off): the next decode stage starts there
        self.t_stage_end = t_stage_end
        # paged engine: this sequence's page table (one pool reference
        # per entry, released on completion or expiry); None otherwise
        self.pages = pages


class _PrefillState:
    """Host-side state of a sequence whose prompt is still being
    prefilled (paged engine): chunked prefill runs one chunk a tick, so
    a long prompt spends several ticks here before it becomes a
    :class:`_Slot`."""

    __slots__ = ('request', 'pages', 'pos', 'matched', 'chunks',
                 't_stage_end')

    def __init__(self, request, pages, pos, matched, t_stage_end=None):
        self.request = request
        self.pages = pages       # page table so far (references held)
        self.pos = pos           # next absolute position to prefill
        self.matched = matched   # prompt tokens reused from the index
        self.chunks = 0          # chunks run so far
        self.t_stage_end = t_stage_end


def _signature(args):
    """Shapes and dtypes of an operand tuple (numpy arrays, numpy
    scalars or tensors)."""
    return tuple((tuple(a.shape), str(a.dtype).replace('torch.', ''))
                 for a in args)


#: the bucket families of an engine, in the JAX engine's ``warmup``
#: order (the last three on a speculative engine only)
FAMILIES = ('prefill', 'decode', 'draft_prefill', 'draft_decode', 'verify')


class _Call:
    """One call of the engine: a ``(family, bucket)``, or for a paged
    prefill ``(family, width, first)``.  Its int32 operands live in one
    device buffer, viewed per operand (``views``), and on the card are
    staged through a pinned host twin (``host_views``, numpy), so that a
    call costs one host-to-device copy.  ``body(views)`` runs the model
    function over the views and returns ``(logits, greedy ids)``; on the
    card with ``aot`` it is captured once into ``graph``, whose outputs
    are ``out``, and a call replays it.  ``launches`` are the kernel
    wrappers' counts recorded at capture, ``replays`` the replays since."""

    def __init__(self, layout, body, device):
        sizes = [int(np.prod(shape)) for _, shape in layout]
        with torch.inference_mode(False):
            self.flat = torch.zeros(sum(sizes), dtype=torch.int32,
                                    device=device)
            self.host = (torch.zeros(sum(sizes), dtype=torch.int32,
                                     pin_memory=True)
                         if device.type == 'cuda' else self.flat)
        host = self.host.numpy()
        self.views, self.host_views = {}, {}
        off = 0
        for (name, shape), n in zip(layout, sizes):
            self.views[name] = self.flat[off:off + n].view(shape)
            self.host_views[name] = host[off:off + n].reshape(shape)
            off += n
        self.body = body
        self.graph = self.out = self.counters = None
        self.launches = {}
        self.replays = 0
        self.ran = False

    def stage(self, operands):
        """Copy ``operands`` (name -> numpy array or int) into the
        buffers."""
        for name, value in operands.items():
            self.host_views[name][...] = value
        if self.host is not self.flat:
            self.flat.copy_(self.host, non_blocking=True)

    def eager(self):
        return self.body(self.views)

    def run(self):
        """Replay the graph, or run the body eagerly."""
        self.ran = True
        if self.graph is None:
            return self.eager()
        self.graph.replay()
        self.replays += 1
        return self.out


def _unported(what, item='A8'):
    raise NotImplementedError('%s is not ported yet (ROADMAP.md %s)'
                              % (what, item))


class GenerationEngine:
    """Continuous-batching autoregressive server for one
    :class:`~chainermn_tpu_torch.models.TransformerLM`.

    Args:
      model: the port's ``TransformerLM`` (its config; and its weights
        unless ``params`` is given).
      params: optional parameter tree (nested dicts of tensors or numpy
        arrays, keyed like the flax tree); default: the model's own.
      n_slots: cache slots = max concurrent sequences; decode buckets
        are the powers of two up to it.
      max_prompt_len: prompt-length cap; prefill buckets are the powers
        of two up to it.
      max_len: cache depth per sequence (default ``model.max_len``).
      eos_id: optional stop token.
      policy: a float :class:`~chainermn_tpu_torch.precision.Policy`
        casts the weights (the draft's too) to its compute dtype at load;
        an :class:`~chainermn_tpu_torch.precision.Int8Policy` quantizes
        the target's (the draft's stay as given, as in the JAX package).
      int8_kv: store the KV cache int8 with per-(position, head) scales.
      paged: a pool of ``n_pages`` pages of ``page_size`` positions
        shared by all sequences through page tables, with refcounted
        prefix sharing and copy-on-write, in place of one slab per slot.
        ``n_pages`` defaults to ``1 + n_slots * ceil(max_len /
        page_size)`` (the slot engine's capacity plus the scratch page).
      prefill_chunk: paged mode only: prefill prompts in chunks of this
        many tokens, one chunk per sequence per tick between decode
        steps (``None``: a prompt's whole remainder in one tick).
      prefix_sharing: ``False`` disables the radix index (pages still
        pool; nothing is reused across requests).
      draft_model / draft_params: speculative decoding with this draft
        (same vocabulary, ``max_len`` covering the cache depth) and its
        parameter tree; its cache has the target's geometry and rides
        the same slots, page tables, copies and rollbacks.
      spec_tokens: the verify window ``k`` (>= 2): one tick runs ``k``
        draft decode steps and one target verify, committing 1..k tokens
        per row.
      cache_dir: accepted; a CUDA graph cannot be persisted, so
        ``cache_persistent`` stays False.
      aot: on a CUDA device, capture one CUDA graph per bucket (module
        docstring); ``False`` runs every bucket eagerly on the card too.
      device: where the engine runs (default: the current CUDA device;
        raises when there is none).
      label / version: replica identity: with a ``label`` every serve
        record carries ``replica`` / ``version``; ``version`` is the boot
        parameter version (:meth:`swap_params` advances it).

    ``admit_cap`` (an attribute, default None) caps the admissions of a
    tick below the free slots.
    """

    def __init__(self, model, params=None, n_slots=8, max_prompt_len=64,
                 max_len=None, eos_id=None, policy=None, int8_kv=False,
                 paged=False, page_size=16, n_pages=None,
                 prefill_chunk=None, prefix_sharing=True, draft_model=None,
                 draft_params=None, spec_tokens=4, plan=None,
                 param_specs=None, cache_dir=None, aot=True, device=None,
                 label=None, version=0):
        if plan is not None or param_specs is not None:
            _unported('tensor-parallel serving (plan=, param_specs=)', 'A7')
        self.model = model
        self.label = label
        self.device = resolve_device(device)
        self.cache_dir = cache_dir
        self.cache_persistent = False
        self.aot_requested = bool(aot)
        self._graphed = self.aot_requested and self.device.type == 'cuda'
        self._calls = {}            # key -> _Call (see _Call)
        self._capture_stream = self._pool = None
        #: graph captures by family
        self.captures = dict.fromkeys(FAMILIES, 0)
        self.param_version = int(version)
        self._boot_version = self.param_version
        self.n_slots = int(n_slots)
        #: admissions per tick (None: every free slot)
        self.admit_cap = None
        self.max_prompt_len = int(max_prompt_len)
        self.max_len = int(max_len or model.max_len)
        if self.max_prompt_len > self.max_len:
            raise ValueError('max_prompt_len %d exceeds cache depth %d'
                             % (self.max_prompt_len, self.max_len))
        self.eos_id = eos_id
        self.policy = policy
        self.prefill_edges = bucket_edges(self.max_prompt_len)
        self.decode_edges = bucket_edges(self.n_slots)
        self.quantized = getattr(policy, 'quantize', None) is not None
        if params is None:
            params = param_tree(model)
        # shapes and dtypes of the untransformed tree: what a checkpoint
        # for a later hot-swap is read against
        self._params_template = params_template(params)
        self.params = self._place_params(params)

        self.int8_kv = bool(int8_kv)
        self.paged = bool(paged)
        self.page_size = int(page_size)
        self.prefill_chunk = int(prefill_chunk) if prefill_chunk else None
        if self.prefill_chunk is not None and not self.paged:
            raise ValueError('prefill_chunk requires paged=True (the slot '
                             'cache prefills whole prompts)')
        if self.prefill_chunk is not None \
                and self.prefill_chunk > self.max_prompt_len:
            raise ValueError('prefill_chunk %d exceeds max_prompt_len %d'
                             % (self.prefill_chunk, self.max_prompt_len))
        if self.paged:
            self.pages_per_seq = -(-self.max_len // self.page_size)
            self.n_pages = int(n_pages
                               or 1 + self.n_slots * self.pages_per_seq)
            self.pool = PagePool(self.n_pages, self.page_size)
            self._prefix_index = (RadixPrefixIndex(self.pool)
                                  if prefix_sharing else None)
        else:
            if n_pages is not None:
                raise ValueError('n_pages requires paged=True')
            self.pages_per_seq = self.n_pages = self.pool = None
            self._prefix_index = None
        self._cache = self._new_cache(model)

        # speculative decoding: the draft twin
        self.spec_tokens = int(spec_tokens)
        self.draft_model = draft_model
        self.speculative = draft_model is not None
        if draft_params is not None and draft_model is None:
            raise ValueError('draft_params requires draft_model')
        self._draft_params = self._draft_cache = None
        if self.speculative:
            if draft_params is None:
                raise ValueError('draft_model requires draft_params')
            if self.spec_tokens < 2:
                raise ValueError('spec_tokens must be >= 2 (1 is plain '
                                 'decode), got %d' % self.spec_tokens)
            if draft_model.vocab_size != model.vocab_size:
                raise ValueError(
                    'draft vocab %d != target vocab %d -- speculative '
                    'decoding compares token ids, so the tokenizer must be '
                    'shared' % (draft_model.vocab_size, model.vocab_size))
            if draft_model.max_len < self.max_len:
                raise ValueError('draft max_len %d cannot cover the cache '
                                 'depth %d' % (draft_model.max_len,
                                               self.max_len))
            self._draft_params = self._place_draft(draft_params)
            self._draft_cache = self._new_cache(draft_model)

        # prefill widths: chunked paged mode runs ONE fixed chunk width,
        # otherwise one width per prompt bucket
        self._prefill_widths = ((self.prefill_chunk,)
                                if self.prefill_chunk is not None
                                else tuple(self.prefill_edges))
        self._slots = {}        # slot id -> _Slot (decode phase)
        self._prefilling = {}   # slot id -> _PrefillState (paged only)
        self._free = list(range(self.n_slots))
        self._signatures = self._bucket_signatures()
        self.prefills = 0
        self.prefill_chunks = 0
        self.cow_copies = 0
        self.decode_steps = 0
        self.draft_steps = 0
        self.verify_steps = 0
        self.draft_proposed = 0
        self.draft_accepted = 0
        self.tokens_generated = 0
        self.cancelled = 0
        self._step_index = 0
        self._last_queue_depth = 0

    def _new_cache(self, model):
        if self.paged:
            return init_paged_kv_cache(model, self.n_pages, self.page_size,
                                       int8_kv=self.int8_kv,
                                       device=self.device)
        return init_kv_cache(model, self.n_slots, self.max_len,
                             int8_kv=self.int8_kv, device=self.device)

    def _bucket_signatures(self):
        """The operand signatures of every prefill width, decode bucket,
        verify bucket and (paged) the page copy."""
        i32 = np.zeros((), np.int32)
        vec = lambda *shape: np.zeros(shape, np.int32)  # noqa: E731
        sigs = set()
        for w in self._prefill_widths:
            args = (vec(1, w), i32, i32)
            sigs.add(_signature(args + (vec(self.pages_per_seq),)
                                if self.paged else args))
        windows = [()] + ([(self.spec_tokens,)] if self.speculative else [])
        for b in self.decode_edges:
            for window in windows:
                tokens = vec(b, *window)
                if self.paged:
                    args = (tokens, vec(b), vec(b, self.pages_per_seq))
                elif b == self.n_slots:
                    args = (tokens, vec(b))
                else:
                    args = (tokens, vec(b), vec(b))
                sigs.add(_signature(args))
        if self.paged:
            sigs.add(_signature((i32, i32)))
        return sigs

    def _place_params(self, params):
        """Load-time transform + placement (shared by construction and
        hot-swaps): a copy on the device, quantized or cast by the
        policy."""
        return place_params(params, self.device, self.policy)

    def _place_draft(self, params):
        """The draft's placement: cast by a float policy, left as given
        under an int8 one (the JAX package quantizes the target only)."""
        placed = place_params(params, self.device, None)
        if self.policy is not None and not self.quantized:
            placed = cast_floating(placed, self.policy.compute_dtype)
        return placed

    def _ident(self):
        if self.label is None:
            return {}
        return {'replica': self.label, 'version': self.param_version}

    def _slow(self):
        """The ``serve_slow`` chaos site: a host sleep before a call of an
        engine serving a hot-swapped version."""
        if _chaos._active is not None:
            _chaos.on_serve_slow(self.param_version != self._boot_version)

    def swap_params(self, params, version=None, validate=True):
        """Hot-swap the served weights.  Refused with
        :class:`~chainermn_tpu_torch.utils.failure.WeightSwapError`
        (engine unchanged) while sequences are in flight: their KV caches
        were banked under the incumbent weights.  Validation runs one
        eager full-slot decode step with the new tree over the idle cache
        (the warmup's garbage-write contract) and requires finite logits.
        Then the tree is cut over: under CUDA graphs (which read fixed
        addresses) it is copied into the captured storage in place, int8
        ``q`` and scales too, so that the next replay reads it and no
        graph is captured again (a tree of other shapes or dtypes is
        refused); eagerly the engine takes the new tree."""
        if self._slots or self._prefilling:
            raise WeightSwapError(
                'swap requires a drained replica: %d sequence(s) still in '
                'flight hold KV state banked under the incumbent weights'
                % (len(self._slots) + len(self._prefilling)),
                version=version)
        # the validation decode and the copy are a serving call (GATE)
        with GATE.call():
            new = self._place_params(params)
            if validate:
                b = self.n_slots
                zeros = torch.zeros((b,), dtype=torch.int32,
                                    device=self.device)
                rows = self._zero_rows(b)
                try:
                    logits = self._decode_logits(
                        self.model, self._view(new), self._cache, zeros,
                        zeros, None if rows is None else self._dev(rows))
                    finite = bool(torch.isfinite(logits).all())
                except Exception as e:
                    raise WeightSwapError(
                        'swap validation decode failed (%s: %s) -- keeping '
                        'the incumbent parameters' % (type(e).__name__, e),
                        version=version) from e
                if not finite:
                    raise WeightSwapError(
                        'swap validation produced non-finite logits -- '
                        'refusing cutover to version %r' % (version,),
                        version=version)
            if self._graphed:
                try:
                    copy_params_(self.params, new)
                except ValueError as e:
                    raise WeightSwapError('swap refused: %s' % e,
                                          version=version) from e
            else:
                self.params = new
        self.param_version = (int(version) if version is not None
                              else self.param_version + 1)
        _telemetry.event('weight_swap', kind='serve', **self._ident())
        return self.param_version

    def swap_from_checkpoint(self, path, version=None, validate=True):
        """:meth:`swap_params` fed from an npz snapshot's ``params`` tree,
        read against the boot tree's shapes and dtypes."""
        return self.swap_params(load_params(path, self._params_template),
                                version=version, validate=validate)

    @classmethod
    def from_checkpoint(cls, path, model, params_template, **kw):
        """Engine whose weights are an npz snapshot's ``params`` tree (the
        flax-keyed tree of :func:`~chainermn_tpu_torch.models.
        param_tree`), read against ``params_template`` (None: the
        model's own tree)."""
        if params_template is None:
            params_template = param_tree(model)
        return cls(model, load_params(path, params_template), **kw)

    # -- device calls --------------------------------------------------
    def _read(self, logits, ids):
        """The host's read of one call: its greedy ids as numpy, the only
        values that cross to the host.  ``logits`` are the call's logits
        on the device (a graph's output: valid until the engine's next
        call); a subclass may check them here."""
        return ids.cpu().numpy()

    def _dev(self, a):
        return torch.from_numpy(np.asarray(a)).to(self.device)

    def _view(self, params):
        """What the model functions read: under an int8 policy a view
        whose quantized leaves dequantize when read."""
        if self.quantized:
            return dequantized_view(params, self.policy.compute_dtype)
        return params

    def _twin(self, draft):
        if draft:
            return self.draft_model, self._draft_params, self._draft_cache
        return self.model, self._view(self.params), self._cache

    def _layout(self, key):
        """``(name, shape)`` of each int32 operand of a call."""
        family, bucket = key[:2]
        if family.endswith('prefill'):
            layout = [('tokens', (1, bucket)), ('length', ())]
            if self.paged:
                return layout + [('pos0', ()),
                                 ('table', (self.pages_per_seq,))]
            return layout + [('slot', ())]
        window = (self.spec_tokens,) if family == 'verify' else ()
        layout = [('tokens', (bucket,) + window), ('positions', (bucket,))]
        if self.paged:
            return layout + [('rows', (bucket, self.pages_per_seq))]
        return layout + ([('rows', (bucket,))] if bucket != self.n_slots
                         else [])

    def _body(self, key):
        """What a call runs (and a graph captures): the family's model
        function over the call's operand views, then the greedy argmax.
        Returns ``(logits, ids)``."""
        family = key[0]
        draft = family.startswith('draft')

        def body(o):
            model, params, cache = self._twin(draft)
            with torch.inference_mode():
                if family.endswith('prefill') and self.paged:
                    logits, _ = prefill_paged(
                        model, params, cache, o['tokens'], o['length'],
                        o['table'], o['pos0'], first=key[2])
                elif family.endswith('prefill'):
                    logits, _ = prefill(model, params, cache, o['tokens'],
                                        o['length'], o['slot'])
                elif family == 'verify':
                    logits = self._verify_logits(o['tokens'], o['positions'],
                                                 o.get('rows'))
                else:
                    logits = self._decode_logits(
                        model, params, cache, o['tokens'], o['positions'],
                        o.get('rows'))
                return logits, torch.argmax(logits, dim=-1)

        return body

    def _call(self, key):
        call = self._calls.get(key)
        if call is None:
            call = self._calls[key] = _Call(self._layout(key),
                                            self._body(key), self.device)
        return call

    def _capture(self, key, call):
        """Capture one call's graph over its staged operands
        (:func:`~chainermn_tpu_torch.serving.engine.capture_graph`).  The
        engine's graphs share one capture stream and one memory pool: they
        replay one at a time, and each call's outputs are read before the
        next replay."""
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        call.graph, call.out, call.launches, call.counters = capture_graph(
            call.eager, self.device, stream=self._capture_stream,
            pool=self._pool)
        self.captures[key[0]] += 1

    def _run(self, key, operands):
        """Stage ``operands`` into the call's buffers and run it (a replay
        under graphs, captured on first use when ``warmup`` skipped it: the
        warm-up and the capture run over the same operands, whose cache
        writes are the call's own); returns the greedy ids as numpy.  The
        call passes :data:`~chainermn_tpu_torch.serving.engine.GATE`, a
        capture holds it exclusively."""
        call = self._call(key)
        if self._graphed and call.graph is None:
            with GATE.capture():
                call.stage(operands)
                self._capture(key, call)
        with GATE.call():
            call.stage(operands)
            return self._read(*call.run())

    def _run_prefill(self, tokens, length, where, draft=False):
        """One prefill of the target (or the draft): ``where`` is the
        slot id, or ``(pos0, page table)`` in paged mode."""
        family = 'draft_prefill' if draft else 'prefill'
        width = tokens.shape[1]
        if self.paged:
            pos0, table = where
            return int(self._run((family, width, bool(pos0 == 0)),
                                 dict(tokens=tokens, length=length,
                                      pos0=pos0, table=table)))
        return int(self._run((family, width),
                             dict(tokens=tokens, length=length, slot=where)))

    def _run_decode(self, tokens, positions, rows=None, draft=False):
        """One decode step of the target (or the draft): ``rows`` is the
        row -> slot map of a compacted slot bucket (``None``: the full
        bucket), or the page tables in paged mode."""
        operands = dict(tokens=tokens, positions=positions)
        if rows is not None:
            operands['rows'] = rows
        return self._run(('draft_decode' if draft else 'decode',
                          len(tokens)), operands)

    def _decode_logits(self, model, params, cache, tokens, positions, rows):
        """The logits of one decode step of ``model`` over ``params`` (as
        the model functions read them) on ``cache``; device operands."""
        with torch.inference_mode():
            if self.paged:
                logits, _ = decode_step_paged(model, params, cache, tokens,
                                              positions, rows)
            else:
                logits, _ = decode_step(model, params, cache, tokens,
                                        positions, slots=rows)
        return logits

    def _run_verify(self, window, positions, rows=None):
        """One target verify pass over ``window`` ``(bucket, k)``;
        ``rows`` as :meth:`_run_decode` takes it.  Returns the target's
        greedy token after every window column, ``(bucket, k)``."""
        operands = dict(tokens=window, positions=positions)
        if rows is not None:
            operands['rows'] = rows
        return self._run(('verify', len(window)), operands)

    def _verify_logits(self, tokens, positions, rows):
        """The logits of one target verify pass; device operands."""
        params = self._view(self.params)
        if self.paged:
            logits, _ = spec_verify_paged(self.model, params, self._cache,
                                          tokens, positions, rows)
        else:
            logits, _ = spec_verify(self.model, params, self._cache, tokens,
                                    positions, slots=rows)
        return logits

    def _copy_page(self, src, dst):
        """Copy pool page ``src`` into the private page ``dst`` (already
        allocated): every layer's K and V, and under int8 both scale
        leaves.  A speculative engine copies the draft's page too: both
        caches are addressed through the same page tables."""
        self._copy_leaves(src, dst)
        self.cow_copies += 1

    def _copy_leaves(self, src, dst):
        caches = [self._cache] + ([self._draft_cache] if self.speculative
                                  else [])
        with GATE.call(), torch.inference_mode():
            for cache in caches:
                for leaf in cache.values():
                    leaf[:, dst] = leaf[:, src]

    def _zero_rows(self, bucket):
        """The row operand of an all-free decode or verify bucket."""
        if self.paged:
            return np.zeros((bucket, self.pages_per_seq), np.int32)
        return (None if bucket == self.n_slots
                else np.arange(bucket, dtype=np.int32))

    def _families(self):
        return FAMILIES if self.speculative else FAMILIES[:2]

    def _warm_keys(self, family):
        """``(bucket, call keys)`` of a family, largest bucket first."""
        if not family.endswith('prefill'):
            return [(b, [(family, b)])
                    for b in sorted(self.decode_edges, reverse=True)]
        widths = sorted(self._prefill_widths, reverse=True)
        if self.paged:
            return [(w, [(family, w, True), (family, w, False)])
                    for w in widths]
        return [(w, [(family, w)]) for w in widths]

    def _zero_operands(self, key):
        """Operands that write only where nothing is attended: on an idle
        engine every slot is free and every table points at the scratch
        page."""
        out = {name: 0 for name, _ in self._layout(key)}
        if 'length' in out:
            out['length'] = 1
        if 'rows' in out:
            out['rows'] = self._zero_rows(key[1])
        return out

    def _prepared(self, key):
        call = self._calls.get(key)
        return call is not None and (call.graph is not None
                                     if self._graphed else call.ran)

    def warmup(self):
        """Prepare every prefill width and decode bucket, largest first
        (and on a speculative engine every draft prefill width, draft
        decode bucket and verify bucket), each under a ``serve_warmup``
        span: on the card with ``aot`` capture its graph, else run it
        once.  The runs use zero operands on the idle engine: every slot
        is free and every table all zeros, so what they write is never
        attended.  Buckets already prepared are skipped.  Returns the
        JAX engine's ``{'prefill': {width: aot}, 'decode': {bucket:
        aot}}``, plus ``'draft_prefill'``, ``'draft_decode'`` and
        ``'verify'`` on a speculative engine."""
        plan = [(family, bucket, keys) for family in self._families()
                for bucket, keys in self._warm_keys(family)]
        todo = [item for item in plan
                if not all(self._prepared(k) for k in item[2])]
        if todo and (self._slots or self._prefilling):
            raise RuntimeError('warmup needs an idle engine: %d sequences '
                               'are live'
                               % (len(self._slots) + len(self._prefilling)))
        for family, bucket, keys in todo:
            with _telemetry.span('serve_warmup', kind='serve', phase=family,
                                 bucket=bucket):
                for key in keys:
                    if self._prepared(key):
                        continue
                    call = self._call(key)
                    if self._graphed:
                        with GATE.capture():
                            call.stage(self._zero_operands(key))
                            self._capture(key, call)
                    else:
                        call.stage(self._zero_operands(key))
                        call.run()
        if self.paged and todo:
            self._copy_leaves(0, 0)
        return self._aot_table(self._families())

    def _buckets(self, family):
        return sorted({key[1] for key in self._calls if key[0] == family})

    def _aot_table(self, families):
        """``{family: {bucket: aot}}`` over the prepared buckets: a bucket
        is ``aot`` when every call of it replays a graph."""
        return {family: {b: all(call.graph is not None
                                for key, call in self._calls.items()
                                if key[:2] == (family, b))
                         for b in self._buckets(family)}
                for family in families}

    def replayed_launches(self, since=None):
        """Kernel launches made by graph replays: each call's replays
        (less its count in ``since``, an earlier ``stats()['replays']``)
        times the wrapper counts recorded at its capture, summed by kernel
        name (``'<name>.tc'`` for the tensor-core routes).  A replay counts
        nothing in ``ops.launch_counts()``; eager runs are counted there."""
        since = since or {}
        out = {}
        for key, call in self._calls.items():
            n = call.replays - since.get(key, 0)
            for name, count in call.launches.items():
                out[name] = out.get(name, 0) + n * count
        return out

    def guard_signature(self, args):
        """Refuse any operand signature outside the prefill/decode/verify
        bucket set instead of running it: the scheduler and the bucket
        geometry must agree."""
        sig = _signature(args)
        if sig not in self._signatures:
            raise RuntimeError(
                'no-recompile guard: operand signature %r is outside the '
                'prefill/decode bucket set -- the scheduler and the bucket '
                'geometry disagree' % (sig,))
        return sig

    # -- paged-mode page accounting ------------------------------------
    def _release_pages(self, pages):
        for page in pages or ():
            self.pool.release(page)

    def _alloc_page(self):
        """One free page, LRU-evicting banked prefixes when the pool is
        dry; ``None`` only when nothing is evictable either (the caller
        sheds typed)."""
        page = self.pool.alloc()
        while page is None and self._prefix_index is not None \
                and self._prefix_index.evict(1):
            page = self.pool.alloc()
        return page

    def _grow(self, pages, last_position):
        """Allocate pages until ``pages`` covers ``last_position``; False
        when the pool ran dry (the caller sheds)."""
        while len(pages) <= last_position // self.page_size:
            page = self._alloc_page()
            if page is None:
                return False
            pages.append(page)
        return True

    def _tables(self, rows):
        """Page tables of decode rows (slot ids, ``None`` for a pad
        row): pad rows carry all-zero tables, i.e. the scratch page."""
        tables = np.zeros((len(rows), self.pages_per_seq), np.int32)
        for i, sid in enumerate(rows):
            if sid is not None:
                pages = self._slots[sid].pages
                tables[i, :len(pages)] = pages
        return tables

    def _shed_paged(self, req, pages, where):
        """Typed shed when the page pool is exhausted: the pages retained
        so far go back, the client gets ``OverloadError(reason=
        'kv_pages')``."""
        self._release_pages(pages)
        self.cancelled += 1
        record_shed('kv_pages', request_id=req.request_id,
                    queue_depth=self._last_queue_depth, where=where,
                    **self._ident())
        req.set_error(OverloadError(
            'KV page pool exhausted (%d/%d pages live, nothing evictable) '
            'during %s; retry with backoff'
            % (self.pool.in_use(), self.pool.n_pages, where),
            reason='kv_pages'))

    # -- the continuous-batching scheduler -----------------------------
    def _expire(self, now, force=0):
        """Shed requests whose deadline passed, live or mid-prefill (and
        the ``force`` oldest live ones, for the ``serve_cancel`` chaos
        site): typed ``OverloadError(reason='deadline')`` now, their pages
        back to the pool, the slot free for this step's admission."""
        ident = self._ident()
        doomed = [sid for sid, slot in self._slots.items()
                  if slot.request.deadline is not None
                  and now > slot.request.deadline]
        if force:
            doomed += sorted((s for s in self._slots if s not in doomed),
                             key=lambda s: self._slots[s].request.t_submit
                             )[:force]
        for sid in doomed:
            slot = self._slots.pop(sid)
            self._release_pages(slot.pages)
            self._free.append(sid)
            self.cancelled += 1
            slot.request.set_error(OverloadError(
                'deadline expired mid-generation after %d tokens'
                % len(slot.generated), reason='deadline'))
            _telemetry.event('serve_cancel', kind='serve', slot=sid,
                             tokens=len(slot.generated))
            record_shed('deadline', request_id=slot.request.request_id,
                        queue_depth=self._last_queue_depth, slot=sid,
                        tokens=len(slot.generated), **ident)
        late = [sid for sid, st in self._prefilling.items()
                if st.request.deadline is not None
                and now > st.request.deadline]
        for sid in late:
            st = self._prefilling.pop(sid)
            self._release_pages(st.pages)
            self._free.append(sid)
            self.cancelled += 1
            st.request.set_error(OverloadError(
                'deadline expired mid-prefill at position %d' % st.pos,
                reason='deadline'))
            _telemetry.event('serve_cancel', kind='serve', slot=sid,
                             tokens=0)
            record_shed('deadline', request_id=st.request.request_id,
                        queue_depth=self._last_queue_depth, slot=sid,
                        position=st.pos, **ident)
        return len(doomed) + len(late)

    def _first_token(self, sid, req, tok, clock, t_prefill0, attrs,
                     pages=None):
        """A prompt's first token is out: record its ``prefill`` stage
        (from ``t_prefill0`` on the recorder's clock) and TTFT, then the
        request completes (eos or a one-token budget) or its slot moves to
        the decode phase."""
        self.prefills += 1
        self.tokens_generated += 1
        rec = _telemetry.active()
        reg = _telemetry.registry()
        t_first = clock()
        t_first_tele = None
        if rec is not None:
            t_first_tele = rec.now()
            rec.child_span(req.request_id, 'prefill', t_prefill0,
                           t_first_tele, slot=sid,
                           prompt_tokens=int(req.prompt.size), **attrs,
                           **self._ident())
        if reg is not None:
            reg.histogram('serve_ttft_seconds',
                          help='submit-to-first-token latency (s)'
                          ).observe(t_first - req.t_submit)
            reg.counter('serve_tokens_total', help='generated tokens').inc()
        req.notify_tokens([tok])
        if self.eos_id is not None and tok == self.eos_id \
                or req.max_new_tokens == 1:
            req.set_result([tok])
            self._release_pages(pages)
            self._free.append(sid)
            if rec is not None:
                rec.event('complete', kind='request',
                          request_id=req.request_id, tokens=1, slot=sid,
                          **self._ident())
            return
        self._slots[sid] = _Slot(req, req.prompt.size,
                                 req.max_new_tokens - 1, tok, t_first,
                                 t_stage_end=t_first_tele, pages=pages)

    def _admit_budget(self):
        """Admissions this tick: every free slot, or ``admit_cap``."""
        if self.admit_cap is None:
            return len(self._free)
        return min(len(self._free), max(0, int(self.admit_cap)))

    def _queue_wait(self, req, clock):
        """Record a popped request's ``queue_wait`` stage; returns the
        pop instant on the recorder's clock (None when telemetry is
        off)."""
        rec = _telemetry.active()
        if rec is None:
            return None
        t_pop = rec.now()
        t0 = req.t_trace0
        if t0 is None:   # telemetry enabled mid-flight
            t0 = t_pop - (clock() - req.t_submit)
        rec.child_span(req.request_id, 'queue_wait', t0, t_pop, seq=req.seq,
                       **self._ident())
        return t_pop

    def _bucket_pack(self, req, t0, bucket, n, **attrs):
        """Record a request's ``bucket_pack`` stage (from ``t0`` to now);
        returns its end."""
        rec = _telemetry.active()
        if rec is None:
            return None
        t1 = rec.now()
        rec.child_span(req.request_id, 'bucket_pack', t0, t1, bucket=bucket,
                       pad_fraction=round((bucket - n) / float(bucket), 4),
                       **attrs, **self._ident())
        return t1

    def _admit(self, queue, clock):
        """Refill free slots from the queue.  Slot cache: one PREFILL per
        request, bucketed by prompt length (and the draft's prefill of
        the same prompt on a speculative engine).  Paged: see
        :meth:`_admit_paged`."""
        if self.paged:
            self._admit_paged(queue, clock)
            return
        for req in queue.pop(self._admit_budget()):
            sid = self._free.pop(0)
            t_pop = self._queue_wait(req, clock)
            prompt = req.prompt
            bucket = bucket_of(prompt.size, self.prefill_edges)
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :prompt.size] = prompt
            self.guard_signature((tokens, np.int32(prompt.size),
                                  np.int32(sid)))
            t_pf0 = self._bucket_pack(req, t_pop, bucket, prompt.size)
            ident = self._ident()
            self._slow()
            with _telemetry.span('serve_prefill', kind='serve',
                                 bucket=bucket, slot=sid,
                                 iteration=self._step_index, **ident):
                tok = self._run_prefill(tokens, prompt.size, sid)
            if self.speculative:
                # the draft banks the prompt in its own cache; its own
                # first token is discarded (the target's is authoritative)
                with _telemetry.span('serve_draft', kind='serve',
                                     stage='prefill', bucket=bucket,
                                     slot=sid, iteration=self._step_index,
                                     **ident):
                    self._run_prefill(tokens, prompt.size, sid, draft=True)
            self._first_token(sid, req, tok, clock, t_pf0,
                              dict(bucket=bucket))

    def _admit_paged(self, queue, clock):
        """Paged admission: claim a slot id, walk the prefix index for
        the longest banked prefix (retaining its shared FULL pages; a
        partly covered boundary page is copied once, here), and park the
        request in ``self._prefilling``; :meth:`_prefill_tick` runs its
        prefill."""
        reg = _telemetry.registry()
        group = self._prefix_index is not None
        for req in queue.pop(self._admit_budget(), group_prefix=group):
            sid = self._free.pop(0)
            t_pop = self._queue_wait(req, clock)
            prompt = req.prompt
            pages, matched = [], 0
            if self._prefix_index is not None:
                shared, tail_page, tail_len = self._prefix_index.lookup(
                    prompt)
                # always recompute >= 1 prompt token (the last chunk gives
                # the first token's logits): cap the match at size - 1 and
                # demote an over-covering full page to a copy candidate
                max_match = prompt.size - 1
                dropped = None
                while len(shared) * self.page_size > max_match:
                    dropped = shared.pop()
                for page in shared:
                    self.pool.retain(page)
                    pages.append(page)
                matched = len(shared) * self.page_size
                if dropped is not None:
                    tail_page, tail_len = dropped, self.page_size
                tail_use = (min(tail_len, max_match - matched)
                            if tail_page is not None else 0)
                if tail_use > 0:
                    dst = self._alloc_page()
                    if dst is None:
                        self._shed_paged(req, pages, 'admission')
                        self._free.append(sid)
                        continue
                    self._copy_page(tail_page, dst)
                    pages.append(dst)
                    matched += tail_use
                if reg is not None and matched:
                    reg.counter('serve_prefix_hits_total',
                                help='admissions that reused a banked '
                                     'prompt prefix').inc()
                    reg.counter('serve_prefix_tokens_total',
                                help='prompt tokens served from banked '
                                     'prefix pages').inc(matched)
            self._prefilling[sid] = _PrefillState(req, pages, matched,
                                                  matched, t_stage_end=t_pop)

    def _prefill_tick(self, clock):
        """Advance every mid-prefill sequence by ONE chunk (the whole
        remaining prompt, bucketed, without ``prefill_chunk``).  A
        finished prompt's pages are banked in the prefix index before the
        sequence moves to decode.  The last chunk records the request's
        ``prefill`` stage; the chunks before it ``prefill_chunk`` stages.
        Returns True when a chunk ran."""
        rec = _telemetry.active()
        worked = False
        for sid in sorted(self._prefilling):
            st = self._prefilling[sid]
            req = st.request
            prompt = req.prompt
            remaining = prompt.size - st.pos
            width = (self.prefill_chunk if self.prefill_chunk is not None
                     else bucket_of(remaining, self.prefill_edges))
            n = min(width, remaining)
            if not self._grow(st.pages, st.pos + n - 1):
                del self._prefilling[sid]
                self._shed_paged(req, st.pages, 'prefill')
                self._free.append(sid)
                continue
            worked = True
            tokens = np.zeros((1, width), np.int32)
            tokens[0, :n] = prompt[st.pos:st.pos + n]
            table = np.zeros((self.pages_per_seq,), np.int32)
            table[:len(st.pages)] = st.pages
            self.guard_signature((tokens, np.int32(n), np.int32(st.pos),
                                  table))
            if st.chunks == 0:
                st.t_stage_end = self._bucket_pack(
                    req, st.t_stage_end, width, n, prefix_tokens=st.matched)
            ident = self._ident()
            self._slow()
            with _telemetry.span('serve_prefill', kind='serve',
                                 bucket=width, slot=sid, chunk=st.chunks,
                                 pos=st.pos, iteration=self._step_index,
                                 **ident):
                tok = self._run_prefill(tokens, n, (st.pos, table))
            if self.speculative:
                # the same chunk into the same pages of the draft cache:
                # banked prefix pages then serve the draft too
                with _telemetry.span('serve_draft', kind='serve',
                                     stage='prefill', bucket=width,
                                     slot=sid, chunk=st.chunks,
                                     iteration=self._step_index, **ident):
                    self._run_prefill(tokens, n, (st.pos, table),
                                      draft=True)
            st.pos += n
            st.chunks += 1
            self.prefill_chunks += 1
            if st.pos < prompt.size:
                if rec is not None:
                    t1 = rec.now()
                    rec.child_span(req.request_id, 'prefill_chunk',
                                   st.t_stage_end, t1, bucket=width,
                                   slot=sid, chunk=st.chunks - 1,
                                   pos=st.pos, **ident)
                    st.t_stage_end = t1
                continue
            del self._prefilling[sid]
            if self._prefix_index is not None:
                n_cover = -(-prompt.size // self.page_size)
                self._prefix_index.insert(prompt, st.pages[:n_cover])
            self._first_token(sid, req, tok, clock, st.t_stage_end,
                              dict(bucket=width, chunks=st.chunks,
                                   prefix_tokens=st.matched), st.pages)
        return worked

    def _decode_rows(self):
        """``(rows, bucket, k)`` of this tick's decode: the active slots
        padded to a bucket.  Paged rows are positional (pad rows are
        ``None``); the full slot bucket is every slot in id order (an
        inactive row writes a garbage token at position 0 of its FREE
        slot, overwritten by that slot's next prefill); a compacted slot
        bucket pads with free slots (there are enough)."""
        active = sorted(self._slots)
        k = len(active)
        bucket = bucket_of(k, self.decode_edges)
        if self.paged:
            rows = active + [None] * (bucket - k)
        elif bucket == self.n_slots:
            rows = list(range(self.n_slots))
        else:
            rows = active + self._free[:bucket - k]
        return rows, bucket, k

    def _row_operand(self, rows, bucket):
        if self.paged:
            return self._tables(rows)
        return (None if bucket == self.n_slots
                else np.asarray(rows, np.int32))

    def _finish(self, sid, slot):
        slot.request.set_result(slot.generated)
        rec = _telemetry.active()
        if rec is not None:
            rec.event('complete', kind='request',
                      request_id=slot.request.request_id,
                      tokens=len(slot.generated), slot=sid, **self._ident())
        self._release_pages(slot.pages)
        del self._slots[sid]
        self._free.append(sid)

    def _grow_or_shed(self, window):
        """Paged: grow every live table to cover the next ``window``
        positions before dispatch (clamped at the cache depth); a dry
        pool sheds that request typed."""
        for sid in sorted(self._slots):
            slot = self._slots[sid]
            last = min(slot.position + window - 1, self.max_len - 1)
            if not self._grow(slot.pages, last):
                del self._slots[sid]
                self._shed_paged(slot.request, slot.pages, 'decode')
                self._free.append(sid)

    def _emitted(self, sid, slot, emitted, now, t0, **attrs):
        """Commit a tick's tokens to a slot: stream them, advance the
        position, observe the inter-token gaps (a tick of ``c`` tokens
        spreads its gap over them) and record the request's ``decode``
        stage, which starts where its previous stage ended (so a
        neighbour's prefill between ticks is latency this request
        paid)."""
        c = len(emitted)
        slot.generated.extend(emitted)
        slot.request.notify_tokens(emitted)
        slot.position += c
        slot.remaining -= c
        reg = _telemetry.registry()
        if reg is not None:
            itl = reg.histogram(
                'serve_intertoken_seconds',
                help='per-sequence gap between consecutive tokens (s)')
            gap = (now - slot.t_last_token) / c
            for _ in range(c):
                itl.observe(gap)
        slot.t_last_token = now
        rec = _telemetry.active()
        if rec is not None:
            now_tele = rec.now()
            t_prev = slot.t_stage_end
            if t_prev is None:
                t_prev = now_tele - (now - t0)
            rec.child_span(slot.request.request_id, 'decode', t_prev,
                           now_tele, slot=sid, step=self._step_index,
                           token_index=len(slot.generated) - 1, **attrs,
                           **self._ident())
            slot.t_stage_end = now_tele

    def _tick_done(self, t0, now, tokens):
        reg = _telemetry.registry()
        if reg is not None:
            reg.histogram('serve_decode_seconds',
                          help='per-decode-step wall time (s)'
                          ).observe(now - t0)
            reg.counter('serve_tokens_total', help='generated tokens'
                        ).inc(tokens)

    def _decode_once(self, clock):
        """One decode step over every active slot, compacted to the
        smallest bucket; finished sequences resolve and free their slots
        (refilled at the NEXT step)."""
        if self.paged:
            self._grow_or_shed(1)
            if not self._slots:
                return
        rows, bucket, k = self._decode_rows()
        tokens = np.asarray(
            [self._slots[s].generated[-1] if s in self._slots else 0
             for s in rows], np.int32)
        positions = np.asarray(
            [self._slots[s].position if s in self._slots else 0
             for s in rows], np.int32)
        row_op = self._row_operand(rows, bucket)
        if self.paged:
            self.guard_signature((tokens, positions, row_op))
        else:
            self.guard_signature((tokens, positions) if row_op is None
                                 else (tokens, row_op, positions))
        reg = _telemetry.registry()
        if reg is not None:
            reg.gauge('active_slots',
                      help='live sequences at this decode step').set(k)
        self._slow()
        t0 = clock()
        with _telemetry.span('serve_decode', kind='serve',
                             iteration=self._step_index, active_slots=k,
                             bucket=bucket, n_slots=self.n_slots,
                             queue_depth=self._last_queue_depth,
                             **self._ident()):
            toks = self._run_decode(tokens, positions, row_op)
        now = clock()
        for i, sid in enumerate(rows):
            slot = self._slots.get(sid)
            if slot is None:
                continue   # pad row (or inactive full-bucket row)
            tok = int(toks[i])
            self._emitted(sid, slot, [tok], now, t0)
            if slot.remaining == 0 or (self.eos_id is not None
                                       and tok == self.eos_id):
                self._finish(sid, slot)
        self.decode_steps += 1
        self.tokens_generated += k
        self._tick_done(t0, now, k)

    def _spec_once(self, clock):
        """One SPECULATIVE tick over every active slot: ``spec_tokens``
        draft decode steps propose a window, one target verify scores
        it, and each row commits the longest prefix where draft and
        target agree plus the target's own next token (the correction
        at the first divergence, the bonus on full acceptance).

        Rollback is a position rewind: rejected positions' K/V in both
        caches stay as garbage masked by the live length, and in paged
        mode the page-table tail past the accepted boundary goes back
        to the pool."""
        kk = self.spec_tokens
        if self.paged:
            self._grow_or_shed(kk)
            if not self._slots:
                return
        rows, bucket, k = self._decode_rows()
        base_tok = np.asarray(
            [self._slots[s].generated[-1] if s in self._slots else 0
             for s in rows], np.int32)
        base_pos = np.asarray(
            [self._slots[s].position if s in self._slots else 0
             for s in rows], np.int32)
        row_op = self._row_operand(rows, bucket)

        def guard(tok, pos):
            if self.paged:
                self.guard_signature((tok, pos, row_op))
            else:
                self.guard_signature((tok, pos) if row_op is None
                                     else (tok, row_op, pos))

        reg = _telemetry.registry()
        if reg is not None:
            reg.gauge('active_slots',
                      help='live sequences at this decode step').set(k)
        ident = self._ident()
        self._slow()
        t0 = clock()
        # the draft proposes: k steps, positions clamped at the cache
        # depth (a proposal past it is garbage and never committed)
        proposals = np.zeros((bucket, kk), np.int32)
        cur = base_tok
        with _telemetry.span('serve_draft', kind='serve', stage='decode',
                             iteration=self._step_index, active_slots=k,
                             bucket=bucket, window=kk, **ident):
            for j in range(kk):
                pos = np.minimum(base_pos + j,
                                 self.max_len - 1).astype(np.int32)
                guard(cur, pos)
                cur = self._run_decode(cur, pos, row_op,
                                       draft=True).astype(np.int32)
                proposals[:, j] = cur
                self.draft_steps += 1
        # the window: [last committed token, draft_1 .. draft_{k-1}]; the
        # k-th proposal is never verified -- its step keeps the draft
        # cache covering every position the window can commit
        win = np.zeros((bucket, kk), np.int32)
        win[:, 0] = base_tok
        win[:, 1:] = proposals[:, :kk - 1]
        guard(win, base_pos)
        with _telemetry.span('serve_verify', kind='serve',
                             iteration=self._step_index, active_slots=k,
                             bucket=bucket, window=kk, n_slots=self.n_slots,
                             queue_depth=self._last_queue_depth, **ident):
            tgt = self._run_verify(win, base_pos, row_op)
        now = clock()
        self.verify_steps += 1
        proposed = accepted = emitted_total = 0
        for i, sid in enumerate(rows):
            slot = self._slots.get(sid)
            if slot is None:
                continue   # pad row (or inactive full-bucket row)
            drafts, targets = win[i, 1:], tgt[i]
            m = 0
            while m < kk - 1 and drafts[m] == targets[m]:
                m += 1
            proposed += kk - 1
            accepted += m
            emitted = [int(x) for x in drafts[:m]] + [int(targets[m])]
            # the budget first, then eos: where the plain loop stops
            emitted = emitted[:min(len(emitted), slot.remaining)]
            if self.eos_id is not None and self.eos_id in emitted:
                emitted = emitted[:emitted.index(self.eos_id) + 1]
            self._emitted(sid, slot, emitted, now, t0, tokens=len(emitted),
                          accepted=m)
            emitted_total += len(emitted)
            if slot.remaining == 0 or (self.eos_id is not None
                                       and emitted[-1] == self.eos_id):
                self._finish(sid, slot)
            elif self.paged:
                # roll the table back to the accepted boundary: pages
                # grown for rejected positions return to the pool now
                keep = (slot.position - 1) // self.page_size + 1
                while len(slot.pages) > keep:
                    self.pool.release(slot.pages.pop())
        self.draft_proposed += proposed
        self.draft_accepted += accepted
        self.decode_steps += 1
        self.tokens_generated += emitted_total
        self._tick_done(t0, now, emitted_total)
        if reg is not None:
            reg.counter('serve_draft_proposed_total',
                        help='draft tokens submitted to target verify'
                        ).inc(proposed)
            reg.counter('serve_draft_accepted_total',
                        help='draft tokens whose target argmax agreed'
                        ).inc(accepted)
        rec = _telemetry.active()
        if rec is not None:
            rec.event('serve_spec', kind='serve', iteration=self._step_index,
                      proposed=proposed, accepted=accepted,
                      tokens=emitted_total, **ident)

    def _flight_table(self):
        """The in-flight request table every flight dump embeds
        (``Recorder.flight_sources['serve_requests']``): which requests
        were alive, in which slot and stage, with how many tokens out."""
        active = []
        for sid in sorted(self._prefilling):
            st = self._prefilling.get(sid)
            if st is None:
                continue   # refilled by the dying scheduler meanwhile
            active.append({'slot': sid, 'request_id': st.request.request_id,
                           'stage': 'prefill', 'tokens': 0,
                           'position': st.pos,
                           'remaining': st.request.max_new_tokens})
        for sid in sorted(self._slots):
            slot = self._slots.get(sid)
            if slot is None:
                continue
            active.append({'slot': sid,
                           'request_id': slot.request.request_id,
                           'stage': 'decode', 'tokens': len(slot.generated),
                           'position': slot.position,
                           'remaining': slot.remaining})
        return {'active': active, 'free_slots': list(self._free),
                'step_index': self._step_index,
                'queue_depth': self._last_queue_depth}

    def step(self, queue, clock=time.monotonic):
        """One scheduler tick: expire -> admit (slot refill) -> one
        prefill chunk per mid-prefill sequence (paged) -> one decode
        step (speculative or plain).  Returns True when any work ran.
        With telemetry on, the queue pressure is gauged every tick
        (``serve_queue_depth``, ``serve_prefill_backlog``,
        ``serve_decode_backlog``; paged: the pages in use and free)."""
        depth = queue.depth()
        self._last_queue_depth = depth
        rec = _telemetry.active()
        if rec is not None and rec.flight_sources.get(
                'serve_requests') != self._flight_table:
            rec.flight_sources['serve_requests'] = self._flight_table
        reg = _telemetry.registry()
        if reg is not None:
            reg.gauge('serve_queue_depth',
                      help='requests waiting in the generation queue at '
                           'the scheduler tick').set(depth)
            reg.gauge('serve_prefill_backlog',
                      help='queued requests still needing their prefill '
                           '(queued + mid-prefill)'
                      ).set(depth + len(self._prefilling))
            reg.gauge('serve_decode_backlog',
                      help='live slots still generating at the tick'
                      ).set(len(self._slots))
            if self.paged:
                reg.gauge('serve_kv_pages_in_use',
                          help='allocated KV pages at the tick'
                          ).set(self.pool.in_use())
                reg.gauge('serve_kv_pages_free',
                          help='free KV pages at the tick'
                          ).set(self.pool.available())
        force = (_chaos.on_serve_cancel()
                 if _chaos._active is not None else 0)
        self._expire(clock(), force=force)
        self._admit(queue, clock)
        worked = False
        if self.paged and self._prefilling:
            worked = self._prefill_tick(clock)
        if self._slots:
            if _chaos._active is not None:
                # replica_kill counts DECODE ticks (slots live), so a fired
                # site always dies with generations in flight
                _chaos.on_replica_kill()
            if self.speculative:
                self._spec_once(clock)
            else:
                self._decode_once(clock)
            worked = True
        if worked:
            self._step_index += 1
        return worked

    def run(self, queue, stop=None, idle_sleep=0.002):
        """Scheduler loop: tick until ``stop`` is set and the queue and
        the slots are drained (the load generator's worker thread).  The
        thread takes the engine's device as its current one."""
        if self.device.type == 'cuda':
            torch.cuda.set_device(self.device)
        while True:
            if not self.step(queue):
                if stop is not None and stop.is_set() \
                        and queue.depth() == 0 and not self._slots \
                        and not self._prefilling:
                    return
                time.sleep(idle_sleep)

    def stats(self):
        """Counters and geometry, with the JAX engine's keys: ``aot`` per
        prepared bucket (True where its calls replay CUDA graphs),
        ``aot_requested``, ``cache_persistent`` (a graph cannot be
        persisted), and the trace and compile counts as graph captures (0
        eagerly).  ``replays`` and ``graph_launches`` (by call key) are
        what :meth:`replayed_launches` multiplies; the page copy
        (``copy_aot``) always runs eagerly."""
        out = {
            'prefill_buckets': self._buckets('prefill'),
            'decode_buckets': self._buckets('decode'),
            'label': self.label,
            'param_version': self.param_version,
            'prefill_edges': list(self.prefill_edges),
            'decode_edges': list(self.decode_edges),
            'n_slots': self.n_slots,
            'aot': self._aot_table(('prefill', 'decode')),
            'aot_requested': self.aot_requested,
            'cache_dir': self.cache_dir,
            'cache_persistent': self.cache_persistent,
            'quantized': self.quantized,
            'int8_kv': self.int8_kv,
            'prefill_trace_count': self.captures['prefill'],
            'decode_trace_count': self.captures['decode'],
            'compile_count': sum(self.captures.values()),
            'replays': {key: call.replays
                        for key, call in self._calls.items()
                        if call.graph is not None},
            'graph_launches': {key: dict(call.launches)
                               for key, call in self._calls.items()
                               if call.graph is not None},
            'prefills': self.prefills,
            'decode_steps': self.decode_steps,
            'tokens_generated': self.tokens_generated,
            'cancelled': self.cancelled,
            'active_slots': len(self._slots),
        }
        if self.paged:
            out.update(
                paged=True, page_size=self.page_size, n_pages=self.n_pages,
                pages_per_seq=self.pages_per_seq,
                pages_in_use=self.pool.in_use(),
                pages_free=self.pool.available(),
                peak_pages_in_use=self.pool.peak_in_use,
                prefill_chunk=self.prefill_chunk,
                prefill_chunks=self.prefill_chunks,
                cow_copies=self.cow_copies, copy_trace_count=0,
                copy_aot=False, prefilling=len(self._prefilling))
            if self._prefix_index is not None:
                index = self._prefix_index
                out.update(prefix_lookups=index.lookups,
                           prefix_hits=index.hits,
                           prefix_hit_rate=index.hit_rate(),
                           prefix_tokens_reused=index.tokens_reused)
        out['speculative'] = False
        if self.speculative:
            out['speculative'] = {
                'spec_tokens': self.spec_tokens,
                'draft_steps': self.draft_steps,
                'verify_steps': self.verify_steps,
                'draft_proposed': self.draft_proposed,
                'draft_accepted': self.draft_accepted,
                'accepted_draft_rate': (
                    self.draft_accepted / self.draft_proposed
                    if self.draft_proposed else None),
                'draft_decode_buckets': self._buckets('draft_decode'),
                'verify_buckets': self._buckets('verify'),
                'draft_trace_count': (self.captures['draft_prefill']
                                      + self.captures['draft_decode']),
                'verify_trace_count': self.captures['verify'],
                'aot': self._aot_table(FAMILIES[2:]),
            }
        return out
