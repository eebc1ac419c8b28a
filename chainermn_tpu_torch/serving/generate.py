"""Autoregressive generation: bucketed slot-KV-cache decode with
continuous token-level batching.

Counterpart of the slot-cache mode of ``chainermn_tpu/serving/generate.py``:

- **Prefill** runs one prompt per call, padded to a power-of-two
  PROMPT-LENGTH bucket, and banks every layer's K/V in one cache slot
  (:func:`chainermn_tpu_torch.models.prefill`).
- **Decode** runs one token per live sequence, padded to a power-of-two
  ACTIVE-SLOT-COUNT bucket, over the same persistent cache
  (:func:`chainermn_tpu_torch.models.decode_step`).  The full bucket
  reads the cache in place (row i IS slot i); a smaller bucket carries a
  row -> slot map.
- **Continuous batching**: a sequence that finishes (or whose deadline
  expires mid-generation) frees its slot, and the slot is refilled from
  the queue at the NEXT step; the rest of the batch never waits.

Decoding is greedy (argmax on the device; only the token ids come back
to the host).  The cache is updated in place, which is what the JAX
package's buffer donation buys there.  The JAX package compiles one
executable per bucket and refuses any operand signature outside that
set (``abstract_signature``); the port runs eagerly, and
:meth:`GenerationEngine.guard_signature` keeps the same refusal over the
set of bucket shapes, so a later CUDA graph per bucket can rely on it.

Not ported yet (they raise ``NotImplementedError``, ROADMAP.md A8): the
paged cache and chunked prefill, speculative decoding, tensor-parallel
serving (``plan`` / ``param_specs``), ``Int8Policy`` weights,
``swap_params`` and ``from_checkpoint``.  Telemetry spans and metrics,
chaos sites and the load generator are host layers of ROADMAP.md A9.
"""

import threading
import time

import numpy as np
import torch

from chainermn_tpu_torch.models.flax_weights import param_tree
from chainermn_tpu_torch.models.transformer import (decode_step,
                                                    init_kv_cache, prefill)
from chainermn_tpu_torch.ops._common import resolve_device
from chainermn_tpu_torch.precision import cast_floating
from chainermn_tpu_torch.serving.batcher import (bucket_edges, bucket_of,
                                                 next_request_id)
from chainermn_tpu_torch.utils.failure import OverloadError

#: default admission knobs (the generation twins of batcher's)
DEFAULT_MAX_QUEUE = 256


class GenRequest:
    """One in-flight generation request: ``prompt`` (1-D int32 token
    ids), ``max_new_tokens``, optional absolute ``deadline``
    (``clock()`` units, enforced at admission AND between decode steps),
    and a one-shot completion cell filled with the generated token ids
    or a typed error.  ``on_token`` (optional) is called as
    ``on_token(request_id, [int, ...])`` each time tokens are emitted."""

    __slots__ = ('prompt', 'max_new_tokens', 'deadline', 'seq',
                 't_submit', 'request_id', 'on_token', '_done', '_result',
                 '_error')

    def __init__(self, prompt, max_new_tokens, deadline=None, seq=0,
                 t_submit=0.0, request_id=None, on_token=None):
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
        self.on_token = on_token
        self.request_id = request_id or next_request_id()
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
        shutdown)."""
        if not self._done.wait(timeout):
            raise TimeoutError('request %d not completed within %rs'
                               % (self.seq, timeout))
        if self._error is not None:
            raise self._error
        return self._result


class GenerationQueue:
    """Bounded admission queue for generation requests: the engine pops
    AT MOST as many requests as it has free cache slots each step; a
    full or closed queue sheds typed (``OverloadError``)."""

    def __init__(self, max_prompt_len, max_queue=DEFAULT_MAX_QUEUE,
                 clock=time.monotonic, page_size=None):
        if page_size:
            raise NotImplementedError(
                'the paged engine and its prefix keys are not ported yet '
                '(ROADMAP.md A8)')
        self.max_prompt_len = int(max_prompt_len)
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
        with self._lock:
            if self._closed:
                raise OverloadError('generation queue is shut down',
                                    reason='shutdown',
                                    queue_depth=len(self._waiting))
            if len(self._waiting) >= self.max_queue:
                self.shed_queue_full += 1
                raise OverloadError(
                    'generation queue full (%d waiting); retry with '
                    'backoff' % len(self._waiting),
                    reason='queue_full', queue_depth=len(self._waiting))
            self._seq += 1
            self.submitted += 1
            req = GenRequest(prompt, max_new_tokens, deadline=deadline,
                             seq=self._seq, t_submit=self._clock(),
                             request_id=request_id, on_token=on_token)
            self._waiting.append(req)
        return req

    def pop(self, k):
        """Up to ``k`` live requests in arrival order; requests whose
        deadline already expired while queued are shed typed here."""
        now = self._clock()
        out = []
        with self._lock:
            while self._waiting and len(out) < k:
                req = self._waiting.pop(0)
                if req.deadline is not None and now > req.deadline:
                    self.shed_deadline += 1
                    req.set_error(OverloadError(
                        'deadline expired after %.1f ms in queue'
                        % ((now - req.t_submit) * 1e3), reason='deadline'))
                    continue
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
            req.set_error(OverloadError('generation queue shut down',
                                        reason='shutdown'))

    def stats(self):
        return {'submitted': self.submitted,
                'shed_queue_full': self.shed_queue_full,
                'shed_deadline': self.shed_deadline,
                'depth': self.depth()}


class _Slot:
    """Host-side state of one cache slot."""

    __slots__ = ('request', 'position', 'remaining', 'generated')

    def __init__(self, request, position, remaining, first_token):
        self.request = request
        self.position = position          # next token's position
        self.remaining = remaining        # tokens still to generate
        self.generated = [first_token]


def _signature(args):
    """Shapes and dtypes of an operand tuple (numpy arrays, numpy
    scalars or tensors)."""
    return tuple((tuple(a.shape), str(a.dtype).replace('torch.', ''))
                 for a in args)


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
      max_len: cache depth per slot (default ``model.max_len``).
      eos_id: optional stop token.
      policy: a float :class:`~chainermn_tpu_torch.precision.Policy`
        casts the weights to its compute dtype at load.
      int8_kv: store the KV cache int8 with per-(position, head) scales.
      device: where the engine runs (default: the current CUDA device;
        raises when there is none).
    """

    def __init__(self, model, params=None, n_slots=8, max_prompt_len=64,
                 max_len=None, eos_id=None, policy=None, int8_kv=False,
                 paged=False, page_size=16, n_pages=None,
                 prefill_chunk=None, prefix_sharing=True, draft_model=None,
                 draft_params=None, spec_tokens=4, plan=None,
                 param_specs=None, device=None):
        del page_size, prefix_sharing, spec_tokens  # paged / speculative
        if paged or n_pages is not None or prefill_chunk:
            _unported('the paged KV cache (paged=, n_pages=, '
                      'prefill_chunk=)')
        if draft_model is not None or draft_params is not None:
            _unported('speculative decoding (draft_model=)')
        if plan is not None or param_specs is not None:
            _unported('tensor-parallel serving (plan=, param_specs=)', 'A7')
        if getattr(policy, 'quantize', None) is not None:
            _unported('int8 weight quantization (Int8Policy)')
        self.model = model
        self.device = resolve_device(device)
        self.n_slots = int(n_slots)
        self.max_prompt_len = int(max_prompt_len)
        self.max_len = int(max_len or model.max_len)
        if self.max_prompt_len > self.max_len:
            raise ValueError('max_prompt_len %d exceeds cache depth %d'
                             % (self.max_prompt_len, self.max_len))
        self.eos_id = eos_id
        self.policy = policy
        self.prefill_edges = bucket_edges(self.max_prompt_len)
        self.decode_edges = bucket_edges(self.n_slots)
        self.params = self._place_params(
            param_tree(model) if params is None else params)
        self.int8_kv = bool(int8_kv)
        self._cache = init_kv_cache(model, self.n_slots, self.max_len,
                                    int8_kv=self.int8_kv, device=self.device)
        self._slots = {}      # slot id -> _Slot
        self._free = list(range(self.n_slots))
        self._prefill_run = set()   # prompt buckets run so far
        self._decode_run = set()    # slot buckets run so far
        i32 = np.zeros((), np.int32)
        self._signatures = {
            _signature((np.zeros((1, b), np.int32), i32, i32))
            for b in self.prefill_edges}
        for b in self.decode_edges:
            vec = np.zeros((b,), np.int32)
            self._signatures.add(_signature(
                (vec, vec) if b == self.n_slots else (vec, vec, vec)))
        self.prefills = 0
        self.decode_steps = 0
        self.tokens_generated = 0
        self.cancelled = 0

    def _place_params(self, params):
        """Load-time transform + placement: tensors detached from
        autograd, cast to the policy's compute dtype, on the device."""
        def place(x):
            if isinstance(x, dict):
                return {k: place(v) for k, v in x.items()}
            t = x.detach() if torch.is_tensor(x) else torch.as_tensor(
                np.asarray(x))
            return t.to(self.device)
        host = place(params)
        if self.policy is not None:
            host = cast_floating(host, self.policy.compute_dtype)
        return host

    def swap_params(self, params, version=None, validate=True):
        _unported('live weight hot-swap (swap_params)')

    @classmethod
    def from_checkpoint(cls, path, model, params_template, **kw):
        _unported('loading serving weights from a checkpoint')

    # -- device calls --------------------------------------------------
    def _tokens(self, logits):
        """Greedy tokens of ``logits`` ``(..., V)`` as numpy."""
        return torch.argmax(logits, dim=-1).reshape(-1).cpu().numpy()

    def _run_prefill(self, tokens, length, slot):
        with torch.inference_mode():
            logits, self._cache = prefill(
                self.model, self.params, self._cache,
                torch.from_numpy(tokens).to(self.device), length, slot)
            return int(self._tokens(logits)[0])

    def _run_decode(self, tokens, positions, slots=None):
        dev = self.device
        with torch.inference_mode():
            logits, self._cache = decode_step(
                self.model, self.params, self._cache,
                torch.from_numpy(tokens).to(dev),
                torch.from_numpy(positions).to(dev),
                slots=None if slots is None
                else torch.from_numpy(slots).to(dev))
            return self._tokens(logits)

    def warmup(self):
        """Run every prefill and decode bucket once, largest first, on the
        idle engine: the first call builds the kernels.  Every slot is
        free, so the garbage the runs write is never attended (reads
        mask by live length).  Returns ``{'prefill': {bucket: seconds},
        'decode': {bucket: seconds}}``."""
        if self._slots:
            raise RuntimeError('warmup needs an idle engine: %d sequences '
                               'are live' % len(self._slots))
        out = {'prefill': {}, 'decode': {}}
        for bucket in sorted(self.prefill_edges, reverse=True):
            t0 = time.perf_counter()
            self._run_prefill(np.zeros((1, bucket), np.int32), 1, 0)
            out['prefill'][bucket] = time.perf_counter() - t0
            self._prefill_run.add(bucket)
        for bucket in sorted(self.decode_edges, reverse=True):
            zeros = np.zeros((bucket,), np.int32)
            slots = (None if bucket == self.n_slots
                     else np.arange(bucket, dtype=np.int32))
            t0 = time.perf_counter()
            self._run_decode(zeros, zeros, slots)
            out['decode'][bucket] = time.perf_counter() - t0
            self._decode_run.add(bucket)
        return out

    def guard_signature(self, args):
        """Refuse any operand signature outside the prefill/decode bucket
        set instead of running it: the scheduler and the bucket geometry
        must agree."""
        sig = _signature(args)
        if sig not in self._signatures:
            raise RuntimeError(
                'no-recompile guard: operand signature %r is outside the '
                'prefill/decode bucket set -- the scheduler and the bucket '
                'geometry disagree' % (sig,))
        return sig

    # -- the continuous-batching scheduler -----------------------------
    def _expire(self, now):
        """Shed active requests whose deadline passed: typed
        ``OverloadError(reason='deadline')`` now, slot freed for refill
        at this step's admission."""
        doomed = [sid for sid, slot in self._slots.items()
                  if slot.request.deadline is not None
                  and now > slot.request.deadline]
        for sid in doomed:
            slot = self._slots.pop(sid)
            self._free.append(sid)
            self.cancelled += 1
            slot.request.set_error(OverloadError(
                'deadline expired mid-generation after %d tokens'
                % len(slot.generated), reason='deadline'))
        return len(doomed)

    def _admit(self, queue):
        """Refill free slots from the queue: one PREFILL per request,
        bucketed by prompt length."""
        for req in queue.pop(len(self._free)):
            sid = self._free.pop(0)
            prompt = req.prompt
            bucket = bucket_of(prompt.size, self.prefill_edges)
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :prompt.size] = prompt
            self.guard_signature((tokens, np.int32(prompt.size),
                                  np.int32(sid)))
            tok = self._run_prefill(tokens, prompt.size, sid)
            self._prefill_run.add(bucket)
            self.prefills += 1
            self.tokens_generated += 1
            req.notify_tokens([tok])
            if self.eos_id is not None and tok == self.eos_id \
                    or req.max_new_tokens == 1:
                req.set_result([tok])
                self._free.append(sid)
                continue
            self._slots[sid] = _Slot(req, prompt.size,
                                     req.max_new_tokens - 1, tok)

    def _decode_once(self):
        """One decode step over every active slot, compacted to the
        smallest slot-count bucket; finished sequences resolve and free
        their slots (refilled at the NEXT step)."""
        active = sorted(self._slots)
        k = len(active)
        bucket = bucket_of(k, self.decode_edges)
        if bucket == self.n_slots:
            # the full bucket reads the cache in place: row i IS slot i,
            # so rows are every slot in id order even when k < n_slots --
            # an inactive row writes a garbage token at position 0 of its
            # FREE slot, overwritten by that slot's next prefill
            rows = list(range(self.n_slots))
        else:
            # compacted bucket: pad with FREE slots (there are enough:
            # bucket < n_slots and only k are active), same contract
            rows = active + self._free[:bucket - k]
        tokens = np.asarray(
            [self._slots[s].generated[-1] if s in self._slots else 0
             for s in rows], np.int32)
        positions = np.asarray(
            [self._slots[s].position if s in self._slots else 0
             for s in rows], np.int32)
        slots = None if bucket == self.n_slots else np.asarray(rows,
                                                              np.int32)
        self.guard_signature((tokens, positions) if slots is None
                             else (tokens, slots, positions))
        toks = self._run_decode(tokens, positions, slots)
        self._decode_run.add(bucket)
        for i, sid in enumerate(rows):
            slot = self._slots.get(sid)
            if slot is None:
                continue   # free pad row (or inactive full-bucket row)
            tok = int(toks[i])
            slot.generated.append(tok)
            slot.request.notify_tokens([tok])
            slot.position += 1
            slot.remaining -= 1
            if slot.remaining == 0 or (self.eos_id is not None
                                       and tok == self.eos_id):
                slot.request.set_result(slot.generated)
                del self._slots[sid]
                self._free.append(sid)
        self.decode_steps += 1
        self.tokens_generated += k

    def step(self, queue, clock=time.monotonic):
        """One scheduler tick: expire -> admit (slot refill) -> one
        decode step.  Returns True when a decode step ran."""
        self._expire(clock())
        self._admit(queue)
        if not self._slots:
            return False
        self._decode_once()
        return True

    def stats(self):
        return {
            'prefill_buckets': sorted(self._prefill_run),
            'decode_buckets': sorted(self._decode_run),
            'prefill_edges': list(self.prefill_edges),
            'decode_edges': list(self.decode_edges),
            'n_slots': self.n_slots,
            'int8_kv': self.int8_kv,
            'prefills': self.prefills,
            'decode_steps': self.decode_steps,
            'tokens_generated': self.tokens_generated,
            'cancelled': self.cancelled,
            'active_slots': len(self._slots),
        }
