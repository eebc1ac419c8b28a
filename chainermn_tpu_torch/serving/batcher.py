"""Dynamic request batching: coalesce variable-size requests into padded,
power-of-two-bucketed batches.

Counterpart of ``chainermn_tpu/serving/batcher.py``.  The engine holds one
CUDA graph per batch shape, so admission maps every traffic pattern onto
a small fixed set of shapes:

- **Buckets.**  :func:`bucket_edges` gives power-of-two edges up to
  ``max_batch``; :func:`bucket_of` maps an item count to the smallest
  edge that fits.  A request larger than the largest edge is a client
  error (``ValueError`` at submit, before it takes queue space).
- **Deterministic packing.**  :func:`pack_sizes` packs a drained snapshot
  first-fit-decreasing over a canonical order (size descending, arrival
  among equals), so the grouping depends only on the multiset of sizes:
  the same mix in any arrival order gives the same groups, buckets and
  padded shapes.
- **Bounded admission.**  ``max_queue`` requests; a submit past it is
  answered at once with the typed
  :class:`~chainermn_tpu_torch.utils.failure.OverloadError`.  A request
  whose deadline passed while it waited is shed with the same error when
  the queue drains, not executed late.
- **Admission knobs.**  A drain triggers when ``max_batch`` items wait
  or the oldest request has waited ``max_wait``.

Collation reuses :func:`~chainermn_tpu_torch.training.convert.
concat_examples` (padding, an f32 validity mask, floating columns cast to
the policy's compute dtype on the host before the copy to the card).
The chaos site ``serve_burst`` is ROADMAP.md A9 and is left out.
"""

import itertools
import threading
import time

import numpy as np

from chainermn_tpu_torch import telemetry as _telemetry
from chainermn_tpu_torch.training.convert import concat_examples
from chainermn_tpu_torch.utils.failure import OverloadError

#: default admission knobs
DEFAULT_MAX_BATCH = 32
DEFAULT_MAX_WAIT = 0.005
DEFAULT_MAX_QUEUE = 256

#: process-wide request-id source shared by every serving queue (batch
#: and generation): the numeric part is the monotonic admission stamp
_request_counter = itertools.count(1)


def next_request_id():
    """Process-unique request id (``r<N>``); the counter is shared by the
    batch and generation queues, so ids order by admission."""
    return 'r%d' % next(_request_counter)


def admission_order(request_id):
    """Sort key recovering the admission stamp of a
    :func:`next_request_id` id (``'r7'`` -> ``(0, 7)``); other ids sort
    after every native one, lexicographically."""
    try:
        return (0, int(str(request_id).lstrip('r')))
    except (TypeError, ValueError):
        return (1, str(request_id))


def record_shed(reason, request_id=None, queue_depth=None,
                count_total=True, **attrs):
    """Shed forensics, one call per turned-away request: bump
    ``serve_shed_total`` (``count_total=False`` for shutdown drains) and
    ``serve_shed_<reason>_total``, and record a ``kind='request'``
    ``shed`` event with the id, the reason and the queue depth.  No-op
    when telemetry is off."""
    reg = _telemetry.registry()
    if reg is not None:
        if count_total:
            reg.counter('serve_shed_total',
                        help='requests shed by the admission layer '
                             '(queue_full + deadline)').inc()
        reg.counter('serve_shed_%s_total' % reason,
                    help='requests shed with reason=%s' % reason).inc()
    _telemetry.request_event(request_id, 'shed', reason=reason,
                             queue_depth=queue_depth, **attrs)


def bucket_edges(max_batch, base=2):
    """Ascending bucket edges ``base**k`` up to and including
    ``max_batch`` (the top edge is always exactly ``max_batch``)."""
    if max_batch < 1:
        raise ValueError('max_batch must be >= 1, got %r' % max_batch)
    if base < 2:
        raise ValueError('bucket base must be >= 2, got %r' % base)
    edges, e = [], 1
    while e < max_batch:
        edges.append(e)
        e *= base
    edges.append(max_batch)
    return tuple(edges)


def bucket_of(n, edges):
    """The smallest edge >= ``n``.  ``n`` over the largest edge is a
    typed client error (the request can never be served whole)."""
    if n < 1:
        raise ValueError('request size must be >= 1, got %d' % n)
    for e in edges:
        if n <= e:
            return e
    raise ValueError(
        'request of %d items exceeds the largest bucket %d; split it '
        'client-side or raise max_batch' % (n, edges[-1]))


def pack_sizes(sizes, max_batch, edges):
    """Deterministic first-fit-decreasing packing of request sizes into
    groups of at most ``max_batch`` items (requests never split).

    Returns ``[(bucket, [positions])]``.  The canonical order (size
    descending, position ascending among equal sizes) makes the grouping
    a function of the size multiset alone."""
    order = sorted(range(len(sizes)), key=lambda i: (-sizes[i], i))
    groups = []  # [remaining, [positions]]
    for i in order:
        n = sizes[i]
        if n > max_batch:
            raise ValueError('request of %d items exceeds max_batch %d'
                             % (n, max_batch))
        for g in groups:
            if g[0] >= n:
                g[0] -= n
                g[1].append(i)
                break
        else:
            groups.append([max_batch - n, [i]])
    return [(bucket_of(max_batch - rem, edges), members)
            for rem, members in groups]


class Request:
    """One in-flight request: payload ``x`` (leading dim = item count),
    optional absolute ``deadline`` (``clock()`` units), and a one-shot
    completion cell the engine fills with the result rows or a typed
    error.  ``t_trace0`` is the admission instant on the telemetry
    recorder's clock (None when telemetry was off), the start of the
    request's ``queue_wait`` stage."""

    __slots__ = ('x', 'n', 'deadline', 'seq', 't_submit', 'request_id',
                 't_trace0', '_done', '_result', '_error')

    def __init__(self, x, deadline=None, seq=0, t_submit=0.0,
                 request_id=None):
        self.x = x
        self.n = int(x.shape[0])
        self.deadline = deadline
        self.seq = seq
        self.t_submit = t_submit
        self.request_id = request_id or next_request_id()
        rec = _telemetry.active()
        self.t_trace0 = rec.now() if rec is not None else None
        self._done = threading.Event()
        self._result = None
        self._error = None

    def set_result(self, value):
        self._result = value
        self._done.set()

    def set_error(self, exc):
        self._error = exc
        self._done.set()

    def done(self):
        return self._done.is_set()

    def result(self, timeout=None):
        """Block for the response; re-raises the typed shed error."""
        if not self._done.wait(timeout):
            raise TimeoutError('request %d not completed within %rs'
                               % (self.seq, timeout))
        if self._error is not None:
            raise self._error
        return self._result


class PackedBatch:
    """One drained group ready to run: the member requests (in canonical
    pack order), their total item count, and the bucket the padded batch
    fills."""

    __slots__ = ('requests', 'bucket', 'total', 't_drain')

    def __init__(self, requests, bucket, t_drain):
        self.requests = list(requests)
        self.bucket = int(bucket)
        self.total = sum(r.n for r in self.requests)
        self.t_drain = t_drain

    def collate(self, dtype=None):
        """``(x_padded, mask)``: the member payloads stacked row-wise and
        padded to the bucket, floating data cast on the host to ``dtype``
        (a numpy dtype, or a ``torch.dtype``, which gives CPU tensors);
        ``mask`` is the f32 validity row mask (padding rows 0)."""
        rows = [row for req in self.requests for row in req.x]
        x, mask = concat_examples(rows, padding=(self.bucket, 0.0),
                                  dtype=dtype)
        return x, mask

    def pad_waste(self):
        """Fraction of the padded batch that is padding."""
        return (self.bucket - self.total) / float(self.bucket)


class RequestQueue:
    """Bounded, deadline-aware coalescing queue.

    ``submit`` is the client edge (any thread); ``take`` is the engine
    edge: it blocks until an admission trigger, drains the whole waiting
    snapshot and returns it packed into :class:`PackedBatch` groups.
    """

    def __init__(self, max_batch=DEFAULT_MAX_BATCH,
                 max_wait=DEFAULT_MAX_WAIT, max_queue=DEFAULT_MAX_QUEUE,
                 edges=None, clock=time.monotonic, label=None):
        #: replica name; when set, shed records carry it
        self.label = label
        if max_queue < max_batch:
            raise ValueError('max_queue %d < max_batch %d: the queue '
                             'could never fill one full batch'
                             % (max_queue, max_batch))
        self.max_batch = int(max_batch)
        self.max_wait = float(max_wait)
        self.max_queue = int(max_queue)
        self.edges = tuple(edges) if edges else bucket_edges(max_batch)
        if self.edges[-1] != self.max_batch:
            raise ValueError('largest bucket edge %d must equal max_batch '
                             '%d' % (self.edges[-1], self.max_batch))
        self._clock = clock
        self._cond = threading.Condition()
        self._waiting = []
        self._seq = 0
        self._closed = False
        self.submitted = 0
        self.shed_queue_full = 0
        self.shed_deadline = 0

    # -- client edge ---------------------------------------------------
    def submit(self, x, deadline=None, timeout=None, request_id=None):
        """Enqueue one request (payload leading dim = item count >= 1)
        and return its :class:`Request`.  A full queue sheds typed
        (``reason='queue_full'``), a closed one too
        (``reason='shutdown'``); an over-bucket payload raises
        ``ValueError`` before touching queue state.  ``timeout`` is
        accepted for the JAX package's signature and unused there too."""
        del timeout
        x = np.asarray(x)
        if x.ndim < 1:
            x = x[None]
        bucket_of(x.shape[0], self.edges)  # typed oversize reject
        with self._cond:
            req = self._admit(x, deadline, request_id=request_id)
            self._cond.notify_all()
        return req

    def _admit(self, x, deadline, request_id=None):
        if self._closed:
            raise OverloadError('serving queue is shut down',
                                reason='shutdown',
                                queue_depth=len(self._waiting))
        if len(self._waiting) >= self.max_queue:
            self.shed_queue_full += 1
            record_shed('queue_full',
                        request_id=request_id or next_request_id(),
                        queue_depth=len(self._waiting),
                        **self._shed_attrs())
            raise OverloadError(
                'serving queue full (%d waiting requests); retry with '
                'backoff' % len(self._waiting),
                reason='queue_full', queue_depth=len(self._waiting))
        self._seq += 1
        self.submitted += 1
        req = Request(x, deadline=deadline, seq=self._seq,
                      t_submit=self._clock(), request_id=request_id)
        self._waiting.append(req)
        return req

    def _shed_attrs(self):
        return {'replica': self.label} if self.label else {}

    # -- engine edge ---------------------------------------------------
    def depth(self):
        with self._cond:
            return len(self._waiting)

    def _ready_locked(self, now):
        if not self._waiting:
            return False
        if sum(r.n for r in self._waiting) >= self.max_batch:
            return True
        return (now - self._waiting[0].t_submit) >= self.max_wait

    def take(self, timeout=None):
        """Block until an admission trigger (or ``timeout``), then drain
        the whole waiting snapshot into packed batches; requests whose
        deadline expired are shed typed here.  Returns ``[]`` on timeout
        or when closed and drained."""
        deadline = None if timeout is None else self._clock() + timeout
        with self._cond:
            while not self._ready_locked(self._clock()):
                if self._closed:
                    break
                wait = None
                if self._waiting:
                    wait = self.max_wait - (
                        self._clock() - self._waiting[0].t_submit)
                if deadline is not None:
                    remaining = deadline - self._clock()
                    if remaining <= 0:
                        return []
                    wait = remaining if wait is None else min(wait,
                                                              remaining)
                self._cond.wait(wait if wait is None else max(wait, 1e-4))
            snapshot, self._waiting = self._waiting, []
        now = self._clock()
        live = []
        for req in snapshot:
            if req.deadline is not None and now > req.deadline:
                self.shed_deadline += 1
                record_shed('deadline', request_id=req.request_id,
                            queue_depth=len(snapshot),
                            waited_ms=round((now - req.t_submit) * 1e3, 3),
                            **self._shed_attrs())
                req.set_error(OverloadError(
                    'deadline expired after %.1f ms in queue'
                    % ((now - req.t_submit) * 1e3), reason='deadline'))
                continue
            live.append(req)
        if not live:
            return []
        packed = pack_sizes([r.n for r in live], self.max_batch,
                            self.edges)
        return [PackedBatch([live[i] for i in members], bucket, now)
                for bucket, members in packed]

    def close(self):
        """Refuse new work and shed everything still waiting
        (``reason='shutdown'``; counted per reason, not in
        ``serve_shed_total``)."""
        with self._cond:
            self._closed = True
            pending, self._waiting = self._waiting, []
            self._cond.notify_all()
        for req in pending:
            record_shed('shutdown', request_id=req.request_id,
                        queue_depth=len(pending), count_total=False,
                        **self._shed_attrs())
            req.set_error(OverloadError('serving queue shut down',
                                        reason='shutdown'))

    def stats(self):
        return {'submitted': self.submitted,
                'shed_queue_full': self.shed_queue_full,
                'shed_deadline': self.shed_deadline,
                'depth': self.depth(),
                'edges': list(self.edges)}
