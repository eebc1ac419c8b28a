"""Bucket geometry and request ids shared by the serving queues.

Counterpart of the subset of ``chainermn_tpu/serving/batcher.py`` the
generation engine uses: power-of-two :func:`bucket_edges`,
:func:`bucket_of` and the process-wide :func:`next_request_id`.  The
batch ``RequestQueue``, its packing and the shed telemetry are not
ported yet (ROADMAP.md A8, A9).
"""

import itertools

#: process-wide request-id source: the numeric part is the monotonic
#: admission stamp
_request_counter = itertools.count(1)


def next_request_id():
    """Process-unique request id (``r<N>``)."""
    return 'r%d' % next(_request_counter)


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
