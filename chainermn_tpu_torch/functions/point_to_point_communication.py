"""Differentiable point-to-point communication.

Counterpart of ``chainermn_tpu/functions/point_to_point_communication.py``,
with the JAX semantics of one ``lax.ppermute``: every rank calls
:func:`send` (or :func:`recv`) with its own operand; under the
permutation ``perm`` (disjoint ``(src, dst)`` pairs) a destination gets
its source's value and every other rank gets zeros of its operand's
shape.  The backward is the reverse permutation of the gradients
(``Send.backward = recv`` in the reference): a source gets its
destination's gradient.

The transfers are ``torch.distributed.batch_isend_irecv`` on the default
group; a pair whose two ends are this rank is a local copy, and a rank
in no pair communicates nothing.  Ranks are global under the default
``axis``; ``axis='inter'`` or ``'intra'`` numbers them within the
communicator's sub-groups (the columns or rows of its ``(inter, intra)``
mesh of processes), and the permutation then runs in every column or
row at once, as ``ppermute`` over one mesh axis does.
"""

import torch
import torch.distributed as dist

#: the communicator's two mesh axes, node-major (``mesh_utility.AXES``
#: of the JAX package)
AXES = ('inter', 'intra')


def _this_rank(comm):
    if comm is not None:
        return comm.rank
    return dist.get_rank() if dist.is_initialized() else 0


def _world(comm):
    if comm is not None:
        return comm.size
    return dist.get_world_size() if dist.is_initialized() else 1


def global_pairs(perm, comm=None, axis=AXES):
    """``perm`` as pairs of global ranks.  ``axis``: both axes (global
    ranks as given), or one of them (``perm`` repeated over every row
    for ``'intra'``, every column for ``'inter'``).  Raises
    ``ValueError`` on a rank out of range or pairs that are not
    disjoint."""
    axis = (axis,) if isinstance(axis, str) else tuple(axis)
    perm = [(int(s), int(d)) for s, d in perm]
    if axis == AXES:
        pairs, n = perm, _world(comm)
        extent = n
    elif axis in (('intra',), ('inter',)):
        if comm is None:
            raise ValueError('axis %r needs a communicator' % (axis,))
        inter, intra = comm.inter_size, comm.intra_size
        n = inter * intra
        if axis == ('intra',):
            extent = intra
            pairs = [(i * intra + s, i * intra + d)
                     for i in range(inter) for s, d in perm]
        else:
            extent = inter
            pairs = [(s * intra + j, d * intra + j)
                     for j in range(intra) for s, d in perm]
    else:
        raise ValueError('axis must be %r, %r or %r, got %r'
                         % (AXES, 'inter', 'intra', axis))
    for s, d in perm:
        if not (0 <= s < extent and 0 <= d < extent):
            raise ValueError('pair (%d, %d) out of range for %d ranks on '
                             'axis %r' % (s, d, extent, axis))
    srcs, dsts = [s for s, _ in pairs], [d for _, d in pairs]
    if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
        raise ValueError('perm %r is not a set of disjoint pairs' % (perm,))
    return pairs


def exchange(x, pairs, rank):
    """What ``rank`` receives under ``pairs`` (global ranks): the
    source's ``x`` on a destination, zeros of ``x``'s shape elsewhere.
    Blocks until this rank's transfers are done; no autograd."""
    out = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
    ops = []
    for s, d in pairs:
        if s == d == rank:
            out.copy_(x)
        elif s == rank:
            ops.append(dist.P2POp(dist.isend, x.contiguous(), d))
        elif d == rank:
            ops.append(dist.P2POp(dist.irecv, out, s))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _Permute(torch.autograd.Function):

    #: read by ``parallel.pipeline``'s 1F1B guard (``axis`` None: the
    #: pairs name global ranks, no mesh axis)
    cmn_collective = 'ppermute'

    @staticmethod
    def forward(ctx, x, pairs, rank):
        ctx.pairs, ctx.rank, ctx.axis = pairs, rank, None
        return exchange(x, pairs, rank)

    @staticmethod
    def backward(ctx, g):
        back = [(d, s) for s, d in ctx.pairs]
        return exchange(g, back, ctx.rank), None, None


def _permute(x, comm, perm, axis):
    pairs = global_pairs(perm, comm, axis)
    return _Permute.apply(x, pairs, _this_rank(comm))


def send(x, comm=None, rank=None, src=None, axis=AXES, perm=None):
    """Ship ``x`` from rank ``src`` to rank ``rank``; differentiable.

    Every rank calls it with its own ``x`` (only the source's is read)
    and gets what it received: the source's value on the destination,
    zeros of ``x``'s shape elsewhere.  Give ``(src, rank)`` or a whole
    ``perm`` of disjoint pairs.  The gradient of ``x`` on the source is
    the destination's gradient of the result (zeros on every other
    rank)."""
    if perm is None:
        if rank is None or src is None:
            raise ValueError('provide (src, rank) or an explicit perm')
        perm = [(src, rank)]
    return _permute(x, comm, perm, axis)


def recv(comm=None, rank=None, dst=None, axis=AXES, x=None, perm=None):
    """Receive on rank ``dst`` from rank ``rank``; the mirror of
    :func:`send`.  ``x`` is each rank's operand (the template:
    ``zeros_like`` of the value on the ranks that do not send); ranks
    that are not ``dst`` get zeros."""
    if x is None:
        raise ValueError('recv needs a template operand x (zeros_like of '
                         'the transported value)')
    if perm is None:
        if rank is None or dst is None:
            raise ValueError('provide (rank, dst) or an explicit perm')
        perm = [(rank, dst)]
    return _permute(x, comm, perm, axis)
