"""The (inter, intra) topology of the processes and its sub-groups.

Counterpart of ``chainermn_tpu/communicators/mesh_utility.py``.  The JAX
package lays its devices out as a 2-D mesh with axes ``('inter',
'intra')``; here each process drives one device, so the mesh is one of
processes:

- ``intra``: the processes of one node (the reference's intra-node NCCL
  group), ``LOCAL_WORLD_SIZE`` of them under ``torchrun``;
- ``inter``: across nodes (the reference's inter-node MPI group).

Ranks are node-major, as the JAX package's ``axis_rank``:
``inter_rank = rank // intra_size``, ``intra_rank = rank % intra_size``.
"""

import os

import torch.distributed as dist


def detect_topology(size):
    """``(inter_size, intra_size)`` of ``size`` processes from torchrun's
    ``LOCAL_WORLD_SIZE`` (processes per node).  Without it every process
    counts as one node's, and a layout that does not tile (nodes of
    unequal size) collapses to ``(1, size)``, as the JAX package's
    ``detect_topology`` does."""
    local = int(os.environ.get('LOCAL_WORLD_SIZE', size))
    if local < 1 or size % local:
        return (1, size)
    return (size // local, local)


def resolve_mesh_shape(size, mesh_shape=None):
    """The ``(inter, intra)`` shape over ``size`` processes: ``mesh_shape``
    as given (one side may be -1: the other divides it out), else
    :func:`detect_topology`.  Raises ``ValueError`` when the shape does
    not cover the world."""
    if mesh_shape is None:
        return detect_topology(size)
    inter, intra = (int(v) for v in mesh_shape)
    if inter == -1 and intra > 0:
        inter = size // intra
    if intra == -1 and inter > 0:
        intra = size // inter
    if inter < 1 or intra < 1 or inter * intra != size:
        raise ValueError('mesh_shape %r does not cover %d processes'
                         % (tuple(mesh_shape), size))
    return (inter, intra)


def group_ranks(inter, intra):
    """``(intra groups, inter groups)`` as lists of ranks: one intra
    group per node (a row of the mesh), one inter group per local rank
    (a column)."""
    rows = [[i * intra + j for j in range(intra)] for i in range(inter)]
    cols = [[i * intra + j for i in range(inter)] for j in range(intra)]
    return rows, cols


def new_groups(rank_sets, rank, backend=None):
    """Make one group per list of ranks in ``rank_sets``, in order, and
    return the one holding ``rank`` (``backend``: the default group's
    unless given).  Making a group is a collective over the whole world:
    every rank makes every group, in the same order."""
    mine = None
    for ranks in rank_sets:
        group = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            mine = group
    return mine


def build_groups(inter, intra, rank):
    """This rank's ``(intra group, inter group)``: all the intra groups
    are made first, then all the inter groups."""
    rows, cols = group_ranks(inter, intra)
    return new_groups(rows, rank), new_groups(cols, rank)


def divisor_leq(n, k):
    """The largest divisor of ``n`` that is ``<= k`` (>= 1): the
    degradation rule of :class:`chainermn_tpu_torch.parallel.MeshPlan`
    (the JAX package's ``divisor_leq``).  A requested axis width that
    does not divide the process count clamps down to one that does:
    ``divisor_leq(1, k) == 1``, ``divisor_leq(n, n) == n``,
    ``divisor_leq(7, 2) == 1``."""
    if n < 1:
        raise ValueError('need at least one device, got %d' % n)
    k = max(1, min(int(k), n))
    while n % k:
        k -= 1
    return k


def divisors_leq(n, ks):
    """:func:`divisor_leq` for several requested axis widths, in the
    given priority order: each clamps to the largest divisor of the
    processes still unclaimed, so the product of the widths divides
    ``n`` and the leading (data) axis takes the rest (the JAX package's
    ``divisors_leq``).  ``divisors_leq(1, (4, 4)) == (1, 1)``,
    ``divisors_leq(6, (2, 2)) == (2, 1)`` (3 processes left, no even
    divisor)."""
    if n < 1:
        raise ValueError('need at least one device, got %d' % n)
    remaining, out = n, []
    for k in ks:
        eff = divisor_leq(remaining, k)
        out.append(eff)
        remaining //= eff
    return tuple(out)
