"""Dataset partitioning.

Counterpart of ``chainermn_tpu/dataset.py``: scattering is index
arithmetic over a dataset every process can open.  Each process drives
one device, so the default ``size`` / ``rank`` are the communicator's.
:func:`epoch_position` is the elastic-resume rule the iterators'
``restore_position`` share; :func:`get_n_iterations_for_one_epoch` and
:func:`get_epoch_trigger` are the reference's deprecated epoch helpers.
"""

import math

import numpy as np


class SubDataset:
    """A contiguous view ``dataset[start:finish]``."""

    def __init__(self, dataset, start, finish):
        if not 0 <= start <= finish <= len(dataset):
            raise ValueError('invalid sub-dataset range [%d, %d)'
                             % (start, finish))
        self._dataset = dataset
        self._start = start
        self._finish = finish

    def __len__(self):
        return self._finish - self._start

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        if i < -len(self) or i >= len(self):
            raise IndexError(i)
        return self._dataset[self._start + (i % len(self))]


def scatter_index(n_total, size, rank):
    """(start, finish) of ``rank``'s shard: balanced quotient partition,
    shard lengths differ by at most 1."""
    return (n_total * rank) // size, (n_total * (rank + 1)) // size


def scatter_dataset(dataset, comm=None, size=None, rank=None, shuffle=False,
                    seed=0):
    """Return this process's shard of ``dataset``.

    ``size`` / ``rank`` default to the communicator's (or, without one,
    to the initialized ``torch.distributed`` group, else a world of
    one).  ``shuffle`` applies a seeded global permutation first.
    """
    if size is None or rank is None:
        world, me = ((comm.size, comm.rank) if comm is not None
                     else _world())
        size = world if size is None else size
        rank = me if rank is None else rank
    if not 0 <= rank < size:
        raise ValueError('rank %d out of range for size %d' % (rank, size))
    if shuffle:
        order = np.random.RandomState(seed).permutation(len(dataset))
        dataset = _Permuted(dataset, order)
    start, finish = scatter_index(len(dataset), size, rank)
    return SubDataset(dataset, start, finish)


class _Permuted:
    def __init__(self, dataset, order):
        self._dataset = dataset
        self._order = order

    def __len__(self):
        return len(self._dataset)

    def __getitem__(self, i):
        return self._dataset[int(self._order[i])]


def _world():
    """``(size, rank)`` of the initialized ``torch.distributed`` group,
    else a world of one."""
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def epoch_position(epoch_detail, shard_len):
    """``(epoch, in-shard position)`` of a fractional epoch on a shard of
    ``shard_len`` items.

    The elastic-resume rule: a checkpoint records the GLOBAL fraction of
    the epoch consumed (``epoch_detail``); on restore, possibly at
    another process count (where :func:`scatter_dataset` hands each
    process a shard of another length), that fraction is re-expressed in
    the new shard length, so every process lands at the same global
    progress point and the epoch boundary fires where it would have."""
    if shard_len < 0:
        raise ValueError('shard_len must be >= 0')
    epoch = int(epoch_detail)
    frac = float(epoch_detail) - epoch
    pos = min(shard_len, int(round(frac * shard_len)))
    return epoch, pos


def get_n_iterations_for_one_epoch(dataset, local_batch_size, comm=None,
                                   size=None):
    """Iterations per epoch under even sharding (deprecated in the
    reference, ``dataset.py:46-74``; kept for its API).

    ``size`` defaults to ``comm.size`` or, with no communicator, the
    process count of the initialized ``torch.distributed`` group (one
    without it)."""
    if size is None:
        size = comm.size if comm is not None else _world()[0]
    n_sub = int(math.ceil(len(dataset) / size))
    return int(math.ceil(n_sub / local_batch_size))


def get_epoch_trigger(n_epochs, dataset, local_batch_size, comm=None,
                      size=None):
    """``(n_iterations, 'iteration')`` trigger of ``n_epochs`` epochs
    (reference ``dataset.py:77-100``)."""
    n_iter = get_n_iterations_for_one_epoch(
        dataset, local_batch_size, comm, size)
    return (n_epochs * n_iter, 'iteration')
