"""Dataset partitioning.

Counterpart of ``chainermn_tpu/dataset.py``: scattering is index
arithmetic over a dataset every process can open.  Each process drives
one device, so the default ``size`` / ``rank`` are the communicator's.
"""

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
        import torch.distributed as dist
        if comm is not None:
            world, me = comm.size, comm.rank
        elif dist.is_initialized():
            world, me = dist.get_world_size(), dist.get_rank()
        else:
            world, me = 1, 0
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
