"""Dataset iterators.

Counterpart of ``chainermn_tpu/training/iterators.py`` (``SerialIterator``
only; the prefetching iterators come in a later slice).  Host-side data
handling stays in numpy; device placement is the updater's job.
"""

import numpy as np


class SerialIterator:
    """Single-thread batch iterator with epoch accounting."""

    def __init__(self, dataset, batch_size, repeat=True, shuffle=True,
                 seed=0):
        self.dataset = dataset
        self.batch_size = batch_size
        self._repeat = repeat
        self._shuffle = shuffle
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self.reset()

    def reset(self):
        self.epoch = 0
        self.iteration = 0
        self.is_new_epoch = False
        self._pos = 0
        self._order = self._new_order()

    def _new_order(self):
        n = len(self.dataset)
        return (self._rng.permutation(n) if self._shuffle
                else np.arange(n))

    @property
    def epoch_detail(self):
        """Epochs done, with the fraction of the current one."""
        return self.epoch + self._pos / max(1, len(self.dataset))

    def restore_position(self, epoch_detail):
        """Land where an uninterrupted run stood at ``epoch_detail``:
        its epoch, its position in the epoch and, when shuffling, its
        permutation (a repeating iterator draws one order at the start
        and one at each epoch's end, so the seed's ``epoch + 1``-th
        draw is the order of the current epoch).  The JAX package's
        elastic ``restore_position`` keeps the position but draws a
        fresh order; this one resumes the same sequence of batches."""
        n = len(self.dataset)
        epoch = int(epoch_detail)
        self.epoch = epoch
        self._pos = int(round((float(epoch_detail) - epoch) * n))
        self.is_new_epoch = False
        self._rng = np.random.RandomState(self._seed)
        for _ in range(epoch + 1):
            self._order = self._new_order()

    def __iter__(self):
        return self

    def __next__(self):
        n = len(self.dataset)
        if n == 0:
            raise StopIteration
        if self._pos >= n:
            if not self._repeat:
                raise StopIteration
            self._pos = 0
            self._order = self._new_order()
        i, i_end = self._pos, min(self._pos + self.batch_size, n)
        batch = [self.dataset[int(self._order[k])] for k in range(i, i_end)]
        self._pos = i_end
        self.is_new_epoch = False
        if self._pos >= n:
            self.epoch += 1
            self.is_new_epoch = True
            if self._repeat:
                self._pos = 0
                self._order = self._new_order()
        # top up to a constant batch size when repeating
        while self._repeat and len(batch) < self.batch_size:
            batch.append(self.dataset[int(self._order[self._pos])])
            self._pos += 1
        self.iteration += 1
        return batch
