"""Batch collation (the role of ``chainer.dataset.convert.concat_examples``
in the reference examples, e.g. ``train_mnist.py:99``).  Copy of
``chainermn_tpu/training/convert.py``: numpy host code; the updater moves
the collated arrays to the device."""

import numpy as np


def _cast_cols(cols, dtype):
    """Cast floating columns to ``dtype`` on the HOST (integer labels
    untouched): a batch shipped at the step's compute dtype halves the
    host->device bytes a downstream downcast would otherwise waste."""
    if dtype is None:
        return cols
    dt = np.dtype(dtype)

    def cast(a):
        if np.issubdtype(a.dtype, np.floating) and a.dtype != dt:
            return a.astype(dt)
        return a

    if isinstance(cols, dict):
        return {k: cast(v) for k, v in cols.items()}
    return tuple(cast(c) for c in cols)


def concat_examples(batch, padding=None, dtype=None):
    """Stack a list of examples into batched arrays.

    Examples may be tuples (``(x, y)`` -> ``(X, Y)``), dicts, or bare
    arrays.  With ``padding=(pad_to, fill)`` the leading dimension is
    padded to ``pad_to`` (for fixed-shape steps on final partial
    batches) and a float32 validity ``mask`` of shape ``(pad_to,)`` is
    appended to the result tuple.  ``dtype`` casts floating columns to
    a target dtype host-side (a mixed-precision policy's compute
    dtype; the validity mask stays float32 -- metric averages are kept
    in f32).
    """
    if len(batch) == 0:
        raise ValueError('batch is empty')
    first = batch[0]
    if (isinstance(batch, tuple)
            and all(isinstance(b, np.ndarray) and b.ndim >= 1
                    for b in batch)):
        # already-collated column arrays (batch-level pipelines like
        # datasets.BatchAugmentPipeline produce these directly)
        if padding is not None:
            raise ValueError('padding is only supported for lists of '
                             'examples, not pre-collated arrays')
        return _cast_cols(batch, dtype)
    if isinstance(first, tuple):
        cols = tuple(
            np.stack([np.asarray(b[i])
                      for b in batch])
            for i in range(len(first)))
    elif isinstance(first, dict):
        cols = {
            k: np.stack([np.asarray(b[k])
                         for b in batch])
            for k in first}
    else:
        cols = (
            np.stack([np.asarray(b)
                      for b in batch]),)
    cols = _cast_cols(cols, dtype)
    if padding is None:
        return cols
    pad_to, fill = padding
    n = len(batch)
    if pad_to < n:
        raise ValueError('pad_to %d < batch size %d' % (pad_to, n))

    def pad(a):
        if pad_to == n:
            return a
        widths = [(0, pad_to - n)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=fill)

    mask = np.zeros((pad_to,), np.float32)
    mask[:n] = 1.0
    if isinstance(cols, dict):
        cols = {k: pad(v) for k, v in cols.items()}
        cols['mask'] = mask
        return cols
    return tuple(pad(c) for c in cols) + (mask,)
