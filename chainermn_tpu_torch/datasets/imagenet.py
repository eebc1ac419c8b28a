"""ImageNet-style dataset pipeline (host code).

Counterpart of ``chainermn_tpu/datasets/imagenet.py``:
``PreprocessedDataset`` (mean subtraction, random crop + flip for
training, center crop for eval, pixel scaling, per item), the
deterministic ``SyntheticImageNet`` stand-in, ``get_imagenet`` (real data
from ``CHAINERMN_TPU_IMAGENET`` when it points at prepared npy lists,
synthetic otherwise), ``compute_mean``, and ``BatchAugmentPipeline``,
the same augmentation a whole batch at a time on the native C++ thread
pool (:func:`chainermn_tpu_torch.native.augment_batch`), with
:func:`_augment_ref` its plain numpy version.
"""

import os

import numpy as np


class PreprocessedDataset:
    """(image HWC float32, label) tuples with reference-style
    augmentation."""

    def __init__(self, base, mean, crop_size, random=True):
        self.base = base
        self.mean = mean.astype(np.float32) if mean is not None else None
        self.crop_size = crop_size
        self.random = random
        self._rng = np.random.RandomState(0x5EED)

    def __len__(self):
        return len(self.base)

    def __getitem__(self, i):
        image, label = self.base[i]
        image = np.asarray(image, np.float32)
        crop = self.crop_size
        h, w = image.shape[:2]
        if self.random:
            top = self._rng.randint(0, h - crop + 1)
            left = self._rng.randint(0, w - crop + 1)
            if self._rng.rand() > 0.5:
                image = image[:, ::-1, :]
        else:
            top = (h - crop) // 2
            left = (w - crop) // 2
        image = image[top:top + crop, left:left + crop, :]
        if self.mean is not None:
            # mean window tracks the crop window (reference
            # `train_imagenet.py:79-80`: mean[:, top:bottom, left:right])
            image = image - self.mean[top:top + crop,
                                      left:left + crop, :]
        image = image * (1.0 / 255.0)
        return image.astype(np.float32), np.int32(label)


class SyntheticImageNet:
    """Deterministic class-structured images, generated on demand (no
    6TB on disk): class-colored low-frequency pattern + noise."""

    def __init__(self, n=1280, size=256, n_classes=1000, seed=7):
        self.n = n
        self.size = size
        self.n_classes = n_classes
        self.seed = seed
        rng = np.random.RandomState(seed)
        self._palette = rng.rand(n_classes, 1, 1, 3).astype(np.float32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.RandomState(self.seed * 1000003 + i)
        label = i % self.n_classes
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        freq = 1 + (label % 7)
        pattern = np.sin(2 * np.pi * freq * yy)[..., None] * \
            np.cos(2 * np.pi * freq * xx)[..., None]
        img = 127.5 + 80.0 * pattern * self._palette[label] + \
            25.0 * rng.randn(s, s, 3).astype(np.float32)
        return np.clip(img, 0, 255).astype(np.float32), np.int32(label)


def load_labeled_pairs(root, listfile):
    """Reference-style (path, label) list file loader
    (``train_imagenet.py:141-151``); images must be prepared as .npy
    HWC uint8/float arrays."""
    pairs = []
    with open(listfile) as f:
        for line in f:
            path, label = line.split()
            pairs.append((os.path.join(root, path), int(label)))

    class _Loader:
        def __len__(self):
            return len(pairs)

        def __getitem__(self, i):
            path, label = pairs[i]
            return np.load(path), label

    return _Loader()


def get_imagenet(train_size=1280, val_size=128, size=256):
    """(train, val) raw datasets; real data when
    ``CHAINERMN_TPU_IMAGENET`` points at prepared npy lists, synthetic
    otherwise."""
    root = os.environ.get('CHAINERMN_TPU_IMAGENET')
    if root and os.path.isdir(root):
        train = load_labeled_pairs(root, os.path.join(root, 'train.txt'))
        val = load_labeled_pairs(root, os.path.join(root, 'val.txt'))
        return train, val
    return (SyntheticImageNet(train_size, size=size),
            SyntheticImageNet(val_size, size=size, seed=99))


def _augment_ref(store, indices, tops, lefts, flips, crop, mean=None,
                 scale=1.0 / 255.0):
    """The plain version of ``native.augment_batch`` over a store of any
    dtype: the JAX package's numpy loop (each window staged to float32,
    the mean window subtracted, scaled, then flipped).  The native
    kernel equals it bit for bit."""
    images = np.empty((len(indices), crop, crop, store.shape[3]),
                      np.float32)
    for i, idx in enumerate(indices):
        t, l = tops[i], lefts[i]
        win = store[idx][t:t + crop, l:l + crop].astype(np.float32)
        if mean is not None:
            win = win - mean[t:t + crop, l:l + crop]
        win = win * scale
        images[i] = win[:, ::-1] if flips[i] else win
    return images


class BatchAugmentPipeline:
    """Batch-level augmentation over a contiguous preloaded sample store
    on the native C++ thread pool (``csrc/chainermn_core.cpp``
    ``cmn_augment_batch``): the crop / flip / mean-subtract / scale of
    :class:`PreprocessedDataset`, one call a batch, in place of the
    reference's worker processes (``train_imagenet.py:174-182``).

    The store keeps an integer dataset in its own dtype (uint8 data
    stays four times smaller) and makes a floating one float32; a batch
    of a non-float32 store is staged to float32 first (its own samples
    only).  The windows and flips come from ``np.random.RandomState(seed)``
    in the JAX package's order (all tops, then all lefts, then all flip
    draws of a batch), so both packages give the same batches.  The whole
    store lives in host memory: for bigger corpora use the streaming
    loader (:mod:`chainermn_tpu_torch.data`).
    """

    def __init__(self, dataset, crop_size, mean=None, random=True,
                 scale=1.0 / 255.0, seed=0):
        first, _ = dataset[0]
        first = np.asarray(first)
        store_dtype = (first.dtype if first.dtype.kind in 'iu'
                       else np.float32)
        self._store = np.empty((len(dataset),) + first.shape,
                               store_dtype)
        self._labels = np.empty(len(dataset), np.int32)
        for i in range(len(dataset)):
            img, label = dataset[i]
            self._store[i] = img
            self._labels[i] = label
        self.crop_size = crop_size
        self.mean = (np.ascontiguousarray(mean, np.float32)
                     if mean is not None else None)
        self.random = random
        self.scale = scale
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self._store)

    def _draw(self, b):
        """``(tops, lefts, flips)`` of the next batch of ``b``."""
        h, w = self._store.shape[1:3]
        crop = self.crop_size
        if self.random:
            tops = self._rng.randint(0, h - crop + 1, b).astype(np.int32)
            lefts = self._rng.randint(0, w - crop + 1, b).astype(np.int32)
            flips = (self._rng.rand(b) > 0.5).astype(np.uint8)
        else:
            tops = np.full(b, (h - crop) // 2, np.int32)
            lefts = np.full(b, (w - crop) // 2, np.int32)
            flips = np.zeros(b, np.uint8)
        return tops, lefts, flips

    def batch(self, indices):
        """``(images (B, crop, crop, C) float32, labels (B,) int32)``."""
        from chainermn_tpu_torch import native
        b = len(indices)
        tops, lefts, flips = self._draw(b)
        idx64 = np.asarray(indices, np.int64)
        if b and (idx64.min() < 0 or idx64.max() >= len(self._store)):
            raise ValueError('batch indices out of range [0, %d)'
                             % len(self._store))
        labels = self._labels[idx64]
        if self._store.dtype == np.float32:
            src, src_idx = self._store, idx64
        else:
            # only this batch's samples, as float32 (the kernel's type)
            src = self._store[idx64].astype(np.float32)
            src_idx = np.arange(b, dtype=np.int64)
        images = native.augment_batch(src, src_idx, tops, lefts, flips,
                                      self.crop_size, mean=self.mean,
                                      scale=self.scale)
        return images, labels


def compute_mean(dataset, limit=256):
    """Mean image over (up to ``limit``) samples -- the reference ships
    this as ``examples/imagenet/compute_mean.py``."""
    acc = None
    n = min(len(dataset), limit)
    for i in range(n):
        img, _ = dataset[i]
        acc = img if acc is None else acc + img
    return (acc / n).astype(np.float32)
