"""ImageNet-style dataset pipeline (numpy host code).

Copy of ``chainermn_tpu/datasets/imagenet.py`` without the native batch
pipeline: ``PreprocessedDataset`` (mean subtraction, random crop + flip
for training, center crop for eval, pixel scaling), the deterministic
``SyntheticImageNet`` stand-in, ``get_imagenet`` (real data from
``CHAINERMN_TPU_IMAGENET`` when it points at prepared npy lists,
synthetic otherwise) and ``compute_mean``.
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


def compute_mean(dataset, limit=256):
    """Mean image over (up to ``limit``) samples -- the reference ships
    this as ``examples/imagenet/compute_mean.py``."""
    acc = None
    n = min(len(dataset), limit)
    for i in range(n):
        img, _ = dataset[i]
        acc = img if acc is None else acc + img
    return (acc / n).astype(np.float32)
