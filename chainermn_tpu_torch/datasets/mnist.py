"""MNIST access (the workload of reference ``examples/mnist`` and the
convergence gate ``tests/test_mnist.py:33-80``).

Copy of ``chainermn_tpu/datasets/mnist.py`` (numpy host code, no change
to the arrays it makes).  :func:`get_mnist` loads real data when
``CHAINERMN_TPU_MNIST`` points at an ``mnist.npz``-style file and
otherwise generates a deterministic *learnable stand-in* from a seed:
10 anisotropic Gaussian clusters in 784-d (``'classic'``), or the
antipodal-cluster task no linear model can solve (``'hard'``, the gate's
data).  An MLP reaches the reference CI's >=0.95 accuracy bar on both.
"""

import os

import numpy as np


def _synthetic_mnist(n_train=6000, n_test=1000, dim=784, n_classes=10,
                     seed=1234):
    rng = np.random.RandomState(seed)
    # class prototypes kept well-separated but overlapping enough that
    # a linear model is not trivially perfect
    prototypes = rng.randn(n_classes, dim).astype(np.float32) * 1.2
    # low-rank intra-class variation + isotropic noise
    basis = rng.randn(n_classes, 16, dim).astype(np.float32)

    def make(n, seed2):
        r = np.random.RandomState(seed2)
        labels = r.randint(0, n_classes, size=n).astype(np.int32)
        coeff = r.randn(n, 16).astype(np.float32)
        x = prototypes[labels] + 0.35 * np.einsum(
            'nk,nkd->nd', coeff, basis[labels]) / np.sqrt(16)
        x += 0.45 * r.randn(n, dim).astype(np.float32)
        # squash to [0, 1] like pixel intensities
        x = 1.0 / (1.0 + np.exp(-x))
        return x.astype(np.float32), labels

    return make(n_train, seed + 1), make(n_test, seed + 2)


def _synthetic_mnist_hard(n_train=6000, n_test=1000, dim=784,
                          n_classes=10, seed=4321):
    """Antipodal-cluster task: class ``c`` is the UNION of the two
    antipodal clusters around ``+mu_c`` and ``-mu_c``.

    No linear classifier can exceed chance-ish accuracy (a hyperplane
    assigns opposite signs to a cluster and its mirror), so unlike the
    'classic' stand-in this bar requires real model capacity AND a
    healthy optimization trajectory -- a crippled model or a broken
    gradient mean demonstrably fails it (the gate's negative tests).
    Inputs are NOT squashed to [0, 1]: the sigmoid would destroy the
    antipodal structure.
    """
    rng = np.random.RandomState(seed)
    mu = rng.randn(n_classes, dim).astype(np.float32)
    mu *= 2.0 / np.linalg.norm(mu, axis=1, keepdims=True)

    def make(n, seed2):
        r = np.random.RandomState(seed2)
        labels = r.randint(0, n_classes, size=n).astype(np.int32)
        sign = r.choice([-1.0, 1.0], size=(n, 1)).astype(np.float32)
        x = sign * mu[labels] + 0.28 * r.randn(n, dim).astype(
            np.float32)
        return x.astype(np.float32), labels

    return make(n_train, seed + 1), make(n_test, seed + 2)


def get_mnist(withlabel=True, ndim=1, variant='classic'):
    """Return ``(train, test)`` datasets of ``(x, label)`` tuples.

    Mirrors ``chainer.datasets.get_mnist`` used at
    ``examples/mnist/train_mnist.py:92`` closely enough for the
    examples and tests; see module docstring for the data source.
    ``variant='hard'`` selects the antipodal-cluster stand-in the
    convergence gate uses (ignored when ``CHAINERMN_TPU_MNIST``
    provides real data).
    """
    path = os.environ.get('CHAINERMN_TPU_MNIST')
    if path and os.path.exists(path):
        with np.load(path) as d:
            train_x = d['x_train'].reshape(len(d['x_train']), -1) / 255.0
            test_x = d['x_test'].reshape(len(d['x_test']), -1) / 255.0
            train = (train_x.astype(np.float32), d['y_train'].astype(
                np.int32))
            test = (test_x.astype(np.float32), d['y_test'].astype(np.int32))
    elif variant == 'hard':
        train, test = _synthetic_mnist_hard()
    elif variant == 'classic':
        train, test = _synthetic_mnist()
    else:
        # a typo'd variant silently serving the easy clusters would
        # make the convergence gate pass vacuously -- fail loudly
        raise ValueError("variant must be 'classic' or 'hard', got %r"
                         % (variant,))

    def build(pair):
        x, y = pair
        if ndim == 3:
            x = x.reshape(-1, 1, 28, 28)
        if not withlabel:
            return [xi for xi in x]
        return TupleDataset(x, y)

    return build(train), build(test)


class TupleDataset:
    """Zip of arrays -> tuple examples (chainer.datasets.TupleDataset
    equivalent)."""

    def __init__(self, *arrays):
        n = len(arrays[0])
        if any(len(a) != n for a in arrays):
            raise ValueError('arrays must share length')
        self._arrays = arrays

    def __len__(self):
        return len(self._arrays[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return tuple(a[i] for a in self._arrays)
