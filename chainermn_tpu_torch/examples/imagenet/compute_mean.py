"""Compute the dataset's mean image.

The port's twin of ``examples/imagenet/compute_mean.py`` (the
reference's ``compute_mean.py``): the mean over the first ``--limit``
training images, saved as an npy file for ``train_imagenet.py --mean``:

    python chainermn_tpu_torch/examples/imagenet/compute_mean.py \\
        [--root DIR] [--output mean.npy]
"""

import argparse
import os
import sys

import numpy as np

if __package__ in (None, ''):   # run as a script: the repo on the path
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), '..', '..', '..'))

from chainermn_tpu_torch.datasets import imagenet  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description='Compute mean image')
    parser.add_argument('--root', '-R', default=None,
                        help='dataset root (synthetic if absent)')
    parser.add_argument('--output', '-o', default='mean.npy')
    parser.add_argument('--limit', type=int, default=256)
    args = parser.parse_args(argv)

    if args.root:
        os.environ['CHAINERMN_TPU_IMAGENET'] = args.root
    train, _ = imagenet.get_imagenet()
    mean = imagenet.compute_mean(train, limit=args.limit)
    np.save(args.output, mean)
    print('saved %s (shape %s)' % (args.output, mean.shape))
    return mean


if __name__ == '__main__':
    main()
