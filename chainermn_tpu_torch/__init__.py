"""ChainerMN on PyTorch and CUDA: the port of ``chainermn_tpu``.

A second package beside the JAX one, which stays the reference.  It
keeps the JAX package's module paths and public names; inside it is
PyTorch (``nn.Module``s, explicit devices and generators,
``torch.distributed`` with NCCL), and every TPU kernel on a ported path
is a kernel written by hand for Hopper (``csrc/``).  It never imports
JAX or anything of ``chainermn_tpu``.

Public API ported so far: :func:`create_communicator`,
:func:`scatter_dataset`, :func:`create_multi_node_optimizer`,
:func:`create_empty_dataset`, and the ``datasets``, ``models``, ``ops``
and ``training`` subpackages.  Entry points run on the current CUDA
device unless the caller passes ``device='cpu'``.
"""

from chainermn_tpu_torch.communicators import create_communicator  # noqa
from chainermn_tpu_torch.communicators.base import CommunicatorBase  # noqa
from chainermn_tpu_torch.dataset import scatter_dataset  # noqa: F401
from chainermn_tpu_torch.datasets import create_empty_dataset  # noqa
from chainermn_tpu_torch.multi_node_optimizer import (  # noqa: F401
    create_multi_node_optimizer)
from chainermn_tpu_torch import datasets, models, ops, training  # noqa

__version__ = '0.1.0'
