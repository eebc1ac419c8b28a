"""Single-collective allreduce (reference ``flat_communicator.py``).

Counterpart of ``chainermn_tpu/communicators/flat_communicator.py``:
every gradient is promoted to one common dtype and packed into ONE flat
buffer for ONE all_reduce; original dtypes are restored on unpack.
"""

import functools

import torch

from chainermn_tpu_torch.communicators.base import CommunicatorBase


class FlatCommunicator(CommunicatorBase):

    def _allreduce_impl(self, tensors):
        common = functools.reduce(torch.promote_types,
                                  [t.dtype for t in tensors])
        return self._reduce_grouped(tensors, 'mean',
                                    dtype_of=lambda t: common)
