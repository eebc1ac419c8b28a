"""Single-collective allreduce (reference ``flat_communicator.py``).

Counterpart of ``chainermn_tpu/communicators/flat_communicator.py``:
every gradient is promoted to one common dtype and packed into ONE flat
buffer for ONE all_reduce; original dtypes are restored on unpack.
"""

import functools

import torch

from chainermn_tpu_torch.communicators import memory_utility
from chainermn_tpu_torch.communicators.base import CommunicatorBase


class FlatCommunicator(CommunicatorBase):

    def _allreduce_impl(self, tensors):
        common = functools.reduce(torch.promote_types,
                                  [t.dtype for t in tensors])
        return memory_utility.fused_reduce(
            tensors, lambda buf: self._all_reduce(buf, 'mean'),
            plan=lambda ts: [list(range(len(ts)))], dtype=common)
