"""Reduce-scatter / all-gather allreduce (reference
``two_dimensional_communicator.py``).

Counterpart of
``chainermn_tpu/communicators/two_dimensional_communicator.py``
(``:29-36``): per dtype buffer, padded to a multiple of ``size``, a
reduce-scatter over the whole world, ``/ size`` on the shard, then an
all-gather:

    reduce_scatter(inter+intra) -> / size -> all_gather(inter+intra)
"""

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import memory_utility
from chainermn_tpu_torch.communicators.base import CommunicatorBase


class TwoDimensionalCommunicator(CommunicatorBase):

    def _reduce_buf(self, buf):
        buf, n = memory_utility.pad_to_multiple(buf, self.size)
        shard = buf.new_empty(buf.numel() // self.size)
        dist.reduce_scatter_tensor(shard, buf)
        shard /= self.size
        out = torch.empty_like(buf)
        dist.all_gather_into_tensor(out, shard)
        return out[:n]

    def _allreduce_impl(self, tensors):
        return memory_utility.fused_reduce(tensors, self._reduce_buf)
