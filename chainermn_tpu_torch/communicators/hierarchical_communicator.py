"""Two-level allreduce (reference default, ``hierarchical_communicator.py``).

Counterpart of ``chainermn_tpu/communicators/hierarchical_communicator.py``
(``:27-36``): per dtype buffer, a reduce-scatter within the node, an
all_reduce of each shard across nodes, an all-gather within the node,
then ``/ size``:

    reduce_scatter(intra) -> all_reduce(inter) -> all_gather(intra)

Each process ships ``1/intra_size`` of the buffer across nodes, so the
inter-node traffic is spread over every process's link instead of one
root's.
"""

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import memory_utility
from chainermn_tpu_torch.communicators.base import CommunicatorBase


class HierarchicalCommunicator(CommunicatorBase):

    def _inter_reduce(self, shard):
        """Sum ``shard`` IN PLACE over the inter-node group."""
        dist.all_reduce(shard, group=self._inter_group)

    def _reduce_buf(self, buf):
        buf, n = memory_utility.pad_to_multiple(buf, self.intra_size)
        shard = buf.new_empty(buf.numel() // self.intra_size)
        dist.reduce_scatter_tensor(shard, buf, group=self._intra_group)
        self._inter_reduce(shard)
        out = torch.empty_like(buf)
        dist.all_gather_into_tensor(out, shard, group=self._intra_group)
        return out[:n] / self.size

    def _allreduce_impl(self, tensors):
        return memory_utility.fused_reduce(tensors, self._reduce_buf)
