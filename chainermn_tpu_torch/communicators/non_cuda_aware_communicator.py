"""Host-staged hierarchical allreduce (reference
``non_cuda_aware_communicator.py``).

Counterpart of
``chainermn_tpu/communicators/non_cuda_aware_communicator.py``.  The
reference exists for MPI builds that cannot read GPU pointers: the
inter-node leg goes through pinned host memory.  Here it is the
hierarchical strategy whose inter-node all_reduce runs over a gloo
sub-group on pinned host tensors; the intra-node legs stay on the
default group's backend (NCCL on the card).  The staged shard keeps the
JAX package's dtype rule (``:30-41``): a dtype wider than float32 is
narrowed to float32, a narrower one is never widened (bf16 stays bf16).
"""

import torch
import torch.distributed as dist

from chainermn_tpu_torch.communicators import mesh_utility
from chainermn_tpu_torch.communicators.hierarchical_communicator import (
    HierarchicalCommunicator)


class NonCudaAwareCommunicator(HierarchicalCommunicator):

    inter_dtype = torch.float32

    def __init__(self, device=None, reduce_dtype=None, mesh_shape=None):
        super().__init__(device, reduce_dtype, mesh_shape)
        if self.device.type == 'cpu':
            self._host_inter_group = self._inter_group   # gloo already
        else:
            _, cols = mesh_utility.group_ranks(*self.mesh_shape)
            self._host_inter_group = mesh_utility.new_groups(
                cols, self.rank, backend='gloo')

    @classmethod
    def stage_dtype(cls, dtype):
        """The dtype of the host-staged shard: ``dtype`` narrowed to
        ``inter_dtype`` when wider, never widened."""
        if dtype.itemsize > cls.inter_dtype.itemsize:
            return cls.inter_dtype
        return dtype

    def _inter_reduce(self, shard):
        stage = self.stage_dtype(shard.dtype)
        if shard.is_cuda:
            staged = torch.empty(shard.shape, dtype=stage, pin_memory=True)
            staged.copy_(shard, non_blocking=True)
            torch.cuda.current_stream(shard.device).synchronize()
        else:
            staged = shard.to(stage)
        dist.all_reduce(staged, group=self._host_inter_group)
        if staged is not shard:
            shard.copy_(staged, non_blocking=True)
