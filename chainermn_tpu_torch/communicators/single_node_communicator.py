"""Intra-node-only allreduce (reference ``single_node_communicator.py``).

Counterpart of
``chainermn_tpu/communicators/single_node_communicator.py``: the mean
over the intra-node group only, one all_reduce per dtype; construction
on a mesh with more than one node raises, as the reference asserts it
runs on one node.
"""

from chainermn_tpu_torch.communicators import memory_utility, mesh_utility
from chainermn_tpu_torch.communicators.base import CommunicatorBase


class SingleNodeCommunicator(CommunicatorBase):

    reduction_axes = (mesh_utility.AXIS_INTRA,)

    def __init__(self, device=None, reduce_dtype=None, mesh_shape=None):
        super().__init__(device, reduce_dtype, mesh_shape)
        if self.inter_size != 1:
            inter = self.inter_size
            self.close()
            raise ValueError(
                'SingleNodeCommunicator requires inter_size == 1 '
                '(got %d); use hierarchical/xla for multi-host meshes'
                % inter)

    def _reduce_buf(self, buf):
        self._all_reduce(buf, 'sum', group=self._intra_group)
        return buf / self.intra_size

    def _allreduce_impl(self, tensors):
        return memory_utility.fused_reduce(tensors, self._reduce_buf)
