"""Flagship communicator: one fused all_reduce per dtype.

Counterpart of ``chainermn_tpu/communicators/xla_communicator.py``.
Gradients are packed into one flat buffer per dtype, so small
parameters ride one NCCL collective and no dtype is widened.
"""

from chainermn_tpu_torch.communicators.base import CommunicatorBase


class XlaCommunicator(CommunicatorBase):

    def _allreduce_impl(self, tensors):
        return self._reduce_grouped(tensors, 'mean')
