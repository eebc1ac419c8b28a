"""No-communication communicator (reference ``dummy_communicator.py``).

Counterpart of ``chainermn_tpu/communicators/dummy_communicator.py``:
runs the per-dtype pack and unpack of ``xla`` but no collective, so a
measured step isolates packing from communication.  Like the reference,
it does not train correctly on more than one process.
"""

from chainermn_tpu_torch.communicators import memory_utility
from chainermn_tpu_torch.communicators.base import CommunicatorBase


class DummyCommunicator(CommunicatorBase):

    def _allreduce_impl(self, tensors):
        return memory_utility.fused_reduce(tensors, lambda buf: buf)
