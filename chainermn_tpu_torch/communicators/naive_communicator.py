"""Per-parameter allreduce (reference ``naive_communicator.py``).

Counterpart of ``chainermn_tpu/communicators/naive_communicator.py``:
one all_reduce per gradient tensor, no fusion -- the fusion-free
control for benchmarking.
"""

from chainermn_tpu_torch.communicators.base import CommunicatorBase


class NaiveCommunicator(CommunicatorBase):

    def _allreduce_impl(self, tensors):
        out = []
        for t in tensors:
            buf = t if t.is_contiguous() else t.contiguous()
            self._all_reduce(buf, 'mean')
            out.append(buf)
        return out
