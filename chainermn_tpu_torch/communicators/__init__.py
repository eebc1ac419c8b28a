"""Communicator factory.

Counterpart of ``chainermn_tpu/communicators/__init__.py``: the same
name -> strategy surface, on ``torch.distributed``.

============== ==============================================
Name           Strategy
============== ==============================================
xla            one all_reduce per dtype over packed buffers
flat           one all_reduce over one buffer of a common dtype
naive          one all_reduce per gradient tensor
dummy          packing only, no communication
============== ==============================================

``hierarchical``, ``two_dimensional``, ``single_node``,
``non_cuda_aware`` and ``bucketed`` are not ported yet (ROADMAP.md A1).
"""

from chainermn_tpu_torch.communicators.base import CommunicatorBase  # noqa
from chainermn_tpu_torch.communicators.dummy_communicator import (
    DummyCommunicator)
from chainermn_tpu_torch.communicators.flat_communicator import (
    FlatCommunicator)
from chainermn_tpu_torch.communicators.naive_communicator import (
    NaiveCommunicator)
from chainermn_tpu_torch.communicators.xla_communicator import (
    XlaCommunicator)

_COMMUNICATORS = {
    'xla': XlaCommunicator,
    'flat': FlatCommunicator,
    'naive': NaiveCommunicator,
    'dummy': DummyCommunicator,
}

_NOT_PORTED = ('hierarchical', 'two_dimensional', 'single_node',
               'non_cuda_aware', 'bucketed')


def create_communicator(communicator_name='xla', device=None, **kwargs):
    """Create a communicator by strategy name.

    ``device`` defaults to the CUDA device of this process (NCCL); pass
    ``device='cpu'`` for gloo.  Extra keyword arguments (e.g.
    ``reduce_dtype=torch.bfloat16``) pass through to the strategy.
    """
    if communicator_name in _NOT_PORTED:
        raise NotImplementedError(
            'communicator %r is not ported yet (ROADMAP.md A1)'
            % communicator_name)
    try:
        cls = _COMMUNICATORS[communicator_name]
    except KeyError:
        raise ValueError(
            'Unrecognized communicator: %r (choose from %s)'
            % (communicator_name,
               ', '.join(sorted(_COMMUNICATORS) + list(_NOT_PORTED))))
    return cls(device=device, **kwargs)
