"""Communicator factory.

Counterpart of ``chainermn_tpu/communicators/__init__.py``: the same
name -> strategy surface, on ``torch.distributed`` (NCCL on CUDA
devices, gloo on the CPU), one process per device.  ``mesh_shape=(inter,
intra)`` lays the processes out on nodes (default: torchrun's
``LOCAL_WORLD_SIZE`` processes a node).

=============== ===================================================
Name            Strategy
=============== ===================================================
xla             one all_reduce per dtype over packed buffers
                (recommended)
hierarchical    intra-node reduce-scatter -> inter-node all_reduce
                -> intra-node all-gather (reference default)
two_dimensional reduce-scatter / all-gather over the whole world
flat            one all_reduce over one buffer of a common dtype
naive           one all_reduce per gradient tensor
single_node     intra-node only; raises unless inter_size == 1
non_cuda_aware  hierarchical, the inter-node leg over gloo through
                pinned host memory (narrowed to <= float32)
dummy           packing only, no communication
bucketed        ~25 MB buckets in backward order, one async
                all_reduce each
=============== ===================================================
"""

from chainermn_tpu_torch.communicators.base import CommunicatorBase  # noqa
from chainermn_tpu_torch.communicators.bucketed_communicator import (
    BucketedCommunicator)
from chainermn_tpu_torch.communicators.dummy_communicator import (
    DummyCommunicator)
from chainermn_tpu_torch.communicators.flat_communicator import (
    FlatCommunicator)
from chainermn_tpu_torch.communicators.hierarchical_communicator import (
    HierarchicalCommunicator)
from chainermn_tpu_torch.communicators.naive_communicator import (
    NaiveCommunicator)
from chainermn_tpu_torch.communicators.non_cuda_aware_communicator import (
    NonCudaAwareCommunicator)
from chainermn_tpu_torch.communicators.single_node_communicator import (
    SingleNodeCommunicator)
from chainermn_tpu_torch.communicators.two_dimensional_communicator import (
    TwoDimensionalCommunicator)
from chainermn_tpu_torch.communicators.xla_communicator import (
    XlaCommunicator)

_COMMUNICATORS = {
    'naive': NaiveCommunicator,
    'flat': FlatCommunicator,
    'hierarchical': HierarchicalCommunicator,
    'two_dimensional': TwoDimensionalCommunicator,
    'single_node': SingleNodeCommunicator,
    'non_cuda_aware': NonCudaAwareCommunicator,
    'dummy': DummyCommunicator,
    'xla': XlaCommunicator,
    'bucketed': BucketedCommunicator,
}


def create_communicator(communicator_name='xla', device=None,
                        mesh_shape=None, **kwargs):
    """Create a communicator by strategy name.

    ``device`` defaults to the CUDA device of this process (NCCL); pass
    ``device='cpu'`` for gloo.  ``mesh_shape=(inter, intra)`` sets the
    node layout.  Extra keyword arguments pass through to the strategy
    (``reduce_dtype=torch.bfloat16`` for any, ``bucket_mb`` for
    ``'bucketed'``).
    """
    try:
        cls = _COMMUNICATORS[communicator_name]
    except KeyError:
        raise ValueError(
            'Unrecognized communicator: %r (choose from %s)'
            % (communicator_name, ', '.join(sorted(_COMMUNICATORS))))
    return cls(device=device, mesh_shape=mesh_shape, **kwargs)
