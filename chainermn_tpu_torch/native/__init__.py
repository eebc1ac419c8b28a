"""The port's native host core: ``ctypes`` bindings of
``chainermn_tpu_torch/csrc/chainermn_core.cpp`` (:mod:`.core`), built at
first use.  Counterpart of ``chainermn_tpu/native``, without its
``available`` flag: a failed build raises instead of falling back."""

from chainermn_tpu_torch.native.core import (  # noqa: F401
    Arena, CommError, NativeCommunicator, augment_batch, lib_path,
    pack_arrays, pool_threads, unpack_arrays)
