"""Kernel layer: hand-written CUDA kernels for Hopper, each beside its
plain PyTorch version.

Layer conventions (counterpart of ``chainermn_tpu.ops``): a wrapper
launches its kernel on CUDA tensors and runs its plain version on CPU
tensors (dispatch by device alone, ``_common.on_cuda``); every wrapper
counts its launches in a plain integer attribute ``launches``.
"""

from chainermn_tpu_torch.ops.batch_norm_act import (  # noqa: F401
    batch_norm_act, batch_norm_act_inference, batch_norm_act_reference,
    bn_apply, bn_stats)
from chainermn_tpu_torch.ops.optimizer import (  # noqa: F401
    FusedMomentumSGD, momentum_sgd, sgd_update)

#: name -> kernel wrapper (each carries a ``launches`` count)
KERNELS = {'bn_stats': bn_stats, 'bn_apply': bn_apply,
           'momentum_sgd': sgd_update}


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
