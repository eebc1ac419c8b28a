"""Kernel layer: hand-written CUDA kernels for Hopper, each beside its
plain PyTorch version.

Layer conventions (counterpart of ``chainermn_tpu.ops``): a wrapper
launches its kernel on CUDA tensors and runs its plain version on CPU
tensors (dispatch by device alone, ``_common.on_cuda``); every wrapper
counts its launches in a plain integer attribute ``launches``; the
wrappers with a tensor-core route for bf16 operands (``TC_KERNELS``)
count those launches in ``tc_launches`` as well, and the multi-tensor
momentum SGD counts the tensors its launches updated in ``tensors``.
"""

from chainermn_tpu_torch.ops.batch_norm_act import (  # noqa: F401
    batch_norm_act, batch_norm_act_inference, batch_norm_act_reference,
    bn_apply, bn_backward, bn_stats)
from chainermn_tpu_torch.ops.cross_entropy import (  # noqa: F401
    ce_forward, softmax_cross_entropy, softmax_cross_entropy_reference)
from chainermn_tpu_torch.ops.flash_attention import (  # noqa: F401
    chunk_attention_reference, decode_attention_paged_reference,
    decode_attention_reference, flash_attention, flash_attention_chunk,
    flash_attention_decode, flash_attention_decode_paged,
    flash_attention_fwd, flash_bwd_dkv, flash_bwd_dq, flash_decode,
    flash_decode_paged, flash_fwd, mha_reference)
from chainermn_tpu_torch.ops.layer_norm import (  # noqa: F401
    layer_norm, layer_norm_reference, ln_forward)
from chainermn_tpu_torch.ops.optimizer import (  # noqa: F401
    FusedMomentumSGD, momentum_sgd, sgd_update)

#: name -> kernel wrapper (each carries a ``launches`` count)
KERNELS = {'bn_stats': bn_stats, 'bn_apply': bn_apply,
           'bn_backward': bn_backward,
           'momentum_sgd': momentum_sgd, 'layer_norm': ln_forward,
           'flash_fwd': flash_fwd, 'flash_decode': flash_decode,
           'flash_bwd_dq': flash_bwd_dq, 'flash_bwd_dkv': flash_bwd_dkv,
           'cross_entropy': ce_forward,
           'flash_decode_paged': flash_decode_paged}


#: the kernels with a tensor-core route for bf16 operands: their wrappers
#: also count those launches in ``tc_launches``
TC_KERNELS = ('flash_fwd', 'flash_bwd_dq', 'flash_bwd_dkv')


def launch_counts():
    return {name: fn.launches for name, fn in KERNELS.items()}


def tc_launch_counts():
    return {name: KERNELS[name].tc_launches for name in TC_KERNELS}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
    for name in TC_KERNELS:
        KERNELS[name].tc_launches = 0
    momentum_sgd.tensors = 0
