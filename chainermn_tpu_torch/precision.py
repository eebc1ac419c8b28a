"""Mixed-precision policy (the subset the serving path needs).

Counterpart of ``chainermn_tpu/precision.py``: :func:`cast_floating`,
:class:`Policy` with its ``f32()`` and ``bf16()`` registry entries, and
the KV-cache quantization pair :func:`quantize_kv` /
:func:`dequantize_kv`.  Dtypes are ``torch.dtype``s; a parameter tree is
a nested ``dict`` of tensors (the layout of a flax tree).

``Int8Policy`` (weight quantization), ``Policy.f16`` and the loss
scales are not ported yet (ROADMAP.md A4, A8).
"""

import torch


def cast_floating(tree, dtype):
    """Cast every floating-point tensor of a nested ``dict`` to ``dtype``
    (integer and bool tensors pass through; ``dtype=None`` is the
    identity).  A tensor already of ``dtype`` is returned as it is, not
    copied."""
    if dtype is None:
        return tree
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point() \
            and tree.dtype != dtype:
        return tree.to(dtype)
    return tree


def quantize_kv(x):
    """Per-vector symmetric int8 quantization over the LAST axis:
    ``scale = max|x| / 127`` per vector (1 for an all-zero vector),
    ``q = round(x / scale)`` clipped to +-127.  Returns ``(q int8 of
    x.shape, scale float32 of x.shape[:-1])``.

    ``torch.round`` rounds half to even, as ``jnp.round`` does, and the
    divisions are the same float32 operations, so the two packages
    quantize a cache to the same bits."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.float32):
    """Inverse of :func:`quantize_kv` (up to rounding)."""
    return q.to(dtype) * scale[..., None].to(dtype)


class Policy:
    """Dtype policy: the master dtype of the parameters, the dtype the
    model computes in, the dtype gradients are reduced in (``None``:
    their own) and the dtype of the outputs (``None``: the compute
    dtype)."""

    def __init__(self, param_dtype=torch.float32,
                 compute_dtype=torch.float32, reduce_dtype=None,
                 output_dtype=None, loss_scale=None):
        if loss_scale is not None:
            raise NotImplementedError(
                'loss scaling is not ported yet (ROADMAP.md A4)')
        self.param_dtype = param_dtype
        self.compute_dtype = compute_dtype
        self.reduce_dtype = reduce_dtype
        self.output_dtype = output_dtype
        self.loss_scale = None

    @classmethod
    def f32(cls):
        """Full precision (the identity policy)."""
        return cls()

    @classmethod
    def bf16(cls):
        """bf16 compute and reduce, f32 master weights, f32 outputs."""
        return cls(param_dtype=torch.float32,
                   compute_dtype=torch.bfloat16,
                   reduce_dtype=torch.bfloat16,
                   output_dtype=torch.float32)
