"""Int8-weight inference matmul: dequantize-in-matmul primitives.

Counterpart of ``chainermn_tpu/ops/int8_matmul.py``, which is ``jnp``
there, not Pallas: it reaches no ``pl.pallas_call``, so these are
PyTorch ops here too.  The int8 policy
(:class:`~chainermn_tpu_torch.precision.Int8Policy`) stores weights as
``(int8 q, f32 per-channel scale)``; both forms below are exact for
per-output-channel symmetric scales:

- :func:`dequant_matmul` -- ``(x @ q.to(compute)) * scale``: the scale
  multiplies the product's output channels, so no scaled weight is
  formed;
- :func:`dequant` -- ``q.to(compute) * scale``, the weight itself, which
  the serving engines form one layer at a time just before the layer
  runs (:func:`~chainermn_tpu_torch.precision.dequantized_view`).
"""

import torch


def dequant(q, scale, dtype=torch.float32, axis=-1):
    """The dequantized weight ``q * scale`` in ``dtype``; ``scale`` (one
    value per output channel) broadcasts along ``axis`` of ``q`` (the
    last axis of a flax-layout kernel, 0 of a PyTorch ``weight``)."""
    s = scale.to(dtype)
    if s.dim() == 1 and q.dim() > 1:
        shape = [1] * q.dim()
        shape[axis] = -1
        s = s.reshape(shape)
    return q.to(dtype) * s


def dequant_matmul(x, q, scale, dtype=None):
    """``x @ dequant(q, scale)`` with the scale on the output: ``x``
    ``(..., in)``, ``q`` int8 ``(in, out)``, ``scale`` ``(out,)`` or a
    scalar; the product runs in ``dtype`` (default ``x.dtype``) on the
    cast of ``q``, and the per-output-channel scale multiplies the
    ``(..., out)`` result -- equal to dequantize-then-matmul up to
    rounding, since the scale is constant along the contracted axis."""
    out_dtype = dtype if dtype is not None else x.dtype
    y = torch.matmul(x.to(out_dtype), q.to(out_dtype))
    return y * scale.to(out_dtype)


def dequant_matmul_reference(x, q, scale, dtype=None):
    """Oracle: form the dequantized weight, then multiply."""
    out_dtype = dtype if dtype is not None else x.dtype
    return torch.matmul(x.to(out_dtype), dequant(q, scale, out_dtype))
