"""Gradient tensor fusion.

Counterpart of ``chainermn_tpu/communicators/memory_utility.py``: pack a
list of tensors into one flat buffer per group, reduce each buffer with
one collective, and unpack views of the result, so the collective count
is the number of groups, not of tensors.  The default plan makes one
group per dtype, ordered by dtype name (mixed-precision models must not
share a buffer across dtypes).
"""

import torch


def pad_to_multiple(buf, multiple):
    """``(buf padded with zeros to a multiple of multiple, its length
    before)``: a collective scatter needs shards that divide evenly."""
    n = buf.numel()
    rem = (-n) % multiple
    if rem:
        buf = torch.cat([buf, buf.new_zeros(rem)])
    return buf, n


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def plan_by_dtype(tensors):
    """Default fusion plan: the tensor indices of each dtype, the groups
    ordered by dtype name."""
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    return [idx for _, idx in sorted(by_dtype.items(),
                                     key=lambda kv: _dtype_name(kv[0]))]


def pack(tensors, dtype=None):
    """One flat buffer of ``tensors`` in order, in ``dtype`` (default:
    the first tensor's)."""
    dtype = dtype or tensors[0].dtype
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def unpack(buf, tensors):
    """Views of ``buf`` shaped like ``tensors``, in order (in ``buf``'s
    dtype)."""
    out, offset = [], 0
    for t in tensors:
        n = t.numel()
        out.append(buf[offset:offset + n].view(t.shape))
        offset += n
    return out


def fused_reduce(tensors, reduce_buf, plan=plan_by_dtype, dtype=None):
    """``reduce_buf(flat buffer) -> flat buffer`` applied to ``tensors``,
    one buffer per group of ``plan(tensors) -> [[index, ...], ...]``,
    packed in ``dtype`` (default: each group's own).  Returns the reduced
    tensors in order, each a view of its group's buffer."""
    out = [None] * len(tensors)
    for idx in plan(tensors):
        group = [tensors[i] for i in idx]
        buf = reduce_buf(pack(group, dtype))
        for i, r in zip(idx, unpack(buf, group)):
            out[i] = r
    return out
