"""Bucketed allreduce: fused chunks of about ``bucket_mb`` megabytes.

Counterpart of ``chainermn_tpu/communicators/bucketed_communicator.py``:
gradients are packed in backward-completion order (the reversed order of
the list: backprop makes the last layer's gradients first) into buckets
of at most ``bucket_mb`` MB, one open bucket per dtype, split at the
size threshold; one all_reduce per bucket.  All the buckets' all_reduces
are issued asynchronously in plan order and then waited on.  Firing each
bucket from gradient hooks, so that it overlaps the backward pass, is
not ported yet (ROADMAP.md queue A, item 5).
"""

import torch.distributed as dist

from chainermn_tpu_torch.communicators import memory_utility
from chainermn_tpu_torch.communicators.base import CommunicatorBase


class BucketedCommunicator(CommunicatorBase):

    def __init__(self, device=None, reduce_dtype=None, mesh_shape=None,
                 bucket_mb=25.0):
        if bucket_mb <= 0:
            raise ValueError('bucket_mb must be positive')
        super().__init__(device, reduce_dtype, mesh_shape)
        self.bucket_bytes = int(bucket_mb * 1e6)

    def plan_buckets(self, tensors):
        """Partition tensor indices into buckets: reversed order, one
        OPEN bucket per dtype (interleaved dtypes still fuse into big
        buckets), split at ``bucket_bytes``."""
        buckets = []
        open_buckets = {}   # dtype -> (indices, bytes)
        for i in reversed(range(len(tensors))):
            t = tensors[i]
            nbytes = t.numel() * t.element_size()
            cur, cur_bytes = open_buckets.get(t.dtype, ([], 0))
            if cur and cur_bytes + nbytes > self.bucket_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
            cur.append(i)
            open_buckets[t.dtype] = (cur, cur_bytes + nbytes)
        buckets.extend(cur for cur, _ in open_buckets.values() if cur)
        return buckets

    def _allreduce_impl(self, tensors):
        buckets = self.plan_buckets(tensors)
        groups = [[tensors[i] for i in b] for b in buckets]
        bufs = [memory_utility.pack(g) for g in groups]
        works = [dist.all_reduce(buf, async_op=True) for buf in bufs]
        for work in works:
            work.wait()
        out = [None] * len(tensors)
        for b, g, buf in zip(buckets, groups, bufs):
            buf /= self.size
            for i, r in zip(b, memory_utility.unpack(buf, g)):
                out[i] = r
        return out
