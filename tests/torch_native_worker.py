"""Rank body of the two-process ``NativeCommunicator`` test in
``tests/test_torch_native.py`` (a module of its own, so that a spawned
rank imports only numpy, torch and the port's native core)."""

import numpy as np
import torch


def run(comm_id, n, rank, queue):
    """Every collective once; puts ``(rank, results)`` or ``(rank,
    repr(error))`` on ``queue``."""
    try:
        from chainermn_tpu_torch import native
        c = native.NativeCommunicator(comm_id, n, rank, slot_bytes=1 << 14,
                                      timeout=30.0)
        try:
            x = np.arange(6, dtype=np.float32) + rank
            bf = torch.arange(6, dtype=torch.bfloat16) * 0.5 + rank
            results = {
                'allreduce': c.allreduce(x, 'sum'),
                'allreduce_max_i64': c.allreduce(
                    np.array([rank, -rank], np.int64), 'max'),
                'allreduce_f16': c.allreduce(x.astype(np.float16), 'sum'),
                'allreduce_bf16': c.allreduce(bf, 'sum').view(
                    torch.int16).numpy(),
                'allreduce_bf16_dtype': str(c.allreduce(bf).dtype),
                'reduce': c.reduce(x, 'max', root=0),
                'reduce_prod': c.reduce(x + 1, 'prod', root=1),
                'bcast': c.bcast(x if rank == 1
                                 else np.zeros(6, np.float32), root=1),
                'reduce_scatter': c.reduce_scatter(
                    np.arange(n * 2, dtype=np.float32) + rank, 'sum'),
                'allgather': c.allgather(np.array([rank], np.float64)),
                'allgather_i32': c.allgather(
                    torch.tensor([rank, 10 + rank], dtype=torch.int32)
                ).numpy(),
            }
            c.barrier()
        finally:
            c.destroy()
        queue.put((rank, results))
    except Exception as e:  # the test asserts on it
        queue.put((rank, repr(e)))
