"""Communicator base class on ``torch.distributed``.

Counterpart of ``chainermn_tpu/communicators/base.py``.  The JAX
communicator is a mesh-backed object whose collectives run inside a
traced SPMD step; here every process drives one device, as in the
reference ChainerMN, and the collectives are eager ``torch.distributed``
calls: NCCL for CUDA tensors, gloo for CPU tensors.

Correspondence with the JAX package:

- ``rank`` / ``size``   -> process rank / world size (one device each)
- ``allreduce_grad``    -> mean over all processes, strategy-defined
- ``allreduce(x, op)``  -> metrics and BatchNorm statistics
- ``broadcast_data``    -> root's values to every process
- ``allreduce_obj`` / ``bcast_obj`` -> one scalar / one picklable
  object (the evaluator's collectives)

Unlike the JAX versions, ``allreduce_grad`` and ``broadcast_data``
update their tensors IN PLACE.
"""

import os

import torch
import torch.distributed as dist

from chainermn_tpu_torch.ops._common import resolve_device

_OPS = {'sum': dist.ReduceOp.SUM, 'mean': dist.ReduceOp.SUM,
        'max': dist.ReduceOp.MAX, 'min': dist.ReduceOp.MIN}


class CommunicatorBase:
    """One process per device, on the default process group.

    The group is joined if it exists; else it is made from the
    ``torchrun`` environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``); else it is a world of one.  CUDA devices use NCCL
    and the CPU uses gloo; a group of the other backend is refused.

    ``reduce_dtype`` (e.g. ``torch.bfloat16``): gradients are cast to it
    before the strategy's reduction and restored after
    (:meth:`allreduce_grad` only).
    """

    def __init__(self, device=None, reduce_dtype=None):
        if (device is None and torch.cuda.is_available()
                and 'LOCAL_RANK' in os.environ):
            device = 'cuda:%d' % int(os.environ['LOCAL_RANK'])
        self.device = resolve_device(device)
        if self.device.type == 'cuda':
            torch.cuda.set_device(self.device)
        backend = 'nccl' if self.device.type == 'cuda' else 'gloo'
        self._owns_group = False
        if not dist.is_initialized():
            if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
                dist.init_process_group(backend, init_method='env://')
            else:
                dist.init_process_group(backend, store=dist.HashStore(),
                                        rank=0, world_size=1)
            self._owns_group = True
        joined = str(dist.get_backend())
        if backend not in joined:
            raise RuntimeError(
                'the process group uses %r, but device %s needs %r'
                % (joined, self.device, backend))
        self.reduce_dtype = reduce_dtype

    @property
    def size(self):
        return dist.get_world_size()

    @property
    def rank(self):
        return dist.get_rank()

    def close(self):
        """Destroy the process group if this communicator made it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    # -- flat-buffer helpers ---------------------------------------------
    def _all_reduce(self, buf, op):
        dist.all_reduce(buf, op=_OPS[op])
        if op == 'mean':
            buf /= self.size

    def _reduce_grouped(self, tensors, op, dtype_of=lambda t: t.dtype,
                        communicate=True):
        """Reduce ``tensors`` with one collective per buffer: tensors
        are packed into one flat buffer per ``dtype_of(t)``.  Returns
        new tensors, in order, each in its buffer's dtype."""
        out = [None] * len(tensors)
        groups = {}
        for i, t in enumerate(tensors):
            groups.setdefault(dtype_of(t), []).append(i)
        for dtype, idx in groups.items():
            buf = torch.cat([tensors[i].reshape(-1).to(dtype) for i in idx])
            if communicate:
                self._all_reduce(buf, op)
            offset = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = buf[offset:offset + n].view(tensors[i].shape)
                offset += n
        return out

    # -- collectives -------------------------------------------------------
    def allreduce_grad(self, grads):
        """Mean-allreduce a list of gradient tensors IN PLACE (``None``
        entries are skipped); returns the list."""
        live = [g for g in grads if g is not None]
        if not live:
            return grads
        work = live if self.reduce_dtype is None else [
            g.to(self.reduce_dtype) for g in live]
        reduced = self._allreduce_impl(work)
        with torch.no_grad():
            for g, r in zip(live, reduced):
                if r is not g:
                    g.copy_(r)
        return grads

    def _allreduce_impl(self, tensors):
        """Mean over processes; returns the reduced tensors (may be the
        inputs, reduced in place)."""
        raise NotImplementedError

    def allreduce(self, x, op='mean'):
        """Allreduce a tensor, a list of tensors or a dict of tensors
        (or Python numbers, reduced as f32) over all processes; returns
        new values in the same structure."""
        if op not in _OPS:
            raise ValueError('op must be one of %s, got %r'
                             % (sorted(_OPS), op))
        if isinstance(x, dict):
            keys = list(x)
            vals = self.allreduce([self._as_tensor(x[k]) for k in keys], op)
            return dict(zip(keys, vals))
        if isinstance(x, (list, tuple)):
            return self._reduce_grouped([self._as_tensor(t) for t in x], op)
        return self._reduce_grouped([self._as_tensor(x)], op)[0]

    def _as_tensor(self, v):
        if isinstance(v, torch.Tensor):
            return v.detach()
        return torch.as_tensor(v, dtype=torch.float32, device=self.device)

    @torch.no_grad()
    def broadcast_data(self, params, root=0):
        """Every process receives ``root``'s values, IN PLACE (one
        broadcast per dtype); returns ``params``."""
        params = list(params)
        if not params:
            return params
        groups = {}
        for p in params:
            groups.setdefault(p.dtype, []).append(p)
        for ps in groups.values():
            buf = torch.cat([p.detach().reshape(-1) for p in ps])
            dist.broadcast(buf, src=root)
            offset = 0
            for p in ps:
                n = p.numel()
                p.copy_(buf[offset:offset + n].view(p.shape))
                offset += n
        return params

    # -- object collectives (the evaluator's) -------------------------------
    def allreduce_obj(self, value, op='mean'):
        """Allreduce one scalar (a Python number, a numpy scalar or a
        0-d tensor) over all processes, in f64; returns a Python float.
        The reference's pickle-based ``mpi_comm.allreduce`` of a metric
        (``multi_node_evaluator.py:31-38``)."""
        return float(self.allreduce(torch.tensor(
            float(value), dtype=torch.float64, device=self.device), op))

    def bcast_obj(self, obj, root=0):
        """Every process receives ``root``'s picklable ``obj``."""
        box = [obj]
        dist.broadcast_object_list(box, src=root, device=self.device)
        return box[0]

    def send_obj(self, *args, **kwargs):
        raise NotImplementedError(
            'send_obj (with deadlines) is not ported yet (ROADMAP.md A1)')

    def recv_obj(self, *args, **kwargs):
        raise NotImplementedError(
            'recv_obj (with deadlines) is not ported yet (ROADMAP.md A1)')

    def barrier(self, *args, **kwargs):
        raise NotImplementedError(
            'barrier(timeout) is not ported yet (ROADMAP.md A1)')

    def __repr__(self):
        return '%s(rank=%d, size=%d, device=%s)' % (
            type(self).__name__, self.rank, self.size, self.device)
