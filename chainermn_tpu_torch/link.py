"""Model-parallel stage container.

Counterpart of ``chainermn_tpu/link.py`` (``MultiNodeChainList``).  It
keeps the JAX package's routing: stages declared in order, each with a
home rank, ``rank_in`` sources and ``rank_out`` destinations (cycles,
crossings and one-to-many branches included); messages between stages
form FIFO queues keyed ``(src, dst)``; a stage that expects a message
nobody sent, and a message nobody took, raise ``RuntimeError``.

Two execution modes, as in the JAX package:

- ``spmd=True``: the process program of the reference ChainerMN.  The
  JAX package runs the whole DAG inside ``shard_map`` on every device;
  here each process is one rank and runs only the stages whose home is
  its rank (``rank % comm.size``).  An edge between two stages of one
  rank stays local; an edge between ranks is a header (dtype, shape)
  and then :func:`chainermn_tpu_torch.functions.send` from the
  producer's rank to the consumer's; a global output (``rank_out=None``)
  is broadcast from its home rank and comes back on every rank, as the
  JAX package's masked ``psum`` does.  Its backward keeps only the home
  rank's own cotangent: every rank computes the same loss, and summing
  the cotangents over ranks would scale each gradient by the world size.
- default host mode: the whole DAG in one process (``place=True`` moves
  each stage's inputs to the CUDA device of its home rank among this
  process's devices; on one card that changes nothing).

Every rank declares every stage in the same order, so every rank holds
every stage's parameters; only those of its own stages get gradients.

Deadlock.  ``loss.backward()`` on a rank visits what its loss reaches.
A rank that sends to another rank and owns no output (rank 1 of the
cycle ``0 -> 1 -> 0``) would never run the backward of its ``send``,
which receives the gradient the peer's backward is sending, and both
ranks would wait.  So every ``send`` a rank made, and every output of
its own stages, are tied into each output it returns by
:func:`~chainermn_tpu_torch.functions.pseudo_connect` (a zero-gradient
delegate).  The transfers of the backward then run in the reverse of
the forward's order on every rank: autograd runs the nodes of one
graph in decreasing order of creation, and the forward made them in
declaration order everywhere.  Each transfer involves two ranks that
reach it in the same global order, so none waits forever.
"""

import torch
import torch.distributed as dist
from torch import nn

from chainermn_tpu_torch.functions import pseudo_connect
from chainermn_tpu_torch.functions.point_to_point_communication import (
    exchange, send)

_DTYPES = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64, torch.uint8, torch.int8, torch.bool)
_MAX_DIMS = 8


def _header(y):
    """A message's header: dtype code, whether it carries a gradient,
    rank and shape (``_MAX_DIMS`` dimensions at most), as int64."""
    if y.dim() > _MAX_DIMS:
        raise ValueError('a message has at most %d dimensions, got %d'
                         % (_MAX_DIMS, y.dim()))
    h = torch.zeros(3 + _MAX_DIMS, dtype=torch.int64, device=y.device)
    h[:3] = torch.tensor([_DTYPES.index(y.dtype), int(y.requires_grad),
                          y.dim()])
    h[3:3 + y.dim()] = torch.tensor(y.shape, dtype=torch.int64)
    return h


def _template(header, device):
    """Zeros of the header's dtype and shape, carrying a gradient when
    the sender's value does (and autograd is on here)."""
    code, grad, ndim = (int(v) for v in header[:3].tolist())
    shape = [int(v) for v in header[3:3 + ndim].tolist()]
    t = torch.zeros(shape, dtype=_DTYPES[code], device=device)
    return t.requires_grad_(bool(grad) and torch.is_grad_enabled())


class _Broadcast(torch.autograd.Function):
    """A global output: the home rank's value on every rank.  The
    backward gives the home rank its own cotangent and nothing to the
    others' templates: no communication."""

    @staticmethod
    def forward(ctx, x, home, me):
        buf = x.contiguous() if me == home else torch.empty_like(x)
        dist.broadcast(buf, src=home)
        return buf.view_as(buf) if me == home else buf

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class MultiNodeChainList(nn.Module):
    """A DAG of stages with the reference's rank routing.

    Usage::

        model = MultiNodeChainList(comm, spmd=True)
        model.add_link(stage0, rank_in=None, rank_out=1, rank=0)
        model.add_link(stage1, rank_in=0, rank_out=None, rank=1)
        y = model(x)   # every rank calls it with the same inputs

    A stage is a callable ``link(*inputs) -> tensor``; an ``nn.Module``
    stage becomes a submodule (``link_<i>``), so ``model.parameters()``
    holds every stage's.
    """

    def __init__(self, comm=None, place=False, spmd=False):
        super().__init__()
        if spmd and comm is None:
            raise ValueError('spmd=True needs a communicator')
        self._comm = comm
        self._place = place and comm is not None and not spmd
        self._spmd = spmd
        self._links = []

    def add_link(self, link, rank_in=None, rank_out=None, rank=None):
        """Register a stage.

        ``rank_in``: None (reads the global inputs), an int or a list of
        ints -- the ranks of the producer stages, consumed in order.
        ``rank_out``: None (a global output), an int or a list of ints
        -- the ranks of the consumer stages.  ``rank``: the stage's home
        (default: its declaration index).
        """
        if rank is None:
            rank = len(self._links)
        if rank_in is not None and not isinstance(rank_in, (list, tuple)):
            rank_in = [rank_in]
        if rank_out is not None and not isinstance(rank_out, (list, tuple)):
            rank_out = [rank_out]
        if isinstance(link, nn.Module):
            self.add_module('link_%d' % len(self._links), link)
        self._links.append((link, rank, rank_in, rank_out))
        return self

    def __len__(self):
        return len(self._links)

    def _pin(self, x, rank):
        if not self._place or self._comm.device.type != 'cuda':
            return x
        return x.to(torch.device('cuda', rank % torch.cuda.device_count()))

    @staticmethod
    def _inputs(queues, inputs, rank, rank_in):
        if rank_in is None:
            return tuple(inputs)
        xs = []
        for src in rank_in:
            q = queues.get((src, rank))
            if not q:
                raise RuntimeError(
                    'stage at rank %d expects input from rank %d but none '
                    'was sent; check rank_in/rank_out declaration order'
                    % (rank, src))
            xs.append(q.pop(0))
        return tuple(xs)

    @staticmethod
    def _result(queues, outputs):
        leftovers = {k: len(v) for k, v in queues.items() if v}
        if leftovers:
            raise RuntimeError('unconsumed inter-stage messages: %r'
                               % leftovers)
        if not outputs:
            return None
        return outputs[0] if len(outputs) == 1 else tuple(outputs)

    def forward(self, *inputs):
        if self._spmd:
            return self._process_call(inputs)
        queues, outputs = {}, []
        for link, rank, rank_in, rank_out in self._links:
            xs = self._inputs(queues, inputs, rank, rank_in)
            y = link(*(self._pin(x, rank) for x in xs))
            if rank_out is None:
                outputs.append(y)
            else:
                for dst in rank_out:
                    queues.setdefault((rank, dst), []).append(
                        self._pin(y, dst))
        return self._result(queues, outputs)

    def _process_call(self, inputs):
        comm = self._comm
        n, me = comm.size, comm.rank
        queues, outputs, ties = {}, [], []
        for link, rank, rank_in, rank_out in self._links:
            home = rank % n
            # every rank pops, so the queue checks raise on every rank
            xs = self._inputs(queues, inputs, rank, rank_in)
            y = link(*xs) if home == me else None
            if rank_out is None:
                if y is not None:
                    ties.append(y)
                outputs.append(self._emit(y, home, me, n, comm.device))
                continue
            for dst in rank_out:
                to = dst % n
                if to == home:
                    msg = y
                elif me == home:
                    exchange(_header(y), [(home, to)], me)
                    msg = send(y, comm, rank=to, src=home)
                    ties.append(msg)
                elif me == to:
                    header = exchange(
                        torch.zeros(3 + _MAX_DIMS, dtype=torch.int64,
                                    device=comm.device), [(home, to)], me)
                    msg = send(_template(header, comm.device), comm,
                               rank=to, src=home)
                else:
                    msg = None
                queues.setdefault((rank, dst), []).append(msg)
        out = self._result(queues, outputs)
        ties = [t for t in ties if t.requires_grad]
        if not ties or out is None:
            return out
        if isinstance(out, tuple):
            return tuple(pseudo_connect(ties, o) for o in out)
        return pseudo_connect(ties, out)

    @staticmethod
    def _emit(y, home, me, n, device):
        """A global output on every rank: ``y`` on its home, broadcast
        (a header first) to the others."""
        if n == 1:
            return y
        header = (_header(y) if me == home else
                  torch.zeros(3 + _MAX_DIMS, dtype=torch.int64,
                              device=device))
        dist.broadcast(header, src=home)
        x = y if me == home else _template(header, device)
        return _Broadcast.apply(x, home, me)
