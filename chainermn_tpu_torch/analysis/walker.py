"""Graph tracing and traversal for shardlint.

Counterpart of ``chainermn_tpu/analysis/walker.py``, over ``torch.fx``
graphs instead of jaxprs.  A target is traced with ``make_fx(...,
tracing_mode='fake')`` inside a :func:`fake_world`: a ``torch.distributed``
world of the fake backend, whose collectives do nothing, of any size and
rank, in one CPU process.  The graph holds every ATen and ``c10d`` call
the step makes, in program order, with def-use edges: the forward, the
autograd backward, each collective (its process group a torchbind
argument), the optimizer's in-place update.  Nothing is computed:
every tensor is a fake one, shape and dtype only.

Each node a traced callable makes is tagged with the Python frames that
made it (:class:`_SourceMode`, a dispatch mode that runs inside the
trace and puts them where ``make_fx`` copies a node's ``stack_trace``
from).  :func:`node_source` reads the innermost one, and
:func:`in_kernel_layer` tells an op of ``chainermn_tpu_torch/ops/`` (a
kernel's plain version, forward or backward) from the rest.

:func:`annotate_collectives` reads, inside the world, each collective's
process group from its argument and maps its ranks back to the names of
the target's mesh axes (``cmn_ranks`` / ``cmn_axes`` in ``node.meta``);
a p2p node gets its peer's global rank (``cmn_peer``).
"""

import contextlib
import itertools
import operator
import os
import sys

import torch
import torch.distributed as dist
from torch.fx import traceback as fx_traceback
from torch.utils._python_dispatch import TorchDispatchMode

# The tables hold the overloads that the port's communicators,
# ``parallel/`` and ``functions/`` emit, found by tracing every
# ``torch.distributed`` call they make (the port makes no functional
# ``_c10d_functional`` collectives).

#: collectives that REDUCE values over a group (``dist.all_reduce``,
#: ``dist.reduce_scatter_tensor`` / ``reduce_scatter_single``)
REDUCE_OPS = ('c10d.allreduce_', 'c10d._reduce_scatter_base_')
#: the reduce-scatters among them (a scatter's output is a shard, so a
#: chain through one is no redundant re-reduction)
REDUCE_SCATTER_OPS = ('c10d._reduce_scatter_base_',)
#: collectives that MOVE or regather values without reducing
#: (``dist.broadcast``, ``dist.all_gather``, ``all_gather_into_tensor`` /
#: ``all_gather_single``, ``all_to_all_single``), and ``dist.barrier``
MOVE_OPS = ('c10d.broadcast_', 'c10d.allgather_', 'c10d._allgather_base_',
            'c10d.alltoall_base_', 'c10d.barrier')
COLLECTIVE_OPS = REDUCE_OPS + MOVE_OPS
#: point-to-point transfers (every op of ``dist.batch_isend_irecv``)
P2P_OPS = ('c10d.send', 'c10d.recv_')
#: ops that read a device value on the host: ``.item()``, ``bool(t)``,
#: ``float(t)`` and ``.tolist()`` all trace to ``_local_scalar_dense``
HOST_SYNC_OPS = ('aten._local_scalar_dense',)

#: frames of these directories are not the code a node is attributed to
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))
_HERE = os.path.dirname(os.path.abspath(__file__))
_STDLIB = os.path.dirname(os.path.abspath(contextlib.__file__))
#: the kernel layer's directory (its plain versions upcast on purpose)
KERNEL_LAYER_DIR = os.path.join(os.path.dirname(_HERE), 'ops') + os.sep
_REPO = os.path.dirname(os.path.dirname(_HERE))


@contextlib.contextmanager
def fake_world(world_size, rank):
    """A ``torch.distributed`` default group of the fake backend: rank
    ``rank`` of ``world_size`` processes, in this process.  Collectives
    return at once without touching their tensors; ``new_group`` works.
    The store is a ``HashStore`` (the object channel of a communicator
    built inside needs ``add``).  Refuses to start when a default group
    already exists (it would be reused silently otherwise), and destroys
    its own world on exit."""
    if dist.is_initialized():
        raise RuntimeError(
            'fake_world: a default process group already exists (%s, '
            'world of %d); destroy it first'
            % (dist.get_backend(), dist.get_world_size()))
    # importing the module registers the 'fake' backend
    import torch.testing._internal.distributed.fake_pg  # noqa: F401
    dist.init_process_group('fake', store=dist.HashStore(), rank=int(rank),
                            world_size=int(world_size))
    try:
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


_USER_FILE = {}   # co_filename -> its absolute path, or None (not user)


def _user_file(name):
    f = _USER_FILE.get(name, False)
    if f is False:
        f = os.path.abspath(name)
        if (f.startswith(_TORCH_DIR) or f.startswith(_HERE)
                or f.startswith(_STDLIB) or name.startswith('<')):
            f = None
        _USER_FILE[name] = f
    return f


def _user_frames(frame):
    """``(file, line, function)`` of the frames outside torch, the
    standard library and this package, innermost first; then the scope
    of the innermost ``torch.autograd.Function`` ``forward`` /
    ``backward`` among them (``'file:line#id'``, None outside one)."""
    out, scope = [], None
    while frame is not None:
        code = frame.f_code
        f = _user_file(code.co_filename)
        if f is not None:
            out.append((f, frame.f_lineno, code.co_name))
            if (scope is None and code.co_name in ('forward', 'backward')
                    and code.co_varnames[:1] == ('ctx',)):
                scope = '%s:%d#%d' % (f, code.co_firstlineno, id(frame))
        frame = frame.f_back
    return out, scope


#: prefix of the custom-function scope line of a node's ``stack_trace``
_SCOPE = 'Scope '


class _SourceMode(TorchDispatchMode):
    """Tags each op dispatched inside the trace with its user frames:
    the ``stack_trace`` that ``make_fx`` copies onto the node it makes
    (under ``fx_traceback.preserve_node_meta``), plus the scope of the
    custom autograd function it runs in (the counterpart of a JAX
    ``custom_vjp`` sub-jaxpr)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        frames, scope = _user_frames(sys._getframe(1))
        lines = ['File "%s", line %d, in %s\n' % f for f in frames]
        if scope is not None:
            lines.append(_SCOPE + scope + '\n')
        fx_traceback.set_stack_trace(lines)
        try:
            return func(*args, **(kwargs or {}))
        finally:
            fx_traceback.set_stack_trace([])


def trace_graph(fn, args):
    """The ``torch.fx.GraphModule`` of ``fn(*args)``, traced with
    ``make_fx(tracing_mode='fake')``: abstract evaluation only, the
    tensors in ``args`` are replaced by fake ones.  Call it inside a
    :func:`fake_world` when ``fn`` makes collectives."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def run(*a):
        with _SourceMode():
            return fn(*a)

    # a real tensor the step reads without taking it as an argument (a
    # cached template, a constant) becomes a fake constant of the graph
    with fx_traceback.preserve_node_meta():
        return make_fx(run, tracing_mode='fake',
                       _allow_non_fake_inputs=True)(*args)


def op_name(node):
    """``'aten.mm'`` / ``'c10d.allreduce_'`` for an op node (the overload
    dropped); ``None`` for any other node."""
    if node.op != 'call_function':
        return None
    packet = getattr(node.target, 'overloadpacket', None)
    if packet is None:
        return getattr(node.target, '__name__', str(node.target))
    return str(packet)


def iter_nodes(gm):
    """Every ``call_function`` node of the graph, in program order."""
    for node in gm.graph.nodes:
        if node.op == 'call_function':
            yield node


_PASS_THROUGH = (operator.getitem,)


def source_node(arg):
    """The node that made ``arg``: through the ``getitem`` nodes that
    unpack an op's tuple output (a ``c10d`` op returns its tensors and a
    work handle)."""
    while (hasattr(arg, 'op') and arg.op == 'call_function'
           and arg.target in _PASS_THROUGH):
        arg = arg.args[0]
    return arg


def input_nodes(node):
    """The tensor-valued node arguments of ``node`` (lists flattened),
    each resolved with :func:`source_node`."""
    out = []
    for a in itertools.chain(node.args, node.kwargs.values()):
        for item in (a if isinstance(a, (list, tuple)) else (a,)):
            if isinstance(item, torch.fx.Node) and item.op != 'get_attr':
                out.append(source_node(item))
    return out


def producer_map(gm):
    """``{node: [producer op nodes]}``: what computed each op's operands
    (through ``getitem``), the chain rules' lookup."""
    return {node: [p for p in input_nodes(node) if p.op == 'call_function']
            for node in iter_nodes(gm)}


def node_val(node):
    """The fake value of a node (a tensor, a tuple, a scalar, None)."""
    return node.meta.get('val') if isinstance(node, torch.fx.Node) else None


def tensor_bytes(val):
    """Bytes of a (fake) tensor, 0 for anything else."""
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    return 0


def node_bytes(node):
    """The widest tensor among a node's operands and outputs."""
    vals = [node_val(p) for p in input_nodes(node)]
    out = node_val(node)
    vals.extend(out if isinstance(out, (list, tuple)) else (out,))
    flat = []
    for v in vals:
        flat.extend(v if isinstance(v, (list, tuple)) else (v,))
    return max((tensor_bytes(v) for v in flat), default=0)


def operand_bytes(node):
    """The widest tensor operand of a node (a collective's payload)."""
    return max((tensor_bytes(node_val(p)) for p in input_nodes(node)),
               default=0)


def _dtype_of(node):
    val = node_val(node)
    if isinstance(val, (list, tuple)):
        val = val[0] if val else None
    return getattr(val, 'dtype', None)


def conversion(node):
    """``(src dtype, dst dtype)`` of a dtype-changing ``_to_copy`` /
    ``copy_`` node, else None."""
    name = op_name(node)
    ins = input_nodes(node)
    if name == 'aten._to_copy' and ins:
        src, dst = _dtype_of(ins[0]), _dtype_of(node)
    elif name == 'aten.copy_' and len(ins) > 1:
        src, dst = _dtype_of(ins[1]), _dtype_of(ins[0])
    else:
        return None
    if src is None or dst is None or src == dst:
        return None
    return src, dst


def node_frames(node):
    """``[(file, line), ...]`` recorded on a node, innermost first."""
    out = []
    for line in (node.meta.get('stack_trace') or '').splitlines():
        line = line.strip()
        if line.startswith('File "'):
            path, _, rest = line[6:].partition('", line ')
            out.append((path, int(rest.split(',')[0])))
    return out


def node_scope(node):
    """The custom autograd function invocation that made the node
    (``'file:line#id'``), or None: its body is a level of its own, as a
    ``custom_vjp``'s jaxpr is in the JAX walker."""
    for line in (node.meta.get('stack_trace') or '').splitlines():
        if line.startswith(_SCOPE):
            return line[len(_SCOPE):]
    return None


def node_source(node):
    """``"file.py:line"`` of the innermost user frame that made the
    node (relative to the repository when inside it), or ``None``."""
    frames = node_frames(node) if node is not None else []
    if not frames:
        return None
    path, line = frames[0]
    if path.startswith(_REPO + os.sep):
        path = os.path.relpath(path, _REPO)
    return '%s:%d' % (path, line)


def in_kernel_layer(node):
    """True when ``chainermn_tpu_torch/ops/`` made the node: a kernel's
    plain version or its backward (what runs on the CPU in place of the
    hand-written kernel)."""
    return any(f.startswith(KERNEL_LAYER_DIR) for f, _ in node_frames(node))


# ---------------------------------------------------------------------
# process groups -> mesh axes

def _group_of(gm, node):
    """The ``ProcessGroup`` a collective or p2p node runs over."""
    for a in itertools.chain(node.args, node.kwargs.values()):
        if isinstance(a, torch.fx.Node) and a.op == 'get_attr':
            obj = gm
            for part in a.target.split('.'):
                obj = getattr(obj, part)
            kind = getattr(obj, '_type', None)
            if kind is not None and kind().qualified_name().endswith(
                    'ProcessGroup'):
                return dist.ProcessGroup.unbox(obj)
    return None


def node_group_ranks(gm, node):
    """The global ranks of the group a collective or p2p node runs over
    (read inside the world the graph was traced in)."""
    group = _group_of(gm, node)
    if group is None:
        return None
    return tuple(dist.get_process_group_ranks(group))


def mesh_lines(mesh_axes, rank):
    """``{axes: frozenset(ranks)}``: the line (or plane) through
    ``rank`` along every set of the mesh's axes of size > 1 (the axis
    names row-major, as ``parallel.ProcessMesh`` lays them out)."""
    import numpy as np
    names = list(mesh_axes)
    shape = [int(mesh_axes[n]) for n in names]
    ids = np.arange(int(np.prod(shape))).reshape(shape)
    coords = np.unravel_index(int(rank), shape)
    wide = [n for n in names if mesh_axes[n] > 1]
    out = {(): frozenset((int(rank),))}
    for k in range(1, len(wide) + 1):
        for axes in itertools.combinations(wide, k):
            index = tuple(slice(None) if n in axes else c
                          for n, c in zip(names, coords))
            out[axes] = frozenset(int(r) for r in ids[index].reshape(-1))
    return out


def axes_of(ranks, lines):
    """The mesh axes whose line through this rank is exactly ``ranks``
    (``lines`` from :func:`mesh_lines`), or ``None`` when no set of axes
    spans them."""
    want = frozenset(ranks)
    for axes, line in lines.items():
        if line == want:
            return axes
    return None


def annotate_collectives(gm, mesh_axes, rank):
    """Tag every collective and p2p node with ``cmn_ranks`` (the group's
    global ranks), ``cmn_axes`` (the mesh axes the group spans, ``None``
    for a group that is no line of the mesh) and, for p2p,
    ``cmn_peer`` (the peer's global rank) and ``cmn_tag``.  Must run
    inside the world the graph was traced in."""
    lines = mesh_lines(mesh_axes or {}, rank) if mesh_axes else None
    for node in iter_nodes(gm):
        name = op_name(node)
        if name not in COLLECTIVE_OPS and name not in P2P_OPS:
            continue
        ranks = node_group_ranks(gm, node)
        node.meta['cmn_ranks'] = ranks
        node.meta['cmn_axes'] = (axes_of(ranks, lines)
                                 if lines is not None and ranks else None)
        if name in P2P_OPS:
            ints = [a for a in node.args if isinstance(a, int)]
            peer, tag = (ints + [0, 0])[:2]
            node.meta['cmn_peer'] = (ranks[peer] if ranks else peer)
            node.meta['cmn_tag'] = tag


def node_axes(node):
    """The mesh axes a collective node spans (``()`` when unknown)."""
    return tuple(node.meta.get('cmn_axes') or ())


def abstract_signature(args):
    """Hashable signature of a step's arguments: per tensor leaf its
    shape, dtype, ``requires_grad`` and layout, per Python scalar its
    type -- what decides whether two calls take the same graph (a
    captured CUDA graph, an engine's bucket).  Two synthetic steps whose
    signatures differ would retrace or recapture every iteration."""
    sig = []

    def walk(x):
        if isinstance(x, dict):
            for k in sorted(x, key=str):
                walk(x[k])
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            sig.append((tuple(x.shape), str(x.dtype).replace('torch.', ''),
                        bool(x.requires_grad), str(x.layout)))
        else:
            sig.append(('scalar', type(x).__name__))

    walk(args)
    return tuple(sig)
