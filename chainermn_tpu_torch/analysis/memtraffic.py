"""Memory-traffic audit of traced steps.

Counterpart of ``chainermn_tpu/analysis/memtraffic.py``.  Two views of
one lint target's traffic, both static (nothing runs):

1. **cost** (:func:`cost_summary`): FLOPs counted by
   ``torch.utils.flop_counter``'s formulas over the traced graph's ops
   (their recorded fake values), and the graph's bytes accessed -- every
   op's operands and outputs, unfused -- divided down to bytes per item
   when the target declares an item count.  XLA's ``cost_analysis()``
   has no torch counterpart: the row names the keys it lacks
   (``cost_lacks``).
2. **materialization pressure** (:func:`graph_traffic`, the JAX
   ``jaxpr_traffic``): the bytes of every intermediate the step writes,
   the top-k widest, and -- the SL008 quantity -- the f32
   upcast-materialized intermediates of a declared-narrow graph:
   conversions widening a >= ``min_bytes`` tensor outside the kernel
   layer (``chainermn_tpu_torch/ops/``, whose plain versions stand in
   for the kernels on the CPU), master-weight-shaped gradient upcasts
   exempt.

The CLI attaches a ``memtraffic`` section to the report; rule SL008
flags each f32 materialization as a warning.
"""

from chainermn_tpu_torch.analysis import walker

#: an intermediate at least this big counts as activation-sized
SL008_MIN_BYTES = 16 * 1024

#: narrow compute dtypes whose graphs the f32 audit applies to
NARROW_DTYPES = ('bfloat16', 'float16')

#: what XLA's cost analysis reports that this audit cannot
COST_LACKS = ('bytes accessed after fusion', 'transcendentals',
              'optimal_seconds', 'utilization')


def collective_bytes_by_axis(gm):
    """Bytes each mesh axis's collectives move in one traced step of one
    rank, keyed by the axes (``'data'``, ``'inter,intra'``): per
    collective node its widest operand, summed per key."""
    out = {}
    for node in walker.iter_nodes(gm):
        if walker.op_name(node) not in walker.COLLECTIVE_OPS:
            continue
        axes = walker.node_axes(node)
        if not axes:
            continue
        key = ','.join(axes)
        out[key] = out.get(key, 0) + walker.operand_bytes(node)
    return out


def param_shapes(gm):
    """Shapes of the traced step's own float32 inputs (parameters,
    optimizer state, batch).  A widening conversion whose OUTPUT matches
    one of these is the master-weight pattern (a bf16 gradient upcast
    back to its f32 master), not an activation materialization."""
    import torch
    out = set()
    for node in gm.graph.nodes:
        val = walker.node_val(node)
        if node.op == 'placeholder' and isinstance(val, torch.Tensor) \
                and val.dtype == torch.float32:
            out.add(tuple(val.shape))
    return out


def f32_materializations(gm, min_bytes=SL008_MIN_BYTES):
    """``(node, bytes)`` for every conversion (``_to_copy`` / ``copy_``)
    widening a >= ``min_bytes`` tensor outside the kernel layer,
    master-weight-shaped outputs exempt."""
    out = []
    exempt = param_shapes(gm)
    for node in walker.iter_nodes(gm):
        conv = walker.conversion(node)
        if conv is None or conv[1].itemsize <= conv[0].itemsize:
            continue
        val = walker.node_val(node)
        nbytes = walker.tensor_bytes(val)
        if nbytes < min_bytes or tuple(val.shape) in exempt:
            continue
        if walker.in_kernel_layer(node):
            continue
        out.append((node, nbytes))
    return out


def graph_traffic(gm, top_k=8, min_bytes=SL008_MIN_BYTES):
    """Static materialization-pressure summary of one traced step."""
    inter, widest = 0, []
    for node in walker.iter_nodes(gm):
        val = walker.node_val(node)
        for v in (val if isinstance(val, (list, tuple)) else (val,)):
            b = walker.tensor_bytes(v)
            inter += b
            if b >= min_bytes:
                widest.append((b, node, v))
    widest.sort(key=lambda t: -t[0])
    top = [{'bytes': b, 'op': walker.op_name(node),
            'shape': list(v.shape),
            'dtype': str(v.dtype).replace('torch.', ''),
            'where': walker.node_source(node)}
           for b, node, v in widest[:top_k]]
    mats = f32_materializations(gm, min_bytes=min_bytes)
    return {'graph_intermediate_bytes': int(inter),
            'top_intermediates': top,
            'f32_materialized_bytes': int(sum(b for _, b in mats)),
            'f32_materialized_count': len(mats),
            'collective_bytes_by_axis': collective_bytes_by_axis(gm)}


def cost_summary(gm):
    """``{'flops', 'bytes_accessed', 'cost_lacks'}`` of one traced graph,
    or ``{'cost_error': ...}``.  The FLOPs are
    ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s own)
    over each op's recorded fake operands and result: nothing is
    replayed."""
    import torch
    from torch.utils.flop_counter import flop_registry
    try:
        flops = 0
        for node in walker.iter_nodes(gm):
            count = flop_registry.get(getattr(node.target, '_overloadpacket',
                                              None))
            if count is not None:
                args, kwargs = torch.fx.node.map_arg(
                    (node.args, node.kwargs), walker.node_val)
                flops += count(*args, **kwargs,
                               out_val=walker.node_val(node))
        flops = float(flops)
    except Exception as e:  # never kill the sweep
        return {'cost_error': '%s: %s' % (
            type(e).__name__, str(e).splitlines()[0] if str(e) else '')}
    nbytes = 0
    for node in walker.iter_nodes(gm):
        val = walker.node_val(node)
        outs = val if isinstance(val, (list, tuple)) else (val,)
        nbytes += sum(walker.tensor_bytes(walker.node_val(p))
                      for p in walker.input_nodes(node))
        nbytes += sum(walker.tensor_bytes(v) for v in outs)
    return {'flops': flops, 'bytes_accessed': float(nbytes),
            'cost_lacks': list(COST_LACKS)}


def audit_graph(target, gm, top_k=8, compile_costs=True):
    """One memtraffic report row from a traced, annotated graph of
    ``target`` (call it inside the world it was traced in)."""
    row = {'target': target.name}
    row.update(graph_traffic(gm, top_k=top_k))
    if compile_costs:
        row.update(cost_summary(gm))
    items = getattr(target, 'items', None)
    if items and row.get('bytes_accessed'):
        row['items_per_step'] = items
        row['bytes_per_item'] = round(row['bytes_accessed'] / items, 1)
    return row


def audit_target(target, top_k=8, compile_costs=True):
    """One memtraffic report row for one ``LintTarget``, from rank 0's
    trace."""
    with walker.fake_world(target.world_size, 0):
        try:
            built = target.build(0)
            gm = walker.trace_graph(built.fn, built.args)
        except Exception as e:
            return {'target': target.name, 'trace_error': '%s: %s' % (
                type(e).__name__, str(e).splitlines()[0] if str(e) else '')}
        walker.annotate_collectives(
            gm, built.declared.get('mesh_axes', target.mesh_axes), 0)
        return audit_graph(target, gm, top_k, compile_costs)


def report(targets, top_k=8, compile_costs=True, progress=None):
    """Memtraffic rows for every target (the CLI's ``memtraffic``
    section)."""
    rows = []
    for target in targets:
        if progress is not None:
            progress('memtraffic:%s' % target.name)
        rows.append(audit_target(target, top_k=top_k,
                                 compile_costs=compile_costs))
    return rows
