"""shardlint rules over traced ``torch.fx`` graphs.

Counterpart of ``chainermn_tpu/analysis/rules.py``.  Each rule is a
function ``rule(ctx) -> [Finding, ...]`` over a :class:`RuleContext`
holding every simulated rank's traced graph and the target's declared
topology.  Rule IDs, severities and message shapes are the JAX rules'.
The graph rules run on each rank's graph (a pipeline's stages trace to
different programs); :func:`run_rules` drops a finding that another rank
already raised word for word.

Three JAX rules have no torch meaning and are not rules here
(:data:`NO_TORCH_MEANING`): SL005 and SL012 audit buffer donation, which
torch does not have, and SL015 audits a ``lax.cond`` on ``axis_index``;
a Python branch on the rank leaves no trace in a torch graph, and
SL013's per-rank traces catch that bug class instead.
"""

from chainermn_tpu_torch.analysis import walker
from chainermn_tpu_torch.analysis.findings import (
    Finding, SEV_ERROR, SEV_WARNING)


class RuleContext:
    """Everything a rule may inspect for one lint target.

    Attributes:
      target_name: display name (``"strategy:xla:allreduce_grad"``).
      graphs: ``{rank: GraphModule}`` of the ranks that traced (empty
        when tracing failed), collectives annotated
        (``walker.annotate_collectives``).
      mesh_axes: ``{axis_name: size}`` of the target's process mesh.
      reduction_axes: declared reduce topology (the communicator's
        ``reduction_axes``) of gradient-reduction targets, else None.
      declared_dtypes: dtype names reductions may narrow to (the
        ``declared_reduce_dtypes`` hook); None or empty: none.
      compute_dtype: the dtype name the target declares its compute runs
        in; SL008 audits declared-narrow graphs only.
      overlap_check: run the SL009 overlap audit (train steps only).
      plan_axes: the MeshPlan axes the target declares (SL010 / SL011).
      staged_axes: axes reduced in a deliberate second stage (SL011).
      rank_addressed: ops declared rank-asymmetric (SL013 exempts them).
      exchanges: ``{rank: [[(peer, where), ...], ...]}``: per rank, the
        sends of each run of p2p ops (:func:`exchanges`), for SL002's
        cross-rank half.
      axes_seen: the mesh axes every rank's collectives span, together
        (SL010's dead-axis half).
      rank_streams: ``{rank: [record, ...]}`` collective streams
        (``commcheck.graph_collective_stream``) for SL013.
      p2p_streams: ``{rank: [record, ...]}`` send / recv streams
        (``commcheck.graph_p2p_stream``) for SL014.
      signatures: abstract signatures of two consecutive synthetic steps
        (SL007), or None.
      trace_error: the exception tracing raised, if any;
        ``trace_where`` its innermost user frame (``"file:line"``).

    The runner evaluates the rules twice over: on each rank, a context
    holding that rank's graph alone (the graph rules); then once, a
    context holding no graph but the ranks' summaries (the cross-rank
    halves, SL007, SL013, SL014 and the trace errors).  A rule reads
    what its context holds.
    """

    def __init__(self, target_name, graphs=None, mesh_axes=None,
                 reduction_axes=None, declared_dtypes=None,
                 compute_dtype=None, overlap_check=False, plan_axes=None,
                 staged_axes=None, rank_addressed=None, rank_streams=None,
                 p2p_streams=None, signatures=None, trace_error=None,
                 trace_where=None, exchanges=None, axes_seen=None):
        self.target_name = target_name
        self.graphs = dict(graphs or {})
        self.mesh_axes = dict(mesh_axes or {})
        self.reduction_axes = reduction_axes
        self.declared_dtypes = declared_dtypes
        self.compute_dtype = compute_dtype
        self.overlap_check = overlap_check
        self.plan_axes = tuple(plan_axes) if plan_axes is not None else None
        self.staged_axes = frozenset(staged_axes or ())
        self.rank_addressed = tuple(rank_addressed or ())
        self.rank_streams = rank_streams
        self.p2p_streams = p2p_streams
        self.signatures = signatures
        self.trace_error = trace_error
        self.trace_where = trace_where
        self.exchanges = exchanges
        self.axes_seen = axes_seen

    def finding(self, rule_id, severity, message, node=None, where=None):
        return Finding(rule_id, severity, message, target=self.target_name,
                       where=walker.node_source(node) if node is not None
                       else where)

    def each_graph(self):
        for rank in sorted(self.graphs):
            yield rank, self.graphs[rank]


def _short(name):
    return name.split('.', 1)[-1]


def _is_data_dependent(err):
    """Whether a trace failure is a Python branch on a tensor value."""
    if getattr(err, 'data_dependent', False):
        return True
    msg = str(err)
    return (type(err).__name__ in ('GuardOnDataDependentSymNode',
                                   'DataDependentOutputException')
            or 'data-dependent' in msg or 'data dependent' in msg)


# ---------------------------------------------------------------------
# SL001: every collective's group is a line of the target's mesh and,
# for gradient reductions, the reduce collectives span exactly the
# declared topology.
def rule_axis_topology(ctx):
    out = []
    err = ctx.trace_error
    if err is not None:
        # the port's unbound axis name (parallel.meshplan.bound_mesh)
        if 'is bound by no mesh' in str(err):
            out.append(ctx.finding(
                'SL001', SEV_ERROR,
                'collective references an axis the mesh does not bind: %s'
                % str(err).splitlines()[0], where=ctx.trace_where))
        return out
    for _rank, gm in ctx.each_graph():
        seen = set()
        for node in walker.iter_nodes(gm):
            name = walker.op_name(node)
            if name not in walker.COLLECTIVE_OPS:
                continue
            axes = node.meta.get('cmn_axes')
            if axes is None and ctx.mesh_axes:
                out.append(ctx.finding(
                    'SL001', SEV_ERROR,
                    '%s over the group of ranks %s, which is no line of '
                    'the mesh %s'
                    % (_short(name), list(node.meta.get('cmn_ranks') or ()),
                       ctx.mesh_axes), node))
                continue
            if name in walker.REDUCE_OPS:
                seen.update(axes or ())
        if ctx.reduction_axes is not None:
            declared = set(ctx.reduction_axes)
            if seen != declared:
                out.append(ctx.finding(
                    'SL001', SEV_ERROR,
                    'reduce collectives cover axes %s but the strategy '
                    'declares reduction_axes=%s'
                    % (sorted(seen), sorted(declared))))
    return out


# ---------------------------------------------------------------------
# SL002: each p2p exchange is a permutation: no rank sends to itself,
# and within one exchange (a run of p2p ops, what one
# dist.batch_isend_irecv posts) no two ranks send to the same rank.
def exchanges(gm):
    """``[[(peer, where), ...], ...]``: per run of consecutive p2p nodes
    (what one ``batch_isend_irecv`` posts), its sends' peers and
    sources."""
    runs, cur = [], None
    for node in walker.iter_nodes(gm):
        name = walker.op_name(node)
        if name in walker.P2P_OPS:
            if cur is None:
                cur = []
                runs.append(cur)
            if name == 'c10d.send':
                cur.append((node.meta.get('cmn_peer'),
                            walker.node_source(node)))
        elif node.target not in walker._PASS_THROUGH:
            cur = None
    return runs


def rule_p2p_permutation(ctx):
    out = []
    for rank, gm in ctx.each_graph():
        for run in exchanges(gm):
            for peer, where in run:
                if peer == rank:
                    out.append(ctx.finding(
                        'SL002', SEV_ERROR,
                        'rank %d sends to itself: a p2p send needs another '
                        'rank to post the matching recv' % rank,
                        where=where))
    per_rank = ctx.exchanges or {}
    n = max((len(r) for r in per_rank.values()), default=0)
    for k in range(n):
        dest = {}
        for rank, runs in sorted(per_rank.items()):
            for peer, where in (runs[k] if k < len(runs) else ()):
                dest.setdefault(peer, []).append((rank, where))
        for d, srcs in sorted(dest.items(), key=lambda kv: str(kv[0])):
            if len(srcs) > 1:
                perm = sorted((r, d) for r, _ in srcs)
                out.append(ctx.finding(
                    'SL002', SEV_ERROR,
                    'p2p exchange %d is not a permutation (duplicate '
                    'destination): ranks %s all send to rank %s: %r'
                    % (k, [r for r, _ in srcs], d, perm),
                    where=srcs[0][1]))
    return out


# ---------------------------------------------------------------------
# SL003: redundant collective chains (a reduce of a value already
# reduced over a shared axis, an all_gather of an all_gather over the
# same axes).
_GATHER_OPS = ('c10d._allgather_base_', 'c10d.allgather_')


def _reduce_set():
    return set(walker.REDUCE_OPS) - set(walker.REDUCE_SCATTER_OPS)


def rule_redundant_collectives(ctx):
    out = []
    reduce_set = _reduce_set()
    for _rank, gm in ctx.each_graph():
        producers = walker.producer_map(gm)
        for node in walker.iter_nodes(gm):
            name = walker.op_name(node)
            if name not in walker.COLLECTIVE_OPS:
                continue
            axes = set(walker.node_axes(node))
            for prev in producers.get(node, ()):
                pname = walker.op_name(prev)
                paxes = set(walker.node_axes(prev))
                if name in reduce_set and pname in reduce_set \
                        and axes & paxes:
                    out.append(ctx.finding(
                        'SL003', SEV_WARNING,
                        '%s over %s consumes the output of %s over %s: the '
                        'value is already reduced over the shared axis '
                        '(re-reducing multiplies by axis size or wastes a '
                        'collective)' % (_short(name), sorted(axes),
                                         _short(pname), sorted(paxes)),
                        node))
                elif (name in _GATHER_OPS and pname in _GATHER_OPS
                      and axes == paxes):
                    out.append(ctx.finding(
                        'SL003', SEV_WARNING,
                        'all_gather of an all_gather over the same axis %s: '
                        'the operand is already replicated along it'
                        % sorted(axes), node))
    return out


# ---------------------------------------------------------------------
# SL004: a reduction must not run in a narrower dtype than its input
# (a bf16 all_reduce of f32 gradients loses mantissa on the wire) --
# unless the narrowed dtype is one the target DECLARES (a policy's
# reduce / compute dtype, a communicator built with reduce_dtype).

#: ops that move or repack a value without computing on it: a narrowing
#: conversion reaches a collective through these (the pack into one flat
#: buffer)
PLUMBING_OPS = frozenset((
    'aten.view', 'aten._unsafe_view', 'aten.reshape', 'aten.t',
    'aten.transpose', 'aten.permute', 'aten.expand', 'aten.squeeze',
    'aten.unsqueeze', 'aten.slice', 'aten.select', 'aten.cat',
    'aten.clone', 'aten.contiguous', 'aten.detach', 'aten.alias',
    'aten.flatten', 'aten.split', 'aten.split_with_sizes', 'aten.unbind',
    'aten.copy_', 'aten.copy', 'aten._to_copy', 'aten.constant_pad_nd',
    'aten.slice_scatter', 'aten.as_strided', 'aten.lift_fresh_copy'))


def _dtype_name(dtype):
    return str(dtype).replace('torch.', '')


def rule_reduction_dtype(ctx):
    out = []
    allowed = set(ctx.declared_dtypes or ())
    if ctx.compute_dtype is not None:
        allowed.add(str(ctx.compute_dtype))
    for _rank, gm in ctx.each_graph():
        for node in walker.iter_nodes(gm):
            if walker.op_name(node) not in walker.REDUCE_OPS:
                continue
            seen, todo = set(), list(walker.input_nodes(node))
            while todo:
                prev = todo.pop()
                if prev in seen or prev.op != 'call_function':
                    continue
                seen.add(prev)
                conv = walker.conversion(prev)
                if conv is not None:
                    src, dst = conv
                    narrow = src.itemsize > dst.itemsize
                    if narrow and _dtype_name(dst) not in allowed:
                        out.append(ctx.finding(
                            'SL004', SEV_ERROR,
                            '%s executes in %s on a value narrowed from %s '
                            'immediately before the collective: the '
                            'reduction loses precision on the wire '
                            "(declare an intentional reduce dtype via the "
                            "strategy's reduce_dtype or the updater's "
                            'policy)' % (_short(walker.op_name(node)),
                                         _dtype_name(dst), _dtype_name(src)),
                            node))
                    continue
                if walker.op_name(prev) in PLUMBING_OPS:
                    todo.extend(walker.input_nodes(prev))
    return out


# ---------------------------------------------------------------------
# SL006: no host round-trips inside the step: a device value read on
# the host (.item(), bool(t), float(t), .tolist() -- _local_scalar_dense
# in the graph), or a data-dependent Python branch that stopped the
# trace.
def rule_host_sync(ctx):
    out = []
    err = ctx.trace_error
    if err is not None and _is_data_dependent(err):
        out.append(ctx.finding(
            'SL006', SEV_ERROR,
            'data-dependent host read inside the step: Python control flow '
            'on a tensor value (%s) stalls the device on a host round-trip '
            'every call and cannot be captured in a CUDA graph'
            % type(err).__name__, where=ctx.trace_where))
    for _rank, gm in ctx.each_graph():
        for node in walker.iter_nodes(gm):
            if walker.op_name(node) in walker.HOST_SYNC_OPS:
                out.append(ctx.finding(
                    'SL006', SEV_ERROR,
                    '%s inside the step (.item() / bool() / float() / '
                    '.tolist() of a tensor): every call stalls the device '
                    'on a host round-trip' % _short(walker.op_name(node)),
                    node))
    return out


# ---------------------------------------------------------------------
# SL007: abstract signature stable across consecutive synthetic steps
# (a shape, dtype or Python-scalar drift retraces / recaptures every
# call).
def rule_recompilation(ctx):
    sigs = ctx.signatures
    if not sigs or len(sigs) < 2:
        return []
    first = sigs[0]
    for step, sig in enumerate(sigs[1:], start=1):
        if sig == first:
            continue
        detail = 'argument count changed (%d vs %d)' % (len(first), len(sig))
        for i, (a, b) in enumerate(zip(first, sig)):
            if a != b:
                detail = 'argument leaf %d changed: %s vs %s' % (i, a, b)
                break
        return [ctx.finding(
            'SL007', SEV_ERROR,
            'abstract step signature differs between synthetic iterations '
            '1 and %d -- a captured step retraces every call (%s)'
            % (step + 1, detail))]
    return []


# ---------------------------------------------------------------------
# SL008: no f32-materialized activation-sized intermediates inside a
# declared-narrow (bf16/f16) compute graph, outside the kernel layer
# (chainermn_tpu_torch/ops/: on the CPU the kernels' plain versions run
# in their place and upcast on purpose).  WARNING: the chase list.
def rule_f32_materialization(ctx):
    from chainermn_tpu_torch.analysis import memtraffic

    out = []
    if ctx.compute_dtype is None:
        return out
    if str(ctx.compute_dtype) not in memtraffic.NARROW_DTYPES:
        return out
    for _rank, gm in ctx.each_graph():
        for node, nbytes in memtraffic.f32_materializations(gm):
            src, dst = walker.conversion(node)
            out.append(ctx.finding(
                'SL008', SEV_WARNING,
                '%s%s upcast to %s materialized (%.2f MB) in a declared-%s '
                'compute graph: activation-sized f32 intermediates are the '
                'memory-traffic excess the fused kernel path '
                '(fused_norm=True / ops.batch_norm_act) removes'
                % (_dtype_name(src), list(walker.node_val(node).shape),
                   _dtype_name(dst), nbytes / 1e6, ctx.compute_dtype), node))
    return out


# ---------------------------------------------------------------------
# SL009: a gradient-sized reduce collective must be schedulable before
# its last consumer: the graph must hold work that neither feeds the
# collective nor consumes its result.  A step whose whole reduction is
# one fused buffer serializes as full backward -> pack -> ONE collective
# -> unpack -> optimizer, and its wire time is exposed.  The bucketed
# strategy with >= 2 buckets is the clean state.  Step targets only;
# WARNING by design.

#: data movement / dtype plumbing that cannot hide a collective
_SL009_TRIVIAL = PLUMBING_OPS | frozenset((
    'aten.zeros', 'aten.zeros_like', 'aten.empty', 'aten.empty_like',
    'aten.new_zeros', 'aten.new_empty', 'aten.fill_', 'aten.full',
    'getitem', 'profiler._record_function_enter_new',
    'profiler._record_function_exit'))
#: audit only reductions moving at least this many bytes
_SL009_MIN_BYTES = 4096
#: the graph must hold at least this much other substantial work
_SL009_MIN_LEVEL_WORK = 3


def _sl009_work_floor(nbytes):
    """Bytes a node must touch to count as work that could hide a
    collective of ``nbytes``: 1/64th of it, floored at 512 B."""
    return max(512, nbytes // 64)


def rule_collective_overlap(ctx):
    out = []
    if not ctx.overlap_check:
        return out
    for _rank, gm in ctx.each_graph():
        # the graph is flat where a jaxpr nests: the nodes of one custom
        # autograd function's call (a Megatron psum's forward) form a
        # level of their own, as a custom_vjp's jaxpr does
        levels = {}
        for node in walker.iter_nodes(gm):
            levels.setdefault(walker.node_scope(node), []).append(node)
        for nodes in levels.values():
            out.extend(_overlap_level(ctx, nodes))
    return out


def _overlap_level(ctx, nodes):
    """SL009 over one level's nodes (program order)."""
    out = []
    n = len(nodes)
    if n < 2:
        return out
    index = {node: i for i, node in enumerate(nodes)}
    anc = [0] * n
    consumers = [[] for _ in range(n)]
    for i, node in enumerate(nodes):
        mask = 0
        for p in walker.input_nodes(node):
            j = index.get(p)
            if j is not None:
                mask |= anc[j] | (1 << j)
                consumers[j].append(i)
        anc[i] = mask
    desc = [0] * n
    for i in range(n - 1, -1, -1):
        mask = 0
        for j in consumers[i]:
            mask |= desc[j] | (1 << j)
        desc[i] = mask
    sizes = [walker.node_bytes(node) for node in nodes]
    nontrivial = [(i, sizes[i]) for i, node in enumerate(nodes)
                  if walker.op_name(node) not in _SL009_TRIVIAL]
    reduces = [i for i, node in enumerate(nodes)
               if walker.op_name(node) in walker.REDUCE_OPS
               and walker.node_axes(node) and sizes[i] >= 512]
    for i in reduces:
        nbytes = walker.operand_bytes(nodes[i])
        if nbytes < _SL009_MIN_BYTES:
            continue
        related = anc[i] | desc[i]
        # a SIBLING reduce neither feeding nor consuming this one is what
        # bucketed / per-leaf strategies create
        if any(j != i and not (related >> j) & 1 for j in reduces):
            continue
        floor = _sl009_work_floor(nbytes)
        big_rest = [j for j, b in nontrivial if j != i and b >= floor]
        if len(big_rest) < _SL009_MIN_LEVEL_WORK:
            continue  # tiny helper level, nothing to judge
        out.append(ctx.finding(
            'SL009', SEV_WARNING,
            '%s of %.1f KB is the ONLY schedulable reduce at its program '
            'level: every gradient must exist before the fused collective '
            'starts and its %d consumers-and-producers serialize around '
            'it, so its wire time is exposed in the step.  Split the '
            'reduction into buckets issued as gradients complete (the '
            "'bucketed' strategy with bucket_mb sized for >= 2 buckets) so "
            'each collective overlaps the remaining backward/optimizer work'
            % (_short(walker.op_name(nodes[i])), nbytes / 1e3,
               len(big_rest)), nodes[i]))
    return out


# ---------------------------------------------------------------------
# SL010: plan-axis discipline (targets declaring MeshPlan axes): every
# collective acts over declared plan axes only, and every declared axis
# of size > 1 is combined by at least one collective.
def axes_seen(gm, mesh_axes):
    """The mesh axes the graph's collectives span."""
    seen = set()
    for node in walker.iter_nodes(gm):
        if walker.op_name(node) in walker.COLLECTIVE_OPS:
            seen.update(a for a in walker.node_axes(node) if a in mesh_axes)
    return seen


def rule_plan_axis_coverage(ctx):
    out = []
    if ctx.plan_axes is None:
        return out
    declared = set(ctx.plan_axes)
    for _rank, gm in ctx.each_graph():
        for node in walker.iter_nodes(gm):
            name = walker.op_name(node)
            if name not in walker.COLLECTIVE_OPS:
                continue
            stray = [a for a in walker.node_axes(node)
                     if a in ctx.mesh_axes and a not in declared]
            if stray:
                out.append(ctx.finding(
                    'SL010', SEV_ERROR,
                    '%s over axis %s outside the declared plan axes %s: a '
                    'collective crossing an undeclared axis combines values '
                    'the plan lays out as distinct shards'
                    % (_short(name), sorted(stray), sorted(declared)), node))
    if ctx.axes_seen is None:
        return out
    for ax in sorted(declared):
        if ctx.mesh_axes.get(ax, 1) > 1 and ax not in ctx.axes_seen:
            out.append(ctx.finding(
                'SL010', SEV_ERROR,
                'declared plan axis %r (size %d) is never touched by any '
                'collective: the axis shards data/weights but no '
                'computation ever combines along it (dead axis -- drop it '
                'from the plan or wire its collectives)'
                % (ax, ctx.mesh_axes[ax])))
    return out


# ---------------------------------------------------------------------
# SL011: a reduce over one plan axis feeding directly into a reduce
# over a DISJOINT axis: one reduce over the union moves the same bytes
# in one collective.  Plan targets only; a chain whose either stage
# reduces purely over declared staging axes is the intended split.
def rule_cross_axis_chain(ctx):
    out = []
    if ctx.plan_axes is None:
        return out
    reduce_set = _reduce_set()
    for _rank, gm in ctx.each_graph():
        producers = walker.producer_map(gm)
        for node in walker.iter_nodes(gm):
            name = walker.op_name(node)
            if name not in reduce_set:
                continue
            axes = set(walker.node_axes(node))
            if not axes:
                continue
            for prev in producers.get(node, ()):
                pname = walker.op_name(prev)
                if pname not in reduce_set:
                    continue
                paxes = set(walker.node_axes(prev))
                if not paxes or axes & paxes:
                    continue
                if ctx.staged_axes and (axes <= ctx.staged_axes
                                        or paxes <= ctx.staged_axes):
                    continue
                out.append(ctx.finding(
                    'SL011', SEV_WARNING,
                    '%s over %s directly consumes %s over %s: consecutive '
                    'reductions over disjoint plan axes serialize two '
                    'collective launches where one %s over %s moves the '
                    'same bytes once'
                    % (_short(name), sorted(axes), _short(pname),
                       sorted(paxes), _short(name), sorted(axes | paxes)),
                    node))
    return out


# ---------------------------------------------------------------------
# SL013: rank-divergent collective sequence.  Every rank is traced on
# its own, so a Python branch on the rank shows directly; the streams
# of each process group are compared among its members
# (commcheck.verify_group_streams, the core the doctor replays captures
# through too).
def rule_rank_divergence(ctx):
    if not ctx.rank_streams:
        return []
    from chainermn_tpu_torch.analysis import commcheck
    div = commcheck.verify_group_streams(ctx.rank_streams,
                                         rank_addressed=ctx.rank_addressed)
    if div is None:
        return []
    return [ctx.finding(
        'SL013', SEV_ERROR,
        'rank-divergent collective sequence at %s -- every rank must issue '
        'the same collectives in the same order or the job wedges at the '
        'first unmatched rendezvous' % div['summary'])]


# ---------------------------------------------------------------------
# SL014: p2p match + deadlock: the wait-for matcher over every rank's
# traced send / recv stream (unmatched send or recv, a cycle of blocking
# recvs) -- the ring's repeated exchanges and the pipeline's ticks
# included, so a broken multi-step chain shows as an undelivered
# message.
def rule_p2p_deadlock(ctx):
    from chainermn_tpu_torch.analysis import commcheck
    streams = ctx.p2p_streams
    if not streams or not any(streams.values()):
        return []
    return [ctx.finding('SL014', SEV_ERROR, item['message'])
            for item in commcheck.match_p2p(streams)]


#: rule id -> (callable, one-line description)
RULES = {
    'SL001': (rule_axis_topology,
              'every collective runs over a line of the mesh and reduce '
              'collectives match the declared reduction topology'),
    'SL002': (rule_p2p_permutation,
              'each p2p exchange is a permutation (no self-send, no two '
              'ranks sending to one rank in one exchange)'),
    'SL003': (rule_redundant_collectives,
              'no redundant collective chains (reduce-of-reduce, '
              'gather-of-gather)'),
    'SL004': (rule_reduction_dtype,
              'reductions do not execute in a narrower dtype than their '
              'inputs'),
    'SL006': (rule_host_sync,
              'no host round-trips (.item(), data-dependent branches) '
              'inside the step'),
    'SL007': (rule_recompilation,
              'abstract step signature is stable across iterations (no '
              'retrace leak)'),
    'SL008': (rule_f32_materialization,
              'no f32-materialized activation-sized intermediates inside '
              'declared-bf16/f16 compute graphs (outside the kernel layer)'),
    'SL009': (rule_collective_overlap,
              'gradient-sized reduce collectives are schedulable before '
              'their last consumer (independent work exists to overlap '
              'them with; step targets only)'),
    'SL010': (rule_plan_axis_coverage,
              'composed-mesh targets: collectives act over declared plan '
              'axes only, and every declared axis of size > 1 is combined '
              'by at least one collective'),
    'SL011': (rule_cross_axis_chain,
              'no reduce-feeding-reduce chains over disjoint plan axes '
              '(one multi-axis collective moves the same bytes once)'),
    'SL013': (rule_rank_divergence,
              'per-rank collective streams are identical within each '
              'process group up to declared rank-addressed ops (every '
              '(world_size, rank) traced; the doctor replays captures '
              'through the same core)'),
    'SL014': (rule_p2p_deadlock,
              'send/recv streams match without unmatched messages or '
              'blocking-op cycles, repeated exchanges included'),
}

#: the JAX rules with no torch meaning, and why (listed by
#: ``--list-rules``; never faked as rules)
NO_TORCH_MEANING = {
    'SL005': 'donated buffers are consumed and can alias an output: torch '
             'has no buffer donation (an optimizer updates its tensors in '
             'place)',
    'SL012': 'donated plan-sharded buffers alias an output of the same '
             'sharding: no donation, and a process holds its shard as a '
             'plain tensor',
    'SL015': 'no collective under lax.cond on axis_index: a Python branch '
             'on the rank leaves no trace in a torch graph; SL013 traces '
             'every rank on its own and catches that bug class instead',
}


def run_rules(ctx, only=None):
    """Every rule (or the ``only`` subset) over one context; a finding
    another rank's graph already raised word for word is dropped."""
    findings, seen = [], set()
    for rule_id, (fn, _desc) in sorted(RULES.items()):
        if only is not None and rule_id not in only:
            continue
        for f in fn(ctx):
            key = (f.rule_id, f.severity, f.message)
            if key not in seen:
                seen.add(key)
                findings.append(f)
    return findings
