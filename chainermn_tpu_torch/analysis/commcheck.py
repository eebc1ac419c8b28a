"""Cross-rank communication verification (the SL013 / SL014 core).

Counterpart of ``chainermn_tpu/analysis/commcheck.py``.  Its first half
imports no framework and is the JAX module's code: :func:`verify_streams`
compares per-rank collective streams position by position and names the
first divergence (the Python ``if rank == k: all_reduce()`` bug that
wedges a job at step N); :func:`match_p2p` runs a wait-for-graph matcher
over per-rank send / recv / barrier streams (unmatched send or recv, a
key collision, a cycle of blocking ops); :func:`check_ppermute_chain`
checks that a repeated permutation delivers to every rank;
:func:`simulate_1f1b_streams` and :func:`reference_protocol` feed them.
The telemetry doctor (``telemetry/diagnosis.py``) replays recorded spans
through the same :func:`verify_streams`, so the static and the run-time
verdicts cannot drift apart.

The second half reads the streams off traced graphs.  Each simulated
rank is traced on its own (``walker.fake_world``), so a rank branch in
Python shows directly as diverging per-rank streams -- the JAX rule
compares one replicated SPMD stream.  A collective over a sub-group is
compared among that group's members only (:func:`verify_group_streams`),
and the p2p nodes (``c10d.send`` / ``recv_``, what
``dist.batch_isend_irecv`` traces to) become :func:`match_p2p` streams
(:func:`graph_p2p_stream`).  :func:`run_commcheck` is the sweep the CLI
runs: every strategy traced at world sizes {2, 3, 4}, every rank; the
reference eager protocol through the recording communicator; the 1F1B
handoff chain for representative micro-batch counts.
"""

from chainermn_tpu_torch.analysis import walker
from chainermn_tpu_torch.analysis.findings import Finding, SEV_ERROR
from chainermn_tpu_torch.communicators.recording import (  # noqa: F401
    P2P_KEY_FMT, RecordingCommunicator, simulate_protocol)

#: the default simulated world sizes
WORLD_SIZES = (2, 3, 4)
#: representative micro-batch counts for the 1F1B handoff composition
MICRO_COUNTS = (1, 2, 4, 8)
#: the ops a stream record may name for a send / a blocking receive
SEND_OPS = ('send_obj', 'send')
RECV_OPS = ('recv_obj', 'recv')


# ---------------------------------------------------------------------
# stream comparison (SL013 core == the doctor's replay core)

def _sig(rec):
    """Hashable signature of one stream record: ``(op, tag, seq)``."""
    return (rec.get('op'), rec.get('tag'), rec.get('seq'))


def render_sig(sig):
    """``'barrier[setup]#1'`` / ``'psum#0'`` -- compact op rendering
    for divergence transcripts."""
    if sig is None:
        return '<ended>'
    op, tag, seq = sig
    if tag is not None:
        return '%s[%s]#%s' % (op, tag, seq)
    return '%s#%s' % (op, seq)


def verify_streams(streams, rank_addressed=(), context=2):
    """First divergence between per-rank collective streams, or None.

    ``streams`` is ``{rank: [record, ...]}`` where each record carries
    at least ``op`` (plus optional ``tag`` / ``seq`` / ``kind``).
    p2p records (``kind == 'p2p'``) and ops in ``rank_addressed`` are
    excluded -- those are DECLARED rank-asymmetric; everything else
    must be identical across ranks position by position (bulk-
    synchronous program order).

    Returns ``None`` when the streams agree, else::

        {'position': i, 'kind': 'mismatch' | 'truncated',
         'ranks': {rank: {'op': str | None, 'context': [str, ...]}},
         'summary': one-line transcript}

    where each rank's ``context`` is its +-``context`` ops around the
    divergent position.  This function is the SHARED core: the static
    SL013 rule feeds it simulated and traced streams, the telemetry
    doctor's protocol-divergence verdict feeds it recorded spans.
    """
    ranks = sorted(streams)
    if len(ranks) < 2:
        return None
    excl = set(rank_addressed or ())
    sigs = {}
    for r in ranks:
        sigs[r] = [_sig(rec) for rec in streams[r]
                   if rec.get('kind') != 'p2p'
                   and rec.get('op') not in excl]
    length = max(len(s) for s in sigs.values())
    for i in range(length):
        at = {r: (sigs[r][i] if i < len(sigs[r]) else None)
              for r in ranks}
        if len(set(at.values())) <= 1:
            continue
        kind = ('truncated' if any(v is None for v in at.values())
                else 'mismatch')
        per_rank = {}
        for r in ranks:
            lo = max(0, i - context)
            per_rank[r] = {
                'op': render_sig(at[r]) if at[r] is not None else None,
                'context': [render_sig(s)
                            for s in sigs[r][lo:i + context + 1]]}
        summary = ('position %d: %s' % (i, '; '.join(
            'rank %d issues %s' % (r, render_sig(at[r]))
            for r in ranks)))
        return {'position': i, 'kind': kind, 'ranks': per_rank,
                'summary': summary}
    return None


# ---------------------------------------------------------------------
# p2p/barrier wait-for matcher (SL014 core)

def _find_cycle(waits):
    """One cycle (list of ranks) in a wait-for graph, or None."""
    color, stack = {}, []

    def dfs(u):
        color[u] = 1
        stack.append(u)
        for v in waits.get(u, ()):
            if v not in waits:
                continue
            if color.get(v) == 1:
                return stack[stack.index(v):]
            if not color.get(v):
                got = dfs(v)
                if got:
                    return got
        color[u] = 2
        stack.pop()
        return None

    for u in sorted(waits):
        if not color.get(u):
            got = dfs(u)
            if got:
                return got
    return None


def _describe(rec):
    if rec is None:
        return '<done>'
    if rec.get('kind') == 'p2p':
        return '%s(peer=%s, tag=%s, seq=%s)' % (
            rec.get('op'), rec.get('peer'), rec.get('tag'),
            rec.get('seq'))
    return render_sig(_sig(rec))


def match_p2p(streams):
    """Match per-rank eager op streams; return protocol findings.

    Models the object channel's semantics (``communicators/base.py``):
    ``send_obj`` publishes to the store and returns (buffered,
    non-blocking), ``recv_obj`` blocks until its exact key
    ``(channel, src, dest, tag, seq)`` exists, ``barrier`` and
    rendezvous collectives (``allreduce_obj``) block until EVERY rank
    arrives at the same ``(op, tag, seq)``; ``broadcast_data`` is a
    local replicate, never a blocking rendezvous.

    Findings (list of dicts with ``kind`` / ``ranks`` / ``message``):

    * ``tag_collision`` -- a send re-publishes a key whose earlier
      message is still unconsumed (the rebuilt-communicator seq-0
      hazard of a communicator rebuilt over a live channel).
    * ``deadlock`` -- a cycle of blocked ops, each rank and its
      blocking op named.
    * ``unmatched_recv`` -- a recv whose sender already exited its
      stream: the message can never arrive.
    * ``exited_collective`` -- a rank waits at a rendezvous a peer
      has already run past the end of its stream.
    * ``unmatched_send`` -- the run completes but published messages
      were never consumed.
    """
    ranks = sorted(streams)
    findings = []
    if len(ranks) < 2:
        return findings
    ptr = {r: 0 for r in ranks}
    mailbox = {}  # undelivered key -> sender rank
    published = {}  # every key ever published -> first sender rank

    def head(r):
        s = streams[r]
        return s[ptr[r]] if ptr[r] < len(s) else None

    progress = True
    while progress:
        progress = False
        for r in ranks:
            rec = head(r)
            if rec is None:
                continue
            op = rec.get('op')
            if op in SEND_OPS:
                key = rec.get('key')
                if key in published:
                    findings.append({
                        'kind': 'tag_collision',
                        'ranks': sorted({published[key], r}),
                        'message':
                            'p2p key collision: rank %d re-publishes '
                            '%s -- two sends race on one wire key, '
                            'so the receiver reads whichever landed '
                            'last (a communicator rebuilt over a '
                            'live channel restarts at seq 0; '
                            'segregate with a distinct channel)'
                            % (r, key)})
                else:
                    published[key] = r
                mailbox[key] = r
                ptr[r] += 1
                progress = True
            elif op in RECV_OPS:
                key = rec.get('key')
                if key in mailbox:
                    del mailbox[key]
                    ptr[r] += 1
                    progress = True
            elif (rec.get('kind') == 'collective'
                  and op != 'broadcast_data'):
                want = _sig(rec)
                arrived = all(
                    head(q) is not None
                    and head(q).get('kind') == 'collective'
                    and _sig(head(q)) == want for q in ranks)
                if arrived:
                    for q in ranks:
                        ptr[q] += 1
                    progress = True
            else:
                # unknown / local op: never blocks
                ptr[r] += 1
                progress = True

    blocked = [r for r in ranks if head(r) is not None]
    if not blocked:
        for key, sender in sorted(mailbox.items()):
            bits = key.split('/')
            findings.append({
                'kind': 'unmatched_send',
                'ranks': [sender, int(bits[-3])],
                'message':
                    'unmatched send: rank %s published %s (dest rank '
                    '%s, tag %s, seq %s) but no recv ever consumes it'
                    % (bits[-4], key, bits[-3], bits[-2], bits[-1])})
        return findings

    waits = {}
    for r in blocked:
        rec = head(r)
        if rec.get('op') in RECV_OPS:
            waits[r] = [rec.get('peer')]
        else:
            want = _sig(rec)
            waits[r] = [q for q in ranks if q != r
                        and (head(q) is None
                             or head(q).get('kind') != 'collective'
                             or _sig(head(q)) != want)]
    cycle = _find_cycle(waits)
    reported = set()
    if cycle:
        reported.update(cycle)
        findings.append({
            'kind': 'deadlock', 'ranks': list(cycle),
            'message': 'deadlock: cycle of blocking ops -- %s'
                       % '; '.join('rank %d blocked at %s'
                                   % (r, _describe(head(r)))
                                   for r in cycle)})
    for r in blocked:
        if r in reported:
            continue
        rec = head(r)
        if rec.get('op') in RECV_OPS:
            peer = rec.get('peer')
            if peer not in streams or head(peer) is None:
                findings.append({
                    'kind': 'unmatched_recv', 'ranks': [r, peer],
                    'message':
                        'unmatched recv: rank %d blocks at %s but '
                        'rank %s already exited its stream -- the '
                        'message never arrives' % (r, _describe(rec),
                                                   peer)})
        else:
            gone = [q for q in waits.get(r, ()) if head(q) is None]
            if gone:
                findings.append({
                    'kind': 'exited_collective',
                    'ranks': [r] + gone,
                    'message':
                        'rank %d waits at %s but rank(s) %s already '
                        'exited their streams and can never arrive'
                        % (r, _describe(rec),
                           ', '.join(str(q) for q in gone))})
    if not findings:
        # blocked with neither a cycle nor an exited peer cannot
        # happen in a finite wait graph, but never let a wedge pass
        findings.append({
            'kind': 'deadlock', 'ranks': blocked,
            'message': 'ranks %s blocked without progress: %s'
                       % (blocked, '; '.join(
                           'rank %d at %s' % (r, _describe(head(r)))
                           for r in blocked))})
    return findings


# ---------------------------------------------------------------------
# repeated permutations

def check_ppermute_chain(perm, size, n_steps):
    """Verify a REPEATED permutation table delivers to every rank.

    SL002 checks one application (bijectivity, range); a multi-step
    schedule -- the same ``ppermute`` applied ``n_steps`` times by an
    enclosing scan, e.g. a pipeline handoff ring -- must additionally
    COMPOSE: iterating the table from its entry ranks (sources that
    are never destinations; all sources when the table is a union of
    cycles) must eventually hand data to every rank of the axis.  A
    non-wrapping chain ``[(0,1),(1,2)]`` on a size-4 axis dead-ends
    after two hops and never reaches rank 3; a full ring reaches
    everyone within ``size - 1`` steps.

    Returns ``None`` when the chain composes, else a dict with
    ``unreachable`` (ranks never receiving data) and ``message``.
    """
    perm = [(int(s), int(d)) for s, d in perm]
    if size <= 1 or not perm or n_steps < 2:
        return None
    sources = {s for s, _ in perm}
    dests = {d for _, d in perm}
    entries = sorted(sources - dests)
    holders = set(entries) if entries else set(sources)
    ever = set(holders)
    for _ in range(min(int(n_steps), 2 * size)):
        holders = {d for s, d in perm if s in holders}
        ever |= holders
        if not holders:
            break
    unreachable = sorted(set(range(size)) - ever)
    if not unreachable:
        return None
    return {
        'unreachable': unreachable,
        'message':
            'broken multi-step ppermute chain: permutation %r applied '
            '%d times over an axis of size %d never delivers data to '
            'rank(s) %s (chain entered at rank(s) %s only ever '
            'reaches %s)' % (perm, n_steps, size, unreachable,
                             entries or sorted(sources),
                             sorted(ever))}


# ---------------------------------------------------------------------
# 1F1B handoff-chain composition (warmup / steady / cooldown)

def simulate_1f1b_streams(n_stages, n_micro):
    """Per-stage eager p2p streams of the 1F1B pipeline schedule.

    Each stage's program order follows the standard warmup (``min(M,
    S-1-s)`` forward-only microbatches) / steady (one forward, one
    backward) / cooldown (drain backwards) structure of
    ``parallel/pipeline.py``; forward activations ship on tag 0,
    backward grads on tag 1.  Feeding the result through
    :func:`match_p2p` verifies the handoff chain COMPOSES deadlock-
    free -- the multi-step extension of the single-hop ring check.
    """
    streams = {}
    for s in range(n_stages):
        comm = RecordingCommunicator(s, n_stages, channel='pipe')
        state = {'fwd': 0, 'bwd': 0}

        def forward(s=s, comm=comm, state=state):
            if s > 0:
                comm.recv_obj(s - 1, tag=0)
            if s < n_stages - 1:
                comm.send_obj(None, s + 1, tag=0)
            state['fwd'] += 1

        def backward(s=s, comm=comm, state=state):
            if s < n_stages - 1:
                comm.recv_obj(s + 1, tag=1)
            if s > 0:
                comm.send_obj(None, s - 1, tag=1)
            state['bwd'] += 1

        for _ in range(min(n_micro, n_stages - 1 - s)):
            forward()
        while state['fwd'] < n_micro:
            forward()
            backward()
        while state['bwd'] < n_micro:
            backward()
        streams[s] = comm.records
    return streams


def reference_protocol(comm):
    """The canonical eager protocol surface, in the order training
    drives it: startup barrier, parameter broadcast, metric
    allreduce, the neighbor p2p ring (dataset scatter pattern), a
    bounded allreduce (barrier + collective), teardown barrier, as the
    recording communicator plays it."""
    comm.barrier(tag='startup')
    comm.broadcast_data({'w': 0.0}, root=0)
    comm.allreduce_obj(0.0, op='mean')
    comm.send_obj(None, (comm.rank + 1) % comm.size, tag=7)
    comm.recv_obj((comm.rank - 1) % comm.size, tag=7)
    comm.allreduce_obj(0.0, op='sum', timeout=30.0)
    comm.barrier(tag='teardown')




# ---------------------------------------------------------------------
# streams of traced graphs

_SHORT = {'float32': 'f32', 'bfloat16': 'bf16', 'float16': 'f16',
          'float64': 'f64', 'int64': 'i64', 'int32': 'i32',
          'int8': 'i8', 'uint8': 'u8', 'bool': 'bool'}


def _payload(node):
    """``'f32[26]'``: dtype and element count of a collective's first
    tensor operand."""
    for p in walker.input_nodes(node):
        val = walker.node_val(p)
        if hasattr(val, 'dtype'):
            dt = str(val.dtype).replace('torch.', '')
            return '%s[%d]' % (_SHORT.get(dt, dt), val.numel())
    return '?'


def graph_collective_stream(gm):
    """The ordered collective records of one rank's traced graph
    (annotated by ``walker.annotate_collectives``): ``{'op', 'kind':
    'collective', 'tag', 'seq', 'group', 'axes', 'where'}``.  The tag
    names the mesh axes the group spans and the payload (``'inter,
    intra:f32[26]'``), so members of one group that disagree on either
    diverge; ``seq`` counts each op per group -- the ``(op, tag, seq)``
    signature :func:`verify_streams` compares."""
    recs, counters = [], {}
    for node in walker.iter_nodes(gm):
        name = walker.op_name(node)
        if name not in walker.COLLECTIVE_OPS:
            continue
        group = node.meta.get('cmn_ranks')
        axes = node.meta.get('cmn_axes')
        where = (','.join(axes) if axes is not None
                 else 'ranks=' + ','.join(str(r) for r in group or ()))
        key = (name, group)
        seq = counters.get(key, 0)
        counters[key] = seq + 1
        recs.append({'op': name.split('.', 1)[-1], 'kind': 'collective',
                     'tag': '%s:%s' % (where or '-', _payload(node)),
                     'seq': seq, 'group': group, 'axes': axes,
                     'where': walker.node_source(node)})
    return recs


def graph_p2p_stream(gm, rank, channel='c10d'):
    """The ordered p2p records of one rank's traced graph in
    :func:`match_p2p`'s shape: a ``send`` is buffered, a ``recv`` blocks
    on its exact key ``(channel, src, dest, tag, seq)``, the cursors
    counted per (peer, tag) as the object channel counts them."""
    recs, sent, got = [], {}, {}
    for node in walker.iter_nodes(gm):
        name = walker.op_name(node)
        if name not in walker.P2P_OPS:
            continue
        peer, tag = node.meta.get('cmn_peer'), node.meta.get('cmn_tag', 0)
        if name == 'c10d.send':
            seq = sent.get((peer, tag), 0)
            sent[(peer, tag)] = seq + 1
            key = P2P_KEY_FMT % (channel, rank, peer, tag, seq)
            op = 'send'
        else:
            seq = got.get((peer, tag), 0)
            got[(peer, tag)] = seq + 1
            key = P2P_KEY_FMT % (channel, peer, rank, tag, seq)
            op = 'recv'
        recs.append({'op': op, 'kind': 'p2p', 'peer': peer, 'tag': tag,
                     'seq': seq, 'channel': channel, 'key': key,
                     'where': walker.node_source(node)})
    return recs


def verify_group_streams(streams, rank_addressed=()):
    """:func:`verify_streams` per process group: the records of one
    group (``rec['group']``, its global ranks) must agree among that
    group's traced members, position by position; records without a
    group are compared across every rank.  Returns the first divergence
    (``'group'`` added, the summary naming a sub-group's ranks) or
    None."""
    ranks = sorted(streams)
    order = []
    for r in ranks:
        for rec in streams[r]:
            g = rec.get('group')
            if g is not None and g not in order:
                order.append(g)
    world = tuple(ranks)
    for g in order:
        members = [r for r in g if r in streams]
        sub = {r: [rec for rec in streams[r] if rec.get('group') == g]
               for r in members}
        div = verify_streams(sub, rank_addressed=rank_addressed)
        if div is not None:
            div['group'] = list(g)
            if tuple(g) != world:
                div['summary'] += ' (group of ranks %s)' % (
                    ', '.join(str(r) for r in g))
            return div
    rest = {r: [rec for rec in streams[r] if rec.get('group') is None]
            for r in ranks}
    return verify_streams(rest, rank_addressed=rank_addressed)


# ---------------------------------------------------------------------
# the sweep (the CLI's cross-rank section)

def _strategy_commcheck(name, world_size, reduce_dtype, comm_factory,
                        meta):
    """SL013 / SL014 findings for one strategy at one simulated world
    size: each method of its surface (``targets.strategy_targets``)
    traced on every rank, the streams compared."""
    from chainermn_tpu_torch.analysis import runner
    from chainermn_tpu_torch.analysis import targets as targets_mod

    findings = []
    for target in targets_mod.strategy_targets(
            [name], comm_factory=comm_factory, reduce_dtype=reduce_dtype,
            world_size=world_size):
        tname = 'commcheck:%s:%s@ws%d' % (name, target.name.rsplit(':')[-1],
                                          world_size)
        results = [runner.rank_result(target, r) for r in range(world_size)]
        errs = {r['rank']: r['error']['message'] for r in results
                if r['error'] is not None}
        meta['n_stream_traces'] += len(results) - len(errs)
        if errs:
            if len(errs) == len(results):
                meta['skipped'].append(
                    {'target': tname, 'reason': sorted(errs.values())[0]})
            else:
                findings.append(Finding(
                    'SL013', SEV_ERROR,
                    'rank-divergent collective sequence: rank(s) %s fail '
                    'to trace (%s) while rank(s) %s trace fine'
                    % (sorted(errs), sorted(errs.values())[0],
                       sorted(set(range(world_size)) - set(errs))),
                    target=tname))
            continue
        div = verify_group_streams({r['rank']: r['streams']
                                    for r in results})
        if div is not None:
            findings.append(Finding(
                'SL013', SEV_ERROR,
                'rank-divergent collective sequence at %s'
                % div['summary'], target=tname))
        for item in match_p2p({r['rank']: r['p2p'] for r in results}):
            findings.append(Finding('SL014', SEV_ERROR, item['message'],
                                    target=tname))
    return findings


def run_commcheck(strategies=None, world_sizes=WORLD_SIZES,
                  reduce_dtype=None, comm_factory=None, progress=None,
                  micro_counts=MICRO_COUNTS, protocols=True):
    """The full cross-rank sweep: ``(findings, meta)``.

    * every strategy's surface (``allreduce_grad`` / ``broadcast_data``
      / ``send_recv``) traced on every rank of each simulated world size
      (``comm_factory(name, rank, world_size)``, called inside the fake
      world, overrides construction -- the fixture surface);
    * the reference eager protocol simulated per rank through the
      recording communicator (stream identity + p2p match);
    * the 1F1B handoff chain composed for representative micro-batch
      counts at each stage count (these two skipped with
      ``protocols=False``).

    ``meta`` is the machine-readable section (``report['commcheck']`` in
    the ``--json`` output).
    """
    from chainermn_tpu_torch import communicators
    from chainermn_tpu_torch.parallel.pipeline import schedule_ticks

    if strategies is None:
        strategies = sorted(communicators._COMMUNICATORS)
    world_sizes = tuple(int(w) for w in world_sizes)
    findings = []
    meta = {'world_sizes': list(world_sizes),
            'strategies': list(strategies),
            'reduce_dtype': (None if reduce_dtype is None
                             else str(reduce_dtype).replace('torch.', '')),
            'n_stream_traces': 0, 'skipped': [],
            'protocols': [], 'pipeline_schedules': []}

    for name in strategies:
        for ws in world_sizes:
            if progress is not None:
                progress('commcheck:%s@ws%d' % (name, ws))
            findings.extend(_strategy_commcheck(
                name, ws, reduce_dtype, comm_factory, meta))

    for ws in world_sizes if protocols else ():
        if progress is not None:
            progress('commcheck:eager_protocol@ws%d' % ws)
        tname = 'commcheck:eager_protocol@ws%d' % ws
        streams = simulate_protocol(reference_protocol, ws)
        div = verify_streams(streams)
        if div is not None:
            findings.append(Finding(
                'SL013', SEV_ERROR,
                'rank-divergent eager protocol at %s' % div['summary'],
                target=tname))
        items = match_p2p(streams)
        for item in items:
            findings.append(Finding('SL014', SEV_ERROR, item['message'],
                                    target=tname))
        meta['protocols'].append(
            {'world_size': ws,
             'n_records': sum(len(s) for s in streams.values()),
             'ok': div is None and not items})

    for n_stages in world_sizes if protocols else ():
        for n_micro in micro_counts:
            tname = 'commcheck:1f1b:stages%d:micro%d' % (n_stages, n_micro)
            items = match_p2p(simulate_1f1b_streams(n_stages, n_micro))
            for item in items:
                findings.append(Finding(
                    'SL014', SEV_ERROR,
                    '1f1b handoff chain (%d stages, %d microbatches) '
                    'does not compose: %s'
                    % (n_stages, n_micro, item['message']), target=tname))
            meta['pipeline_schedules'].append(
                {'n_stages': n_stages, 'n_micro': n_micro,
                 'ticks': int(schedule_ticks(n_micro, n_stages,
                                             schedule='1f1b')),
                 'ok': not items})

    meta['ok'] = not findings
    return findings, meta
