"""shardlint runner: build and trace targets, run rules, build the report.

Counterpart of ``chainermn_tpu/analysis/runner.py``.  Every rank of a
target's simulated world is built and traced on its own, inside a
``walker.fake_world`` of that rank (:func:`rank_result`): the graph rules
run there on that rank's graph, and what the cross-rank rules need is
kept as plain data (the collective and p2p streams, the p2p exchanges,
the axes the collectives span, the SL007 signatures).  :func:`combine`
then runs the cross-rank rules over every rank's data.  The two halves
can run in different processes: :func:`sweep`, the one driver of the
library and the CLI, runs the ranks as jobs in this process or over
spawned ones (the CLI's ``--jobs``).  A failed build
or trace becomes a finding (SL000, or the rule that claims it), never a
crash.
"""

import os
import traceback

from chainermn_tpu_torch.analysis import commcheck
from chainermn_tpu_torch.analysis import rules as rules_mod
from chainermn_tpu_torch.analysis import walker
from chainermn_tpu_torch.analysis.findings import Finding, Report, SEV_ERROR


def error_site(err):
    """``"file:line"`` of the innermost frame of ``err``'s traceback
    outside torch, the standard library and this package, or None."""
    for fr in reversed(traceback.extract_tb(err.__traceback__)):
        f = walker._user_file(fr.filename)
        if f is not None:
            if f.startswith(walker._REPO + os.sep):
                f = os.path.relpath(f, walker._REPO)
            return '%s:%d' % (f, fr.lineno)
    return None


def _first_line(e):
    return '%s: %s' % (type(e).__name__,
                       str(e).splitlines()[0] if str(e) else '')


def _context(target, declared, **kw):
    return rules_mod.RuleContext(
        target.name,
        mesh_axes=declared.get('mesh_axes', target.mesh_axes),
        reduction_axes=declared.get('reduction_axes',
                                    target.reduction_axes),
        declared_dtypes=declared.get('declared_dtypes',
                                     target.declared_dtypes),
        compute_dtype=target.compute_dtype,
        overlap_check=target.overlap_check, plan_axes=target.plan_axes,
        staged_axes=target.staged_axes,
        rank_addressed=target.rank_addressed, **kw)


def rank_result(target, rank, only=None, audit=False, keep_graph=False):
    """Build and trace ``target`` as ``rank`` of its world and run the
    graph rules on the graph.  Returns plain data: ``findings`` (dicts),
    ``streams``, ``p2p``, ``exchanges``, ``axes_seen``, ``declared``,
    ``signatures`` (when the target probes them), the ``error`` (its
    message, ``where``, ``stage``: ``'build'``, ``'trace'`` or
    ``'signature'``, ``data_dependent``), the memtraffic row when
    ``audit``, and the graph itself when ``keep_graph``."""
    out = {'rank': rank, 'error': None}
    with walker.fake_world(target.world_size, rank):
        stage = 'build'
        try:
            built = target.build(rank)
            stage = 'trace'
            gm = walker.trace_graph(built.fn, built.args)
            stage = 'signature'
            sigs = None
            if built.make_args is not None:
                sigs = [walker.abstract_signature(built.make_args(it))
                        for it in (1, 2)]
        except Exception as e:
            out['error'] = {
                'stage': stage, 'message': _first_line(e),
                'where': error_site(e), 'type': type(e).__name__,
                'data_dependent': rules_mod._is_data_dependent(e)}
            return out
        declared = dict(built.declared)
        for key in ('reduction_axes', 'declared_dtypes'):
            if declared.get(key) is not None:
                declared[key] = tuple(sorted(declared[key])) \
                    if key == 'declared_dtypes' else tuple(declared[key])
        mesh = declared.get('mesh_axes', target.mesh_axes)
        walker.annotate_collectives(gm, mesh, rank)
        ctx = _context(target, declared, graphs={rank: gm})
        out.update(
            declared=declared, signatures=sigs,
            findings=[f.as_dict() for f in rules_mod.run_rules(ctx, only)],
            streams=commcheck.graph_collective_stream(gm),
            p2p=commcheck.graph_p2p_stream(gm, rank),
            exchanges=rules_mod.exchanges(gm),
            axes_seen=sorted(rules_mod.axes_seen(gm, mesh)))
        if audit:
            from chainermn_tpu_torch.analysis import memtraffic
            out['memtraffic'] = memtraffic.audit_graph(target, gm)
        if keep_graph:
            out['graph'] = gm
    return out


def combine(target, results, only=None):
    """All findings for one target from its ranks' :func:`rank_result`:
    the graph rules' findings (one copy of each message), then the
    cross-rank rules, in rule order."""
    results = sorted(results, key=lambda r: r['rank'])
    failed = next((r for r in results if r['error'] is not None), None)
    traced = [r for r in results if r['error'] is None]
    declared = traced[0]['declared'] if traced else {}
    err = failed['error'] if failed is not None else None
    found, seen = [], set()
    for r in traced:
        for d in r['findings']:
            key = (d['rule'], d['severity'], d['message'])
            if key not in seen:
                seen.add(key)
                found.append(finding_from_dict(d))
    whole = err is None
    ctx = _context(
        target, declared,
        rank_streams={r['rank']: r['streams'] for r in traced}
        if whole else None,
        p2p_streams={r['rank']: r['p2p'] for r in traced} if whole else None,
        exchanges={r['rank']: r['exchanges'] for r in traced},
        axes_seen=set().union(*(r['axes_seen'] for r in traced))
        if whole else None,
        signatures=next((r['signatures'] for r in traced
                         if r['signatures'] is not None), None),
        trace_error=_Claim(err) if err and err['stage'] != 'signature'
        else None,
        trace_where=err and err['where'])
    for f in rules_mod.run_rules(ctx, only=only):
        key = (f.rule_id, f.severity, f.message)
        if key not in seen:
            seen.add(key)
            found.append(f)
    found.sort(key=lambda f: f.rule_id)
    if err is not None and not any(f.rule_id in ('SL001', 'SL006')
                                   for f in found):
        # a failure no rule claimed is itself a lint error: the step
        # cannot run
        what = {'build': 'building the target failed',
                'trace': 'tracing failed',
                'signature': 'signature probe failed'}[err['stage']]
        found.append(Finding('SL000', SEV_ERROR,
                             '%s: %s' % (what, err['message']),
                             target=target.name, where=err['where']))
    return found


class _Claim(Exception):
    """A trace failure as the rules read it: its first line, and
    whether it was a data-dependent branch (what SL006 claims)."""

    def __init__(self, err):
        super().__init__(err['message'])
        self.data_dependent = err['data_dependent']


def trace_target(target, ranks=None):
    """Every rank's :func:`rank_result`, graphs kept (``ranks``: a
    subset of the world)."""
    return [rank_result(target, r, keep_graph=True)
            for r in (range(target.world_size) if ranks is None else ranks)]


def lint_target(target, only=None, ranks=None):
    """All findings for one target, every rank (or ``ranks``) traced in
    this process."""
    return combine(target, [rank_result(target, r, only=only)
                            for r in (range(target.world_size)
                                      if ranks is None else ranks)],
                   only=only)


def build_report(targets, only=None, progress=None):
    """Lint every target into one :class:`Report`, in this process
    (:func:`sweep` with one job at a time).  ``progress`` is an optional
    ``callable(target_name)`` called as each target is done."""
    return sweep(targets, only=only, progress=progress)


def finding_from_dict(d):
    return Finding(d['rule'], d['severity'], d['message'],
                   target=d['target'], where=d['where'])


# ---------------------------------------------------------------------
# the CLI's sweep split into jobs (one process each)

def find_target(name, policy=None):
    """The target called ``name`` (``strategy:<name>:<method>``,
    ``step:<name>`` or ``fixture:<name>``) under ``policy`` (a policy
    name or None)."""
    from chainermn_tpu_torch.analysis import targets as targets_mod
    from chainermn_tpu_torch.precision import Policy
    pol = Policy.from_string(policy) if policy else None
    kind, _, rest = name.partition(':')
    if kind == 'strategy':
        cands = targets_mod.strategy_targets(
            [rest.partition(':')[0]],
            reduce_dtype=pol.reduce_dtype if pol is not None else None)
    elif kind == 'step':
        cands = targets_mod.step_targets(policy=pol, names=[rest])
    else:
        cands = targets_mod.self_test_targets()
    return next(t for t in cands if t.name == name)


def run_job(job):
    """One unit of the sweep, run in a worker process: ``('rank', name,
    policy, rank, only, audit)`` -> a :func:`rank_result`;
    ``('commcheck', strategies, policy, protocols)`` -> ``(finding dicts,
    meta)``."""
    if job[0] == 'rank':
        _, name, policy, rank, only, audit = job
        return rank_result(find_target(name, policy), rank, only=only,
                           audit=audit)
    from chainermn_tpu_torch.precision import Policy
    _, strategies, policy, protocols = job
    pol = Policy.from_string(policy) if policy else None
    found, meta = commcheck.run_commcheck(
        strategies=strategies, protocols=protocols,
        reduce_dtype=pol.reduce_dtype if pol is not None else None)
    return [f.as_dict() for f in found], meta


#: what a sweep's worker imports before its first job (the tracing
#: stack a first ``make_fx`` would import)
_PRELOAD = ('chainermn_tpu_torch.analysis.targets',
            'chainermn_tpu_torch.analysis.runner',
            'torch.fx.experimental.proxy_tensor', 'torch._dynamo',
            'torch.testing._internal.distributed.fake_pg',
            'torch.utils.flop_counter')


def _one_thread():
    """A worker's torch threads: one (the workers share the cores)."""
    import torch
    torch.set_num_threads(1)


class _Now:
    """One job run when it is submitted (``jobs=1``)."""

    def __init__(self, fn, *args):
        self._out = fn(*args)

    def result(self):
        return self._out


def sweep(targets, only=None, policy=None, jobs=1, audited=(),
          commcheck_strategies=None, progress=None):
    """Lint ``targets`` into one :class:`Report`: the one driver of the
    library and the CLI.  The work is split into jobs -- one a (target,
    rank), each tracing in its own fake world, and, when
    ``commcheck_strategies`` is a list, the cross-rank sweep one a
    strategy plus the eager protocols -- run in this process
    (``jobs=1``: each job is :func:`rank_result` on the target itself)
    or over ``jobs`` spawned processes, which find each target again by
    name (:func:`run_job`, ``policy`` the policy's name).  The
    cross-rank rules run here over the ranks' results, and the report
    keeps the targets' order.  ``audited``: the names of the targets
    given the memory-traffic audit; ``progress(name)`` is called as each
    target is done."""
    import contextlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    audit = set(audited)
    report = Report()
    pool = contextlib.nullcontext()
    if jobs > 1:
        # workers fork from a server that has imported the tracing
        # stack once (seconds of CPU a worker otherwise spends on it)
        ctx = multiprocessing.get_context('forkserver')
        ctx.set_forkserver_preload(list(_PRELOAD))
        pool = ProcessPoolExecutor(max_workers=jobs, mp_context=ctx,
                                   initializer=_one_thread)
    with pool:
        submit = pool.submit if jobs > 1 else _Now

        def rank_job(t, r):
            audit_it = r == 0 and t.name in audit
            if jobs > 1:
                return submit(run_job, ('rank', t.name, policy, r, only,
                                        audit_it))
            return submit(rank_result, t, r, only, audit_it)

        # the step targets first (the longest jobs start at once)
        order = sorted(targets, key=lambda t: not t.name.startswith('step:'))
        futs = {(t.name, r): rank_job(t, r)
                for t in order for r in range(t.world_size)}
        cc = []
        if commcheck_strategies is not None:
            cc = [submit(run_job, ('commcheck', [name], policy, False))
                  for name in commcheck_strategies]
            cc.append(submit(run_job, ('commcheck', [], policy, True)))
        for t in targets:
            results = [futs[t.name, r].result()
                       for r in range(t.world_size)]
            report.add_target(t.name)
            report.extend(combine(t, results, only=only))
            if t.name in audit:
                report.memtraffic.append(results[0].get('memtraffic') or {
                    'target': t.name,
                    'trace_error': results[0]['error']['message']})
            if progress is not None:
                progress(t.name)
        if cc:
            metas = []
            for fut in cc:
                found, meta = fut.result()
                report.extend(finding_from_dict(d) for d in found
                              if only is None or d['rule'] in only)
                metas.append(meta)
            merged = dict(metas[-1], strategies=list(commcheck_strategies))
            merged['n_stream_traces'] = sum(m['n_stream_traces']
                                            for m in metas)
            merged['skipped'] = [s for m in metas for s in m['skipped']]
            merged['ok'] = all(m['ok'] for m in metas)
            report.commcheck = merged
            if progress is not None:
                progress('commcheck')
    return report
