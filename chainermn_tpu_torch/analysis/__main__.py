"""``python -m chainermn_tpu_torch.analysis``: the shardlint CLI.

Counterpart of ``chainermn_tpu/analysis/__main__.py``, with its flags.
Sweeps the nine communicator strategies and the step targets, the
cross-rank sweep and the memory-traffic audit, prints the findings (text
or ``--json``) and exits 0 when no ERROR fired (warnings allowed), 1 on
any ERROR, 2 on a usage error -- an unknown rule, strategy, step or
policy, refused before any trace.  Static analysis runs on the CPU: each
target is traced in a fake-backend world, one at a time, and no tensor is
computed, so the card is never touched.
"""

import argparse
import os
import sys
import time


def main(argv=None):
    import torch

    from chainermn_tpu_torch import communicators
    from chainermn_tpu_torch.analysis import rules as rules_mod
    from chainermn_tpu_torch.analysis import targets as targets_mod

    parser = argparse.ArgumentParser(
        prog='python -m chainermn_tpu_torch.analysis',
        description='shardlint: static analysis of the collectives of '
                    'traced training and serving steps')
    parser.add_argument('--json', action='store_true',
                        help='emit one JSON report on stdout')
    parser.add_argument('--list-rules', action='store_true',
                        help='print the rule catalogue and exit')
    parser.add_argument('--strategy', action='append', default=None,
                        help='lint only this strategy (repeatable); '
                             'default: all nine')
    parser.add_argument('--step', action='append', default=None,
                        help='lint only this step target by registry name, '
                             'e.g. transformer_pp (repeatable; skips the '
                             'strategy sweep and commcheck unless '
                             '--strategy is also given)')
    parser.add_argument('--rules', default=None,
                        help='comma-separated rule ids to run (default: '
                             'all)')
    parser.add_argument('--no-steps', action='store_true',
                        help='skip the train-step targets (strategy sweep '
                             'only; much faster)')
    parser.add_argument('--no-resnet50', action='store_true',
                        help='skip the resnet50 step pair (the slowest '
                             'traces)')
    parser.add_argument('--policy', default=None,
                        help='sweep under a mixed-precision policy (bf16 | '
                             'f16 | f32): strategies built with its reduce '
                             'dtype, updaters with the policy')
    parser.add_argument('--no-memtraffic', action='store_true',
                        help='skip the memory-traffic audit of the step '
                             'targets (FLOPs, bytes accessed, bytes per '
                             'item, widest intermediates)')
    parser.add_argument('--self-test', action='store_true',
                        help='lint the known-bad fixtures instead (a '
                             'rank-branched collective, an unmatched send, '
                             'a broken ring): each must fire, so the exit '
                             'code is 1')
    parser.add_argument('--jobs', type=int, default=None,
                        help='worker processes the sweep is split over '
                             '(default: the CPU count, at most 8; 1 runs '
                             'it in this process)')
    parser.add_argument('--no-commcheck', action='store_true',
                        help='skip the cross-rank sweep (strategies traced '
                             'at world sizes {2,3,4}, the eager protocol, '
                             'the 1F1B handoff composition)')
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule_id, (_fn, desc) in sorted(rules_mod.RULES.items()):
            print('%s  %s' % (rule_id, desc))
        print('no torch meaning (not rules here):')
        for rule_id, why in sorted(rules_mod.NO_TORCH_MEANING.items()):
            print('%s  %s' % (rule_id, why))
        return 0

    # usage errors (exit 2) BEFORE any tracing: an unknown name must never
    # silently sweep nothing
    only = None
    if args.rules:
        only = {r.strip() for r in args.rules.split(',') if r.strip()}
        unknown = only - set(rules_mod.RULES)
        if unknown:
            parser.error('unknown rule id(s): %s (valid: %s; see '
                         '--list-rules)'
                         % (', '.join(sorted(unknown)),
                            ', '.join(sorted(rules_mod.RULES))))
    if args.strategy:
        unknown = sorted(set(args.strategy)
                         - set(communicators._COMMUNICATORS))
        if unknown:
            parser.error('unknown strategy name(s): %s (valid: %s)'
                         % (', '.join(unknown),
                            ', '.join(sorted(communicators._COMMUNICATORS))))
    if args.step:
        unknown = sorted(set(args.step) - set(targets_mod.STEP_FACTORIES))
        if unknown:
            parser.error('unknown step target(s): %s (valid: %s)'
                         % (', '.join(unknown),
                            ', '.join(targets_mod.STEP_FACTORIES)))
    policy = None
    if args.policy:
        from chainermn_tpu_torch.precision import Policy
        try:
            policy = Policy.from_string(args.policy)
        except ValueError as e:
            parser.error(str(e))

    # the sweep's own threads; put back for an in-process caller
    threads = torch.get_num_threads()
    torch.set_num_threads(min(4, threads))
    try:
        return _lint(args, policy, only)
    finally:
        torch.set_num_threads(threads)


def _lint(args, policy, only):
    """The sweep (or the self-test) of a parsed command line: prints the
    report and returns the exit code."""
    from chainermn_tpu_torch import analysis, communicators
    from chainermn_tpu_torch.analysis import runner
    from chainermn_tpu_torch.analysis import targets as targets_mod

    t0 = time.monotonic()

    def progress(name):
        print('[shardlint %.1fs] %s' % (time.monotonic() - t0, name),
              file=sys.stderr, flush=True)

    jobs = args.jobs if args.jobs is not None else min(8, os.cpu_count()
                                                       or 1)
    if args.self_test:
        report = runner.sweep(targets_mod.self_test_targets(), only=only,
                              jobs=jobs, progress=progress)
        print(report.to_json() if args.json else report.render_text())
        return 0 if report.ok() else 1

    reduce_dtype = policy.reduce_dtype if policy is not None else None
    if args.step:
        targets = []
        if args.strategy:
            targets.extend(analysis.strategy_targets(
                args.strategy, reduce_dtype=reduce_dtype))
        targets.extend(analysis.step_targets(policy=policy, names=args.step))
    else:
        targets = analysis.default_targets(
            strategies=args.strategy, include_steps=not args.no_steps,
            include_resnet50=not args.no_resnet50, policy=policy)
    commcheck = not args.no_commcheck and not (args.step
                                                and not args.strategy)
    audited = [t.name for t in targets if t.name.startswith('step:')] \
        if not args.no_memtraffic else []
    report = runner.sweep(
        targets, only=only, policy=args.policy, jobs=jobs, audited=audited,
        commcheck_strategies=(
            args.strategy or sorted(communicators._COMMUNICATORS)
            if commcheck else None),
        progress=progress)

    if args.json:
        print(report.to_json())
    else:
        print(report.render_text())
    return 0 if report.ok() else 1


if __name__ == '__main__':
    sys.exit(main())
