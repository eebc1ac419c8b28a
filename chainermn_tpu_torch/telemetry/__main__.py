"""``python -m chainermn_tpu_torch.telemetry``: merge, report, diagnose
and SLO-judge a telemetry capture.

Counterpart of ``chainermn_tpu/telemetry/__main__.py``, with its
subcommands, options and exit codes:

- ``report DIR`` merges every rank's ``events-rank*.jsonl`` and
  ``metrics-rank*.json`` under ``DIR`` into one step timeline, prints it
  with the overlap fraction (and the request traces' summary), and writes
  ``merged_report.json``, the aggregated ``metrics.json`` and
  ``metrics.prom`` back into ``DIR``; ``--request ID`` prints one
  request's stage-by-stage timeline instead.
- ``doctor DIR`` runs the cross-rank diagnosis
  (:mod:`~chainermn_tpu_torch.telemetry.diagnosis`) and writes
  ``doctor_report.json``.
- ``slo DIR`` replays the capture's request traces through the
  sliding-window SLO monitor (:mod:`~chainermn_tpu_torch.telemetry.slo`)
  and prints the multi-window burn-rate verdict as of the capture's last
  instant; writes ``slo_report.json`` (targets per invocation:
  ``--ttft-ms`` and the rest).
- ``goodput OUT`` decomposes a supervised run's wall clock
  (:mod:`~chainermn_tpu_torch.telemetry.goodput`) and writes
  ``goodput_report.json``; ``--floor F`` exits 1 below ``F``.

Exit codes: 0 on a non-empty capture, 2 when the directory holds no
telemetry (or does not exist), 1 for a malformed Prometheus export or an
unknown ``--request`` id (``report``) and below ``--floor``
(``goodput``).  A missing or unknown subcommand prints usage and exits 2.
"""

import argparse
import sys


def _build_parser():
    parser = argparse.ArgumentParser(
        prog='python -m chainermn_tpu_torch.telemetry',
        description='merge per-rank telemetry logs into a step '
                    'timeline with overlap fraction and metrics '
                    'exports, or diagnose a multi-rank capture')
    sub = parser.add_subparsers(dest='cmd')
    rep = sub.add_parser('report', help='merge + report one session '
                                        'directory')
    rep.add_argument('outdir', help='telemetry session directory '
                                    '(the CHAINERMN_TPU_TELEMETRY '
                                    'value of the run)')
    rep.add_argument('--json', action='store_true',
                     help='print the merged report as JSON instead '
                          'of text')
    rep.add_argument('--max-steps', '--steps', type=int, default=24,
                     dest='max_steps', metavar='N',
                     help='max step-timeline rows to print '
                          '(default: %(default)s)')
    rep.add_argument('--no-export', action='store_true',
                     help='print only; do not write merged_report/'
                          'metrics.json/metrics.prom into the '
                          'session dir')
    rep.add_argument('--request', metavar='ID', default=None,
                     help='print ONE request\'s reconstructed '
                          'stage-by-stage timeline (a request_id '
                          'from the capture, e.g. r42) instead of '
                          'the merged report')
    doc = sub.add_parser('doctor', help='cross-rank diagnosis: '
                                        'collective skew, stragglers, '
                                        'crash post-mortem')
    doc.add_argument('outdir', help='telemetry session directory')
    doc.add_argument('--json', action='store_true',
                     help='print the diagnosis as JSON instead of '
                          'text')
    doc.add_argument('--liveness', action='append', default=[],
                     metavar='DIR',
                     help='extra heartbeat directory to consult '
                          '(repeatable; liveness dirs recorded in '
                          'the capture are found automatically)')
    doc.add_argument('--no-export', action='store_true',
                     help='print only; do not write '
                          'doctor_report.json into the session dir')
    good = sub.add_parser(
        'goodput', help='decompose a run\'s wall clock into useful-'
                        'step / bubble / exposed-collective / '
                        'checkpoint / input-bound / restart-downtime '
                        'and print the goodput fraction')
    good.add_argument('outdir',
                      help='supervisor out dir (supervisor_ledger.'
                           'jsonl + telemetry/a* attempt captures) '
                           'or one telemetry session directory')
    good.add_argument('--json', action='store_true',
                      help='print the goodput report as JSON instead '
                           'of text')
    good.add_argument('--no-export', action='store_true',
                      help='print only; do not write '
                           'goodput_report.json into the run dir')
    good.add_argument('--floor', type=float, default=None,
                      metavar='F',
                      help='exit 1 when goodput_fraction < F (CI '
                           'chaos legs pin their floor here)')
    slo = sub.add_parser('slo', help='sliding-window SLO verdict '
                                     '(ok/warn/breach) over the '
                                     'capture\'s request traces')
    slo.add_argument('outdir', help='telemetry session directory')
    slo.add_argument('--json', action='store_true',
                     help='print the verdict as JSON instead of text')
    slo.add_argument('--no-export', action='store_true',
                     help='print only; do not write slo_report.json '
                          'into the session dir')
    slo.add_argument('--ttft-ms', type=float, default=1000.0,
                     metavar='MS',
                     help='TTFT latency target (default: '
                          '%(default)s ms)')
    slo.add_argument('--intertoken-ms', type=float, default=250.0,
                     metavar='MS',
                     help='inter-token latency target (default: '
                          '%(default)s ms)')
    slo.add_argument('--objective', type=float, default=0.99,
                     help='good-event fraction for the latency SLOs '
                          '(default: %(default)s)')
    slo.add_argument('--shed-fraction', type=float, default=0.05,
                     help='shed-fraction budget (default: '
                          '%(default)s)')
    slo.add_argument('--occupancy', type=float, default=0.98,
                     help='slot-occupancy warn ceiling (default: '
                          '%(default)s)')
    slo.add_argument('--tokens-per-s', type=float, default=None,
                     help='optional minimum generated tokens/s '
                          '(omitted: no throughput SLO)')
    slo.add_argument('--fast-window', type=float, default=None,
                     metavar='S', help='fast burn window, seconds '
                                       '(default: 30)')
    slo.add_argument('--slow-window', type=float, default=None,
                     metavar='S', help='slow burn window, seconds '
                                       '(default: 150)')
    return parser


def _cmd_report(args):
    from chainermn_tpu_torch.telemetry import report as report_mod
    from chainermn_tpu_torch.telemetry.recorder import snapshot_to_prometheus

    if getattr(args, 'request', None):
        _metas, spans, events, _bad = report_mod.load_rank_logs(
            args.outdir)
        traces = report_mod.request_traces(spans + events)
        trace = traces.get(str(args.request))
        if trace is None:
            print('telemetry: no request %r in %s (known: %s)'
                  % (args.request, args.outdir,
                     ', '.join(sorted(traces)[:12]) or 'none'),
                  file=sys.stderr)
            return 1
        if args.json:
            import json
            print(json.dumps(trace, indent=1, default=repr))
        else:
            print(report_mod.render_request_text(trace))
        return 0

    report = report_mod.build_report(args.outdir)
    if not args.no_export:
        report_mod.export(args.outdir, report)
    if args.json:
        import json
        print(json.dumps(report, indent=1))
    else:
        print(report_mod.render_text(report,
                                     max_steps=args.max_steps))
    if (report['n_spans'] + report['n_events'] == 0
            and not report.get('serve')):
        # a serving capture may legitimately hold only serve_*
        # metrics (the engine's in-memory window exports histograms,
        # no event log) -- that is a real capture, not an empty one
        print('telemetry: EMPTY capture under %s (was '
              'CHAINERMN_TPU_TELEMETRY set, and did the run flush?)'
              % args.outdir, file=sys.stderr)
        return 2
    bad = report_mod.validate_prometheus(
        snapshot_to_prometheus(report['metrics']))
    if bad:
        print('telemetry: malformed Prometheus line(s): %r' % bad[:5],
              file=sys.stderr)
        return 1
    return 0


def _cmd_doctor(args):
    from chainermn_tpu_torch.telemetry import diagnosis

    diag = diagnosis.diagnose(args.outdir,
                              liveness_dirs=args.liveness)
    if not args.no_export:
        diagnosis.export(args.outdir, diag)
    if args.json:
        import json
        print(json.dumps(diag, indent=1, default=repr))
    else:
        print(diagnosis.render_doctor_text(diag))
    if (diag['n_spans'] + diag['n_events']
            + diag['n_flight_records'] == 0
            and not diag.get('serve')):
        # serve-metrics-only captures are non-empty (see _cmd_report)
        print('telemetry doctor: EMPTY capture under %s (was '
              'CHAINERMN_TPU_TELEMETRY set, and did the run flush?)'
              % args.outdir, file=sys.stderr)
        return 2
    return 0


def _cmd_goodput(args):
    from chainermn_tpu_torch.telemetry import goodput as goodput_mod

    gp = goodput_mod.build_goodput(args.outdir)
    if gp.get('wall_s') is not None and not args.no_export:
        goodput_mod.export(args.outdir, gp)
    if args.json:
        import json
        print(json.dumps(gp, indent=1))
    else:
        print(goodput_mod.render_text(gp))
    if gp.get('wall_s') is None:
        print('telemetry goodput: EMPTY capture under %s (was '
              'CHAINERMN_TPU_TELEMETRY set, and did the run flush?)'
              % args.outdir, file=sys.stderr)
        return 2
    if (args.floor is not None
            and gp['goodput_fraction'] < args.floor):
        print('telemetry goodput: fraction %.4f BELOW floor %.4f'
              % (gp['goodput_fraction'], args.floor),
              file=sys.stderr)
        return 1
    return 0


def _cmd_slo(args):
    from chainermn_tpu_torch.telemetry import slo as slo_mod

    windows = {}
    if args.fast_window is not None:
        windows['fast_window_s'] = args.fast_window
    if args.slow_window is not None:
        windows['slow_window_s'] = args.slow_window
    slos = slo_mod.default_slos(
        ttft_s=args.ttft_ms / 1e3,
        intertoken_s=args.intertoken_ms / 1e3,
        objective=args.objective,
        max_shed_fraction=args.shed_fraction,
        max_occupancy=args.occupancy,
        min_tokens_per_s=args.tokens_per_s, **windows)
    result = slo_mod.evaluate_capture(args.outdir, slos=slos)
    if not args.no_export:
        slo_mod.export(args.outdir, result)
    if args.json:
        import json
        print(json.dumps(result, indent=1, default=repr))
    else:
        print(slo_mod.render_slo_text(result))
    if result['n_request_records'] == 0:
        print('telemetry slo: no request traces or serve spans under '
              '%s (was CHAINERMN_TPU_TELEMETRY set during the serve '
              'window, and did the run flush?)' % args.outdir,
              file=sys.stderr)
        return 2
    return 0


def main(argv=None):
    parser = _build_parser()
    try:
        args = parser.parse_args(argv)
    except SystemExit as e:
        # argparse already printed usage + error; normalize the exit
        # status to a nonzero return so programmatic callers (and CI
        # pipelines capturing $?) see failure, never a traceback
        return e.code if e.code else 0
    if args.cmd is None:
        parser.print_usage(sys.stderr)
        print('%s: error: a subcommand is required (report | doctor '
              '| slo | goodput)' % parser.prog, file=sys.stderr)
        return 2
    import os
    if not os.path.isdir(args.outdir):
        # a missing capture directory is the empty-capture case, not
        # a traceback: every subcommand would otherwise crash trying
        # to write its export next to logs that do not exist
        print('telemetry %s: no session directory at %s (was '
              'CHAINERMN_TPU_TELEMETRY set, and did the run flush?)'
              % (args.cmd, args.outdir), file=sys.stderr)
        return 2
    if args.cmd == 'report':
        return _cmd_report(args)
    if args.cmd == 'slo':
        return _cmd_slo(args)
    if args.cmd == 'goodput':
        return _cmd_goodput(args)
    return _cmd_doctor(args)


if __name__ == '__main__':
    sys.exit(main())
