"""``python -m chainermn_tpu_torch.supervisor``: the self-healing training
launcher.

Counterpart of ``chainermn_tpu/supervisor.py``, with its flags and exit
status, and one flag more, ``--device``.  One invocation supervises N
``torch.distributed`` worker processes to the end: failures are
classified (typed exit codes cross-checked against the telemetry
doctor), the policy restarts or shrinks the world on a backoff schedule
inside a restart budget, hangs are escalated stall -> SIGTERM -> SIGKILL,
crash loops abort, and every decision lands in
``<out>/supervisor_ledger.jsonl``.  See
:mod:`chainermn_tpu_torch.training.supervisor`.

With no command the built-in demo trainer is supervised (a
topology-independent ZeRO-1 MLP that resumes elastically after faults);
on the CPU (gloo)::

    CHAINERMN_TPU_CHAOS='rank=1;kill_step=@3' \\
      python -m chainermn_tpu_torch.supervisor -n 3 --out run1 \\
      --steps 6 --device cpu

A custom worker command goes after ``--`` and receives the
``CMN_SUP_*`` environment handout (rank, world size, rendezvous port,
output and live directories, attempt number, steps, checkpoint
interval, device)::

    python -m chainermn_tpu_torch.supervisor -n 2 --out run2 -- \\
      python my_worker.py

Exit status: 0 = training completed; 1 = aborted by policy (restart
budget spent or crash loop); 2 = usage error.
"""

import argparse
import sys


def _build_parser():
    p = argparse.ArgumentParser(
        prog='python -m chainermn_tpu_torch.supervisor',
        description='Self-healing worker supervisor: spawn, watch, '
                    'classify, restart/shrink, record.')
    p.add_argument('-n', '--nprocs', type=int, default=2,
                   help='initial world size (worker processes)')
    p.add_argument('--slices', type=int, default=None,
                   help='failure-domain slices (must divide nprocs): '
                        'workers build a MeshPlan.create(slices=N) '
                        'topology with hierarchical grad reduction, '
                        'and failures/shrinks happen by whole slices')
    p.add_argument('--out', default='supervised',
                   help='shared output dir (checkpoints, ledger, '
                        'logs, telemetry)')
    p.add_argument('--steps', type=int, default=6,
                   help='demo worker: train steps')
    p.add_argument('--ckpt-every', type=int, default=2,
                   help='demo worker: periodic checkpoint interval '
                        '(iterations; 0 disables)')
    p.add_argument('--min-procs', type=int, default=1,
                   help='never shrink below this world size')
    p.add_argument('--max-restarts', type=int, default=8,
                   help='restart budget')
    p.add_argument('--crash-window', type=float, default=300.0,
                   help='crash-loop window (seconds)')
    p.add_argument('--crash-threshold', type=int, default=3,
                   help='failures within the window that abort')
    p.add_argument('--backoff-initial', type=float, default=0.5,
                   help='first restart delay (seconds)')
    p.add_argument('--backoff-max', type=float, default=30.0,
                   help='restart delay cap (seconds)')
    p.add_argument('--stall-timeout', type=float, default=30.0,
                   help='heartbeat stall/frozen-iteration threshold')
    p.add_argument('--startup-grace', type=float, default=180.0,
                   help='no stall verdicts this long after launch')
    p.add_argument('--term-grace', type=float, default=10.0,
                   help='SIGTERM -> SIGKILL escalation grace')
    p.add_argument('--drain-grace', type=float, default=5.0,
                   help='wait for peers of a dead worker before '
                        'escalating them')
    p.add_argument('--attempt-timeout', type=float, default=900.0,
                   help='hard wall-clock bound per attempt')
    p.add_argument('--local-devices', type=int, default=1,
                   help='devices per worker process (1: each process '
                        'drives one device)')
    p.add_argument('--device', default=None,
                   help="the workers' device: 'cpu' (gloo) or 'cuda' "
                        '(NCCL, one GPU a process; the default)')
    p.add_argument('--no-oracle', action='store_true',
                   help='demo worker: skip the fixed-topology oracle '
                        'replay (faster; drops the acceptance fields '
                        'from worker JSONs)')
    return p


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == '--worker':
        # the worker side: the contract is the CMN_SUP_* environment
        from chainermn_tpu_torch.training import supervisor as sup
        sup.worker_main(sup.demo_worker)  # never returns

    worker_argv = None
    if '--' in argv:
        i = argv.index('--')
        argv, worker_argv = argv[:i], argv[i + 1:] or None
    try:
        args = _build_parser().parse_args(argv)
    except SystemExit as e:
        # usage errors are 2, --help stays 0
        raise SystemExit(0 if e.code in (0, None) else 2)

    from chainermn_tpu_torch.training.supervisor import (
        RestartPolicy, Supervisor)
    from chainermn_tpu_torch.utils import failure
    policy = RestartPolicy(
        max_restarts=args.max_restarts, min_procs=args.min_procs,
        crash_window=args.crash_window,
        crash_threshold=args.crash_threshold,
        backoff=failure.Backoff(initial=args.backoff_initial, factor=2.0,
                                max_delay=args.backoff_max))
    sup = Supervisor(
        nprocs=args.nprocs, out=args.out, worker_argv=worker_argv,
        steps=args.steps, ckpt_every=args.ckpt_every, policy=policy,
        local_devices=args.local_devices,
        stall_timeout=args.stall_timeout,
        startup_grace=args.startup_grace,
        term_grace=args.term_grace, drain_grace=args.drain_grace,
        attempt_timeout=args.attempt_timeout,
        oracle=not args.no_oracle, slices=args.slices,
        device=args.device)
    rc = sup.run()
    print('supervisor: %s (ledger: %s)'
          % ('complete' if rc == 0 else 'ABORTED', sup.ledger.path),
          flush=True)
    return rc


if __name__ == '__main__':
    sys.exit(main())
