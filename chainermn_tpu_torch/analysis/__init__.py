"""shardlint for the port: static analysis of the collectives of
distributed training and serving steps, on the CPU.

Counterpart of ``chainermn_tpu/analysis/``.  ChainerMN pinned collective
correctness dynamically, running its suite under ``mpiexec -n {1,2,3}``;
here each target -- a communicator strategy's surface, a train step
through the updaters' ``traceable_step``, a serving engine's call -- is
traced with ``make_fx(tracing_mode='fake')`` inside a fake-backend
``torch.distributed`` world (``walker.fake_world``), once per simulated
``(world_size, rank)``, and the ``torch.fx`` graphs are checked against
the rule catalogue below.  It computes nothing, so it is the one entry
point of the port that never touches the card: it runs on the CPU, with
any card or none.

Rule catalogue (``rules.RULES``; severity, then what must hold):

======  =======  ========================================================
SL000   error    the target builds and traces (a failure is a finding)
SL001   error    every collective runs over a line of the process mesh;
                 a gradient reduction spans exactly the strategy's
                 declared ``reduction_axes``
SL002   error    each p2p exchange is a permutation: no self-send, no two
                 ranks sending to one rank in one exchange
SL003   warning  no reduce-of-reduce over a shared axis, no
                 gather-of-gather
SL004   error    no reduction runs in a dtype narrower than its input,
                 unless declared (``declared_reduce_dtypes``, a policy)
SL006   error    no host round-trip inside the step: ``.item()`` /
                 ``bool(t)`` / ``.tolist()`` (``_local_scalar_dense``) or
                 a data-dependent branch, reported at its site
SL007   error    the step's abstract signature (shape, dtype,
                 ``requires_grad``, layout, Python scalar types) is the
                 same at iterations 1 and 2
SL008   warning  no activation-sized f32 upcast in a declared bf16/f16
                 graph outside the kernel layer (``ops/``)
SL009   warning  a gradient-sized reduce has independent work to overlap
                 with (train steps; the fused single-buffer step fires)
SL010   error    a plan target's collectives stay on its declared plan
                 axes, and every declared axis of size > 1 is combined
SL011   warning  no reduce feeding a reduce over a disjoint plan axis
                 (declared staging axes exempt)
SL013   error    every member of a process group issues that group's
                 collectives in the same order (each rank traced on its
                 own: a Python ``if rank == k`` branch shows directly)
SL014   error    the per-rank send / recv streams match: no unmatched
                 message, no cycle of blocking receives, the ring's and
                 the pipeline's repeated exchanges included
======  =======  ========================================================

No torch meaning (``rules.NO_TORCH_MEANING``, printed by
``--list-rules``, never faked): SL005 and SL012 audit buffer donation,
which torch does not have; SL015 audits a ``lax.cond`` on
``axis_index``, but a Python branch on the rank leaves no trace in a
torch graph -- SL013's per-rank traces catch its bug class instead.

CLI: ``python -m chainermn_tpu_torch.analysis [--json]`` sweeps the nine
strategies on a world of 8, the fourteen step targets (f32, or under
``--policy bf16``), the cross-rank sweep (``commcheck``) and the
memory-traffic audit (``memtraffic``).  Exit code 0 when clean (warnings
allowed), 1 on any ERROR, 2 on a usage error (an unknown rule, strategy
or step), refused before any trace.
"""

from chainermn_tpu_torch.analysis.findings import (  # noqa: F401
    Finding, Report, SEV_ERROR, SEV_WARNING)
from chainermn_tpu_torch.analysis.rules import (  # noqa: F401
    NO_TORCH_MEANING, RULES, RuleContext)
from chainermn_tpu_torch.analysis.runner import (  # noqa: F401
    build_report, lint_target, trace_target)
from chainermn_tpu_torch.analysis.targets import (  # noqa: F401
    LintTarget, STEP_FACTORIES, default_targets, step_targets,
    strategy_targets)
from chainermn_tpu_torch.analysis import commcheck  # noqa: F401
from chainermn_tpu_torch.analysis import memtraffic  # noqa: F401
from chainermn_tpu_torch.analysis.commcheck import (  # noqa: F401
    match_p2p, run_commcheck, verify_streams)
