"""shardlint's step sweep over the port: each of the JAX registry's
step targets (the ResNet-50 pair aside: its traces take over a minute
on the CPU, so it runs in the CLI and ``chip_smoke.py`` only), in f32
and under ``Policy.bf16()``.

The JAX tests state every step clean but for SL009 on
``step:mlp_example`` (its one fused gradient reduce), with
``step:bucketed_overlap`` clean.  The port's verdicts are the same but
for three more SL009 warnings, which are faults of the port (ROADMAP C):
``step:zero``, ``step:transformer_tp`` and ``step:mlp_slice`` reduce
every gradient in one fused collective a dtype (``ZeroStep``'s
reduce-scatter, ``MeshPlanCommunicator``'s all-reduce), where the JAX
steps reduce leaf by leaf.  Each target is traced on ranks 0 and 1 of
its world of 8 here (a stage pair, a tensor-parallel pair); the CLI
traces every rank.
"""

import torch

torch.set_num_threads(2)

import pytest  # noqa: E402
import torch.distributed as dist  # noqa: E402

from chainermn_tpu_torch import analysis  # noqa: E402
from chainermn_tpu_torch.analysis import targets as targets_mod  # noqa: E402
from chainermn_tpu_torch.precision import Policy  # noqa: E402

STEPS = [n for n in targets_mod.STEP_FACTORIES if not n.startswith('resnet')]
#: step -> the rules it fires (all warnings)
VERDICT = {'mlp_example': ['SL009'], 'zero': ['SL009'],
           'transformer_tp': ['SL009'], 'mlp_slice': ['SL009']}


@pytest.fixture(autouse=True)
def _no_default_group():
    if dist.is_initialized():
        dist.destroy_process_group()
    yield


@pytest.mark.parametrize('policy', ['f32', 'bf16'])
@pytest.mark.parametrize('name', STEPS)
def test_step_target_verdict(name, policy):
    pol = Policy.bf16() if policy == 'bf16' else None
    target = analysis.step_targets(policy=pol, names=[name])[0]
    findings = analysis.lint_target(target, ranks=(0, 1))
    assert sorted({f.rule_id for f in findings}) == VERDICT.get(name, []), \
        findings
    assert all(f.severity == 'warning' for f in findings), findings
    if name in VERDICT:
        assert len(findings) == 1
        assert 'ONLY schedulable reduce' in findings[0].message
