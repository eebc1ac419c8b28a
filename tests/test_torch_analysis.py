"""shardlint for the port: one firing and one silent fixture per rule,
the strategy and cross-rank sweeps, the CLI, the hooks the rules read.

Every fixture is a small torch program traced on each rank of a
fake-backend world (``analysis.walker.fake_world``); a known-bad one
must fire exactly its rule, its clean twin nothing.  The step sweep is
``tests/test_torch_analysis_steps.py``.
"""

import ast
import json
import pathlib

import torch

torch.set_num_threads(2)

import pytest  # noqa: E402
import torch.distributed as dist  # noqa: E402

from chainermn_tpu_torch import analysis  # noqa: E402
from chainermn_tpu_torch.analysis import __main__ as cli  # noqa: E402
from chainermn_tpu_torch.analysis import rules as rules_mod  # noqa: E402
from chainermn_tpu_torch.analysis import runner  # noqa: E402
from chainermn_tpu_torch.analysis import targets as targets_mod  # noqa: E402
from chainermn_tpu_torch.analysis import walker  # noqa: E402
from chainermn_tpu_torch.analysis.targets import (  # noqa: E402
    Built, LintTarget, fixture_target, ring_exchange)
from chainermn_tpu_torch.communicators import mesh_utility  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
STRATEGIES = ['bucketed', 'dummy', 'flat', 'hierarchical', 'naive',
              'non_cuda_aware', 'single_node', 'two_dimensional', 'xla']


@pytest.fixture(autouse=True)
def _no_default_group():
    """A default group left by an earlier test file of this worker would
    make ``fake_world`` refuse: that file is done, so drop it."""
    if dist.is_initialized():
        dist.destroy_process_group()
    yield


def _ids(findings, severity=None):
    return sorted({f.rule_id for f in findings
                   if severity is None or f.severity == severity})


def _lint(name, make, ws=2, **kw):
    return analysis.lint_target(fixture_target(name, make, ws, **kw))


def _mesh_target(make, plan_axes=None, staged_axes=None,
                 reduction_axes=None):
    """A fixture on the (inter, intra) = (2, 2) mesh of 4 processes;
    ``make(rank, intra_group, inter_group)``."""
    def build(rank):
        intra, inter = mesh_utility.build_groups(2, 2, rank)
        fn, args = make(rank, intra, inter)
        return Built(fn, args, reduction_axes=reduction_axes)
    return LintTarget('fixture:mesh', build, 4,
                      mesh_axes={'inter': 2, 'intra': 2},
                      plan_axes=plan_axes, staged_axes=staged_axes)


def _x():
    return (torch.zeros(4, 4),)


# ------------------------------------------------------------ SL000
def test_sl000_trace_failure_is_a_finding():
    def make(rank):
        def fn(x):
            raise RuntimeError('boom in the step')
        return fn, _x()
    fs = _lint('boom', make)
    assert _ids(fs) == ['SL000'] and 'boom in the step' in fs[0].message
    assert fs[0].where.startswith('tests/test_torch_analysis.py:')


def test_sl000_silent_on_a_clean_step():
    assert _lint('ok', lambda rank: (lambda x: x * 2, _x())) == []


# ------------------------------------------------------------ SL001
@pytest.mark.parametrize('bad', ['off_mesh_group', 'topology'])
def test_sl001_fires(bad):
    def make(rank, intra, inter):
        g = dist.new_group([0, 3])

        def fn(x):
            if bad == 'off_mesh_group' and rank in (0, 3):
                dist.all_reduce(x, group=g)
            if bad == 'topology':
                dist.all_reduce(x, group=intra)
            return x
        return fn, _x()
    fs = analysis.lint_target(_mesh_target(
        make, reduction_axes=('inter', 'intra')))
    assert _ids(fs, 'error') == ['SL001'], fs
    want = ('no line of the mesh' if bad == 'off_mesh_group'
            else "declares reduction_axes=['inter', 'intra']")
    assert any(want in f.message for f in fs), fs


def test_sl001_silent_on_the_declared_topology():
    def make(rank, intra, inter):
        def fn(x):
            dist.all_reduce(x, group=intra)
            dist.all_reduce(x, group=inter)
            return x
        return fn, _x()
    assert analysis.lint_target(_mesh_target(
        make, reduction_axes=('inter', 'intra'))) == []


# ------------------------------------------------------------ SL002
def _exchange(rank, pairs):
    def fn(x):
        out = [torch.empty_like(x) for _ in pairs]
        ops = [dist.P2POp(dist.isend, x, d) for s, d in pairs if s == rank]
        ops += [dist.P2POp(dist.irecv, o, s)
                for o, (s, d) in zip(out, pairs) if d == rank]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out
    return fn, _x()


def test_sl002_two_senders_to_one_rank_fires():
    fs = _lint('fan_in', lambda r: _exchange(r, [(0, 1), (2, 1)]), ws=3)
    assert _ids(fs) == ['SL002'], fs
    assert 'ranks [0, 2] all send to rank 1' in fs[0].message


def test_sl002_ring_is_silent():
    ring = [(i, (i + 1) % 3) for i in range(3)]
    assert _lint('ring', lambda r: _exchange(r, ring), ws=3) == []


# ------------------------------------------------------------ SL003
@pytest.mark.parametrize('twice,want', [(True, ['SL003']), (False, [])])
def test_sl003_reduce_of_reduce(twice, want):
    def make(rank):
        def fn(x):
            dist.all_reduce(x)
            if twice:
                dist.all_reduce(x)
            return x
        return fn, _x()
    fs = _lint('rr', make)
    assert _ids(fs) == want, fs
    assert all(f.severity == 'warning' for f in fs)


# ------------------------------------------------------------ SL004
@pytest.mark.parametrize('declared,want', [(None, ['SL004']),
                                           (('bfloat16',), [])])
def test_sl004_narrowed_reduction(declared, want):
    def make(rank):
        def fn(g):
            wire = g.to(torch.bfloat16)
            dist.all_reduce(wire)
            return wire.float()
        return fn, _x()
    fs = _lint('narrow', make, declared_dtypes=declared)
    assert _ids(fs) == want, fs
    if want:
        assert 'narrowed from float32' in fs[0].message


# ------------------------------------------------------------ SL006
@pytest.mark.parametrize('how', ['item', 'branch'])
def test_sl006_host_round_trip_fires_at_its_site(how):
    def make(rank):
        def fn(x):
            if how == 'item':
                return x * x.sum().item()
            if x.sum() > 0:
                return x * 2
            return x
        return fn, _x()
    fs = _lint('sync', make)
    assert _ids(fs) == ['SL006'], fs
    assert fs[0].where.startswith('tests/test_torch_analysis.py:'), fs


def test_sl006_silent_without_host_reads():
    assert _lint('nosync', lambda r: (lambda x: (x * x).sum(), _x())) == []


# ------------------------------------------------------------ SL007
@pytest.mark.parametrize('drift,want', [(True, ['SL007']), (False, [])])
def test_sl007_signature_drift(drift, want):
    def build(rank):
        def make_args(it):
            return (torch.zeros(4, 4 + (it if drift else 0)),)
        return Built(lambda x: x * 2, make_args(1), make_args=make_args)
    fs = analysis.lint_target(LintTarget('fixture:sig', build, 2))
    assert _ids(fs) == want, fs


# ------------------------------------------------------------ SL008
@pytest.mark.parametrize('shape,want', [((64, 128), ['SL008']),
                                        ((8, 8), [])])
def test_sl008_f32_materialization(shape, want):
    def make(rank):
        return (lambda x: (x.float() * 2.0).sum(),
                (torch.zeros(shape, dtype=torch.bfloat16),))
    fs = _lint('upcast', make, compute_dtype='bfloat16')
    assert _ids(fs) == want, fs
    assert _ids(fs, 'error') == []
    # undeclared compute: the rule is off
    assert _lint('upcast', make) == []


def test_sl008_exempts_the_kernel_layer():
    from chainermn_tpu_torch.ops import layer_norm

    def make(rank):
        return (lambda x, g, b: layer_norm(x, g, b).sum(),
                (torch.zeros(64, 128, dtype=torch.bfloat16),
                 torch.ones(128, dtype=torch.bfloat16),
                 torch.zeros(128, dtype=torch.bfloat16)))
    assert _lint('ln', make, compute_dtype='bfloat16') == []


# ------------------------------------------------------------ SL009
def test_sl009_fused_step_fires_bucketed_step_silent():
    fused = analysis.lint_target(targets_mod.mlp_step_target(),
                                 ranks=(0, 1))
    assert _ids(fused) == ['SL009'], fused
    assert any('ONLY schedulable reduce' in f.message for f in fused)
    bucketed = analysis.lint_target(
        targets_mod.bucketed_overlap_step_target(), ranks=(0, 1))
    assert bucketed == [], bucketed


# ------------------------------------------------------------ SL010
@pytest.mark.parametrize('bad', ['stray', 'dead'])
def test_sl010_fires(bad):
    def make(rank, intra, inter):
        def fn(x):
            dist.all_reduce(x, group=intra)
            if bad == 'stray':
                dist.all_reduce(x)
            return x
        return fn, _x()
    plan = ('intra',) if bad == 'stray' else ('inter', 'intra')
    fs = analysis.lint_target(_mesh_target(make, plan_axes=plan))
    assert 'SL010' in _ids(fs, 'error'), fs
    want = 'outside the declared plan axes' if bad == 'stray' \
        else "declared plan axis 'inter'"
    assert any(want in f.message for f in fs), fs


def test_sl010_silent_when_every_axis_is_combined():
    def make(rank, intra, inter):
        def fn(x, y):
            dist.all_reduce(x, group=intra)
            dist.all_reduce(y, group=inter)
            return x, y
        return fn, (torch.zeros(4), torch.zeros(4))
    assert analysis.lint_target(_mesh_target(
        make, plan_axes=('inter', 'intra'))) == []


# ------------------------------------------------------------ SL011
@pytest.mark.parametrize('staged,want', [(None, ['SL011']),
                                         (('inter',), [])])
def test_sl011_disjoint_reduce_chain(staged, want):
    def make(rank, intra, inter):
        def fn(x):
            dist.all_reduce(x, group=intra)
            dist.all_reduce(x, group=inter)
            return x
        return fn, _x()
    fs = analysis.lint_target(_mesh_target(
        make, plan_axes=('inter', 'intra'), staged_axes=staged))
    assert _ids(fs) == want, fs


# ------------------------------------------------------------ SL013
def test_sl013_rank_branched_all_reduce_names_position_and_ranks():
    fs = analysis.lint_target(targets_mod.self_test_targets()[0])
    assert _ids(fs, 'error') == ['SL013'], fs
    assert ('position 1: rank 0 issues barrier[intra:u8[1]]#0; rank 1 '
            'issues allreduce_[intra:f32[4]]#1; rank 2 issues '
            'barrier[intra:u8[1]]#0') in fs[0].message, fs


def test_sl013_sub_group_divergence_names_the_group():
    def make(rank, intra, inter):
        def fn(x):
            if rank != 3:
                dist.all_reduce(x, group=intra)
            return x
        return fn, _x()
    fs = analysis.lint_target(_mesh_target(make))
    assert _ids(fs) == ['SL013'], fs
    assert 'rank 3 issues <ended>' in fs[0].message
    assert '(group of ranks 2, 3)' in fs[0].message


def test_sl013_uniform_program_is_silent():
    def make(rank):
        def fn(x, y):
            dist.all_reduce(x)
            dist.all_reduce(y)
            dist.barrier()
            return x, y
        return fn, (torch.zeros(4), torch.zeros(4))
    assert _lint('uniform', make, ws=3) == []


# ------------------------------------------------------------ SL014
def test_sl014_unmatched_send():
    fs = analysis.lint_target(targets_mod.self_test_targets()[1])
    assert _ids(fs) == ['SL014'], fs
    assert 'unmatched send: rank 0' in fs[0].message
    assert 'tag 9' in fs[0].message


def test_sl014_recv_before_send_deadlock():
    def make(rank):
        def fn(x):
            out = torch.empty_like(x)
            dist.recv(out, 1 - rank)
            dist.send(x, 1 - rank)
            return out
        return fn, _x()
    fs = _lint('headon', make)
    assert _ids(fs) == ['SL014'], fs
    assert 'rank 0 blocked at recv(peer=1' in fs[0].message
    assert 'rank 1 blocked at recv(peer=0' in fs[0].message


def test_sl014_broken_ring_never_delivers():
    fs = analysis.lint_target(targets_mod.self_test_targets()[2])
    assert _ids(fs) == ['SL014'], fs
    assert 'rank 0 blocks at recv(peer=3' in fs[0].message


def test_sl014_full_ring_is_silent():
    assert _lint('ring', lambda r: ring_exchange(r, 4, 3), ws=4) == []


# ------------------------------------------------------------ catalogue
def test_no_torch_meaning_rules_are_listed_not_faked():
    assert set(rules_mod.NO_TORCH_MEANING) == {'SL005', 'SL012', 'SL015'}
    assert not set(rules_mod.NO_TORCH_MEANING) & set(rules_mod.RULES)
    assert sorted(rules_mod.RULES) == [
        'SL001', 'SL002', 'SL003', 'SL004', 'SL006', 'SL007', 'SL008',
        'SL009', 'SL010', 'SL011', 'SL013', 'SL014']


# ------------------------------------------------------------ sweeps
@pytest.mark.parametrize('reduce_dtype', [None, torch.bfloat16])
@pytest.mark.parametrize('name', STRATEGIES)
def test_strategy_surface_lints_clean(name, reduce_dtype):
    for t in analysis.strategy_targets([name], reduce_dtype=reduce_dtype):
        assert analysis.lint_target(t) == [], t.name


def test_commcheck_clean_sweep_all_strategies():
    findings, meta = analysis.run_commcheck()
    assert findings == [], findings
    assert meta['ok'] is True and meta['world_sizes'] == [2, 3, 4]
    assert sorted(meta['strategies']) == STRATEGIES
    assert meta['skipped'] == []
    assert all(p['ok'] for p in meta['protocols'])
    assert all(s['ok'] for s in meta['pipeline_schedules'])
    assert meta['n_stream_traces'] == 9 * 3 * (2 + 3 + 4)


def test_commcheck_comm_factory_rank_branch_fires():
    from chainermn_tpu_torch.communicators import NaiveCommunicator

    class Branchy(NaiveCommunicator):
        def allreduce_grad(self, grads):
            out = super().allreduce_grad(grads)
            if self.rank == 1:
                out = super().allreduce_grad(out)  # rank 1 only
            return out

    def factory(name, rank, world_size):
        return Branchy(device='cpu', mesh_shape=(1, world_size))

    findings, _meta = analysis.run_commcheck(
        strategies=['naive'], world_sizes=(2,), comm_factory=factory,
        protocols=False)
    sl13 = [f for f in findings if f.rule_id == 'SL013']
    assert sl13 and all('allreduce_grad' in f.target for f in sl13)


# ------------------------------------------------------------ the CLI
def test_cli_json_round_trip(capsys):
    rc = cli.main(['--no-steps', '--strategy', 'xla', '--json',
                   '--jobs', '1'])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0 and data['ok'] is True and data['tool'] == 'shardlint'
    assert data['targets'] == ['strategy:xla:%s' % m for m in (
        'allreduce_grad', 'broadcast_data', 'send_recv')]
    assert data['commcheck']['strategies'] == ['xla']
    report = analysis.Report()
    report.extend(runner.finding_from_dict(d)
                  for d in [{'rule': 'SL009', 'severity': 'warning',
                             'target': 't', 'message': 'm', 'where': 'w'}])
    assert json.loads(report.to_json())['findings'][0]['where'] == 'w'


@pytest.mark.parametrize('argv,rc', [
    (['--no-steps', '--strategy', 'hierarchical'], 0),
    (['--self-test'], 1)], ids=['sweep', 'self-test'])
def test_cli_parallel_jobs_match_the_serial_report(capsys, argv, rc):
    argv = argv + ['--json']
    assert cli.main(argv + ['--jobs', '1']) == rc
    serial = json.loads(capsys.readouterr().out)
    assert cli.main(argv + ['--jobs', '2']) == rc
    parallel = json.loads(capsys.readouterr().out)
    assert parallel == serial
    if argv[0] == '--self-test':
        lib = runner.build_report(targets_mod.self_test_targets())
        assert json.loads(lib.to_json()) == serial


def test_cli_step(capsys):
    rc = cli.main(['--step', 'zero_core', '--json', '--jobs', '1'])
    data = json.loads(capsys.readouterr().out)
    assert rc == 0 and data['targets'] == ['step:zero_core']
    assert data['commcheck'] == {}
    row = data['memtraffic'][0]
    assert row['target'] == 'step:zero_core' and 'cost_lacks' in row


@pytest.mark.parametrize('step', ['mlp_example', 'transformer_pp'])
def test_cost_summary_flops_equal_a_flop_counter_replay(step):
    """The audit's static FLOP count equals ``FlopCounterMode`` over the
    traced graph replayed on fake tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils import _pytree as pytree
    from torch.utils.flop_counter import FlopCounterMode
    from chainermn_tpu_torch.analysis import memtraffic
    t = targets_mod.step_targets(names=[step])[0]
    with walker.fake_world(t.world_size, 0):
        built = t.build(0)
        gm = walker.trace_graph(built.fn, built.args)
        with torch.no_grad(), \
                FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = pytree.tree_map_only(torch.Tensor, mode.from_tensor,
                                        built.args)
            with FlopCounterMode(display=False) as fc:
                gm(*fake)
        row = memtraffic.cost_summary(gm)
    assert row['flops'] == float(fc.get_total_flops()) > 0


def test_cli_list_rules(capsys):
    assert cli.main(['--list-rules']) == 0
    out = capsys.readouterr().out
    head, _, tail = out.partition('no torch meaning')
    for rule in rules_mod.RULES:
        assert rule in head
    for rule in ('SL005', 'SL012', 'SL015'):
        assert rule in tail and rule not in head


@pytest.mark.parametrize('argv', [['--rules', 'SL999'],
                                  ['--rules', 'SL005'],
                                  ['--strategy', 'nope'],
                                  ['--step', 'nope'],
                                  ['--policy', 'f8']])
def test_cli_usage_errors_exit_2_before_any_trace(argv, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('traced before refusing the usage error')
    monkeypatch.setattr(runner, 'trace_target', refuse)
    monkeypatch.setattr(walker, 'trace_graph', refuse)
    with pytest.raises(SystemExit) as ei:
        cli.main(argv)
    assert ei.value.code == 2


def test_cli_self_test_exits_1_with_every_fixture_firing(capsys):
    assert cli.main(['--self-test', '--json', '--jobs', '1']) == 1
    data = json.loads(capsys.readouterr().out)
    by_target = {}
    for f in data['findings']:
        by_target.setdefault(f['target'], set()).add(f['rule'])
    assert by_target == {'fixture:rank_branch': {'SL013'},
                         'fixture:unmatched_send': {'SL014'},
                         'fixture:broken_ring': {'SL014'}}


# ------------------------------------------------------------ the hooks
def test_reduction_axes_are_the_jax_strategies():
    from chainermn_tpu import communicators as jcomm
    from chainermn_tpu_torch import communicators as comm
    for name in STRATEGIES:
        assert tuple(comm._COMMUNICATORS[name].reduction_axes) == tuple(
            jcomm._COMMUNICATORS[name].reduction_axes), name


def test_declared_reduce_dtypes_and_fake_world_rules():
    from chainermn_tpu_torch.precision import Policy
    with walker.fake_world(2, 1):
        comm = targets_mod.build_strategy('xla', (1, 2), torch.bfloat16)
        assert comm.declared_reduce_dtypes() == {'bfloat16'}
        upd = targets_mod._mlp_updater(comm, Policy.bf16())
        assert 'bfloat16' in upd.declared_reduce_dtypes()
        with pytest.raises(RuntimeError, match='already exists'):
            with walker.fake_world(2, 0):
                pass
    assert not dist.is_initialized()


def test_traceable_step_is_the_update_body_and_restores_the_updater():
    """``fn`` run eagerly in a world of one equals ``update_core`` of an
    identical updater, and the updater it came from is left as it
    was."""
    import copy
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, training
    from chainermn_tpu_torch.training.updater import (
        optimizer_state_by_index)

    def updater():
        torch.manual_seed(0)
        model = models.MLP(n_units=16, n_out=10, device='cpu')
        comm = cmt.create_communicator('naive', device='cpu')
        opt = cmt.create_multi_node_optimizer(
            torch.optim.Adam(model.parameters(), lr=1e-2), comm)
        return training.StandardUpdater(
            iter([]), opt, models.Classifier(model), model, comm), comm

    g = torch.Generator().manual_seed(1)
    batch = (torch.randn(8, 784, generator=g),
             torch.randint(0, 10, (8,), generator=g))
    try:
        a, comm = updater()
        b, _ = updater()
        for u in (a, b):
            u.update_core(batch)              # the broadcast step
        before = copy.deepcopy(a.model.state_dict())
        fn, args = a.traceable_step(batch)
        params, _bufs, state, metrics = fn(*copy.deepcopy(args))
        assert a.iteration == 1 and a.optimizer.needs_broadcast is False
        assert all(torch.equal(before[k], v)
                   for k, v in a.model.state_dict().items())
        assert optimizer_state_by_index(a._inner_optimizer()) == {}
        want = b.update_core(batch)
        for name, p in b.model.named_parameters():
            assert torch.equal(params[name], p.detach()), name
        assert float(metrics['loss']) == float(want['loss'])
        assert sorted(state) == list(range(6))
    finally:
        comm.close()


def test_pipeline_traceable_step_traces_the_stage_exchange():
    t = targets_mod.pipeline_step_target()
    first, second = runner.trace_target(t, ranks=(0, 1))
    assert first['error'] is None, first['error']
    ops = [walker.op_name(n) for n in walker.iter_nodes(first['graph'])]
    assert 'c10d.send' in ops and 'c10d.recv_' in ops
    assert [r['op'] for r in second['p2p']][:1] == ['recv']


class _Reached(Exception):
    pass


def test_pipeline_traceable_step_leaves_the_first_step_exchanges(
        monkeypatch):
    """Tracing a rank's pipeline step primes nothing of its updater: the
    next real step of that rank still exchanges the activation template
    (then the metric shapes) across the stage line, as the ranks that
    were not traced do; otherwise the ranks' collectives diverge."""
    with walker.fake_world(2, 0):
        upd, batch = targets_mod.pipeline_updater()
        for it in (None, 1):
            fn, args = upd.traceable_step(batch, iteration=it)
            walker.trace_graph(fn, args)
            assert upd._templates == {} and upd._metric_spec is None
            assert upd.iteration == 0 and not upd._guarded
        seen = []

        def from_stage(line, obj, stage):
            seen.append((stage, obj))
            raise _Reached

        monkeypatch.setattr(upd, '_from_stage', from_stage)
        with pytest.raises(_Reached):
            upd.update_core(batch)
        assert seen == [(0, ((4 // 2, 8), torch.float32))]


def test_analysis_modules_import_no_jax():
    forbidden = {'jax', 'jaxlib', 'flax', 'optax', 'chainermn_tpu'}
    files = sorted((REPO / 'chainermn_tpu_torch' / 'analysis').glob('*.py'))
    files.append(REPO / 'chainermn_tpu_torch' / 'communicators'
                 / 'recording.py')
    assert len(files) == 10
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                roots = {a.name.split('.')[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots = {node.module.split('.')[0]}
            else:
                continue
            assert not roots & forbidden, (f, roots)
