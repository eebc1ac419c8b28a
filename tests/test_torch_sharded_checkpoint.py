"""The port's sharded checkpoint path (``serializers.save_checkpoint`` /
``restore_checkpoint`` over ``torch.distributed.checkpoint``,
``PreemptionHandler(method='orbax')``, step directories in
``auto_resume``) on gloo worlds of two processes and of one.

Each process wraps ``dcp.save``, ``dcp.async_save`` and ``dcp.load`` and
records the backend of the ``process_group`` each call got: every call
must carry one, and it must be gloo (DCP's asynchronous save refuses a
group without a CPU backend, which an NCCL-only world on the card is).
The same holds after the default group is destroyed and made again, the
side group being made anew (a destroyed default group takes its
sub-groups with it).

- A ``TransformerLM`` of 2 layers and d 32 in bfloat16 (its Adam state
  bfloat16 too) under the multi-node Adam: the synchronous and the
  asynchronous step directory resume bit-equal to the state that was
  saved, and the next two losses equal the straight run's; at two
  processes every replicated key is written once (DCP drops the
  duplicate).
- A ZeRO-1 MLP (raw Adam, the global batch cut by rank): each process
  writes its partitions under ``<key>@rank<r>`` and the sidecar lists
  the ``(n, k)`` stacks; a resume at the same world size is bit-equal;
  the two-process step directory resumed at one process (raw restore,
  ``reshard_stacked_state``) equals the two-process npz resumed there.
- A torn step (no sidecar) and a corrupt one (a truncated shard file)
  are skipped by ``auto_resume`` with ``CheckpointSkippedWarning``;
  ``verify_checkpoint`` holds a template to a step directory.
"""

import json

import numpy as np
import pytest
import torch

from chainermn_tpu_torch import serializers
from chainermn_tpu_torch.training import recovery
from torch_spawn import spawn

torch.set_num_threads(2)

_BODY = r'''
import json
import os
import threading
import warnings
import torch.distributed.checkpoint as dcp
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import models, serializers, training
from chainermn_tpu_torch.models.flax_weights import _leaves
from chainermn_tpu_torch.training import recovery
from chainermn_tpu_torch.utils import failure

calls = []


def _wrap(name):
    real = getattr(dcp, name)

    def call(*args, **kw):
        pg = kw.get('process_group')
        calls.append('%s:%s' % (name, 'none' if pg is None
                                else dist.get_backend(pg)))
        return real(*args, **kw)

    setattr(dcp, name, call)


for _name in ('save', 'async_save', 'load'):
    _wrap(_name)

out, elastic_from = argv[0], argv[1]
LM = dict(vocab_size=48, d_model=32, n_heads=2, n_layers=2, d_ff=64,
          max_len=16)
rs = np.random.RandomState(3)
data = list(zip(rs.randint(0, 48, (32, 8)), rs.randint(0, 48, (32, 8))))


def lm():
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.TransformerLM(dtype=torch.bfloat16, device='cpu',
                                 **LM).to(torch.bfloat16)
    opt = cmt.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm)
    return training.StandardUpdater(
        training.SerialIterator(data, 4, shuffle=False), opt,
        models.lm_loss(model), model, comm)


ROWS = 24
gx = np.random.RandomState(1234).randn(ROWS, 8).astype(np.float32)
gy = (np.random.RandomState(99).rand(ROWS) * 4).astype(np.int64)


def zero_mlp():
    comm = cmt.create_communicator('xla', device='cpu')
    torch.manual_seed(0)
    model = models.MLP(n_units=16, n_out=4, n_in=8, device='cpu')
    return training.StandardUpdater(
        iter([]), torch.optim.Adam(model.parameters(), lr=1e-2),
        models.classifier_loss(model), model, comm, zero=True)


def zero_step(up):
    lo, hi = ROWS * rank // n, ROWS * (rank + 1) // n
    return float(up.update_core((torch.as_tensor(gx[lo:hi]),
                                 torch.as_tensor(gy[lo:hi])))['loss'])


def snap(up):
    tree = {}
    for path, v in _leaves(serializers.updater_state(up)):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu()
            v = (v.view(torch.int16) if v.dtype == torch.bfloat16
                 else v).numpy()
        tree['/'.join(path)] = np.array(v)
    return tree


def diff(a, b):
    return sorted(k for k in set(a) | set(b)
                  if k not in a or k not in b or a[k].dtype != b[k].dtype
                  or a[k].shape != b[k].shape
                  or not np.array_equal(a[k], b[k]))


def orbax(up, where, **kw):
    return recovery.PreemptionHandler(up, out=os.path.join(out, where),
                                      method='orbax', signals=(), **kw)


# the LM, synchronous: save at 2, two steps, resume, the same two steps
up = lm()
up.update()
up.update()
path = orbax(up, 'lm_sync').checkpoint()
want = snap(up)
straight = [float(up.update()['loss']) for _ in range(2)]
assert recovery.auto_resume(up, os.path.join(out, 'lm_sync')) == 2
res['sync_diff'] = np.array(diff(want, snap(up)) + ['-'])
res['sync_losses'] = np.array(
    [float(up.update()['loss']) for _ in range(2)] + straight)
res['bf16_leaves'] = sum(1 for v in want.values() if v.dtype == np.int16)
meta = dcp.FileSystemReader(path).read_metadata()
counts = {}
for index in meta.storage_data:
    counts[index.fqn] = counts.get(index.fqn, 0) + 1
res['written_twice'] = sum(1 for c in counts.values() if c > 1)
res['keys'] = len(meta.state_dict_metadata)
res['files'] = len({s.relative_path for s in meta.storage_data.values()})
with open(path + '.manifest.json') as f:
    sidecar = json.load(f)
res['sidecar_world'] = sidecar['world_size']
res['sidecar_devices'] = sidecar['device_count']
if rank == 0:
    with open(os.path.join(out, 'lm_sync', 'preempted.json')) as f:
        res['preempted_method'] = json.load(f)['method']

# asynchronous: the snapshot is the state of its step, whatever follows
handler = orbax(up, 'lm_async', async_=True)
handler.checkpoint()
want = snap(up)
for _ in range(2):
    up.update()
assert handler.wait()
assert recovery.auto_resume(up, os.path.join(out, 'lm_async')) == 4
res['async_diff'] = np.array(diff(want, snap(up)) + ['-'])
res['async_threads'] = sum(t.name == 'dcp_checkpoint'
                           for t in threading.enumerate())

# ZeRO-1: rows by rank; the same world resumes bit-equal
zu = zero_mlp()
for _ in range(2):
    zero_step(zu)
zdir = os.path.join(out, 'zero%d' % n)
step = orbax(zu, 'zero%d' % n).checkpoint()
recovery.PreemptionHandler(zu, out=zdir, signals=()).checkpoint()
want = snap(zu)
res['zero_straight'] = np.array([zero_step(zu) for _ in range(2)])
meta = dcp.FileSystemReader(step).read_metadata()
res['row_ranks'] = np.array(sorted({int(k.rpartition('@rank')[2])
                                    for k in meta.state_dict_metadata
                                    if '@rank' in k}))
with open(step + '.manifest.json') as f:
    leaves = json.load(f)['leaves']
res['stack_rows'] = np.array(sorted({
    v['shape'][0] for k, v in leaves.items()
    if k.startswith('opt_state/') and len(v['shape']) == 2}))
zu2 = zero_mlp()
assert recovery.auto_resume(zu2, zdir) == 2
res['zero_diff'] = np.array(diff(want, snap(zu2)) + ['-'])
res['zero_resumed'] = np.array([zero_step(zu2) for _ in range(2)])

if elastic_from != '-':
    # written at two processes, read at one: the raw restore and the
    # reshard, against the npz path's elastic resume
    src = os.path.join(elastic_from, 'zero2')
    a, b = zero_mlp(), zero_mlp()
    assert recovery.auto_resume(a, src) == 2
    serializers.resume_updater(os.path.join(src, 'preempt_iter_2.npz'), b)
    res['elastic_diff'] = np.array(diff(snap(a), snap(b)) + ['-'])
    res['elastic_losses'] = np.array([[zero_step(u) for _ in range(2)]
                                      for u in (a, b)])

    # a torn step (4) and a corrupt one (6) above a good one (2)
    tu = zero_mlp()
    for _ in range(3):
        zero_step(tu)
        zero_step(tu)
        orbax(tu, 'torn').checkpoint()
    steps = os.path.join(out, 'torn', 'preempt')
    os.unlink(os.path.join(steps, '4.manifest.json'))
    shard = os.path.join(steps, '6', '__0_0.distcp')
    with open(shard, 'r+b') as f:
        f.truncate(os.path.getsize(shard) // 2)
    tv = zero_mlp()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter('always')
        res['torn_resumed'] = recovery.auto_resume(
            tv, os.path.join(out, 'torn'))
    res['skipped'] = np.array(sorted(
        str(w.message).split('(')[1].split(':')[0] for w in seen
        if issubclass(w.category, failure.CheckpointSkippedWarning)))
    good = os.path.join(steps, '2')
    res['verified_world'] = serializers.verify_checkpoint(
        good, serializers.updater_state(tv, sharded=True))['world_size']
    bad = serializers.updater_state(tv, sharded=True)
    bad['params']['Dense_0']['kernel'] = np.zeros((3, 3), np.float32)
    kinds = []
    for p, t in ((good, bad), (os.path.join(steps, '4'), None)):
        try:
            serializers.verify_checkpoint(p, t)
        except failure.CheckpointCorruptError as e:
            kinds.append(e.kind)
    res['verify_kinds'] = np.array(kinds)
    res['complete'] = np.array([serializers.checkpoint_complete(
        os.path.join(steps, s)) for s in '246'])

# fault 2: the default group destroyed and made again
first = serializers.checkpoint_group()
dist.destroy_process_group()
dist.init_process_group('gloo', store=dist.FileStore(store + '.again', n),
                        rank=rank, world_size=n)
before = len(calls)
ru = lm()
ru.update()
ru.update()
orbax(ru, 'again').checkpoint()
want = snap(ru)
ru.update()
assert recovery.auto_resume(ru, os.path.join(out, 'again')) == 2
res['again_diff'] = np.array(diff(want, snap(ru)) + ['-'])
res['new_group'] = serializers.checkpoint_group() is not first
res['calls_after'] = np.array(calls[before:])
res['calls'] = np.array(calls)
'''


@pytest.fixture(scope='module')
def worlds(tmp_path_factory):
    two = tmp_path_factory.mktemp('two')
    one = tmp_path_factory.mktemp('one')
    r2 = spawn(two, _BODY, 2, [two, '-'])
    r1 = spawn(one, _BODY, 1, [one, two])
    return {2: r2, 1: r1}


def _ranks(worlds):
    return [(n, r, res) for n, rs in sorted(worlds.items())
            for r, res in enumerate(rs)]


def test_every_dcp_call_carries_a_gloo_group(worlds):
    for n, r, res in _ranks(worlds):
        calls = list(res['calls'])
        assert calls, (n, r)
        assert set(calls) <= {'save:gloo', 'load:gloo'}, (n, r, calls)
        assert {'save:gloo', 'load:gloo'} <= set(calls)


def test_side_group_is_made_anew_after_the_default_group_is(worlds):
    for n, r, res in _ranks(worlds):
        assert bool(res['new_group']), (n, r)
        after = list(res['calls_after'])
        assert 'save:gloo' in after and 'load:gloo' in after
        assert list(res['again_diff']) == ['-'], (n, r)


@pytest.mark.parametrize('mode', ['sync', 'async'])
def test_lm_state_round_trips_bit_equal(worlds, mode):
    for n, r, res in _ranks(worlds):
        assert list(res['%s_diff' % mode]) == ['-'], (n, r, mode)
        assert int(res['bf16_leaves']) > 0
    for n, rs in worlds.items():
        losses = rs[0]['sync_losses']
        assert np.array_equal(losses[:2], losses[2:]), (n, losses)


def test_async_write_leaves_no_thread_and_sidecars_name_the_world(worlds):
    for n, r, res in _ranks(worlds):
        assert int(res['async_threads']) == 0
        assert int(res['sidecar_world']) == n
        assert int(res['sidecar_devices']) == n
    assert str(worlds[1][0]['preempted_method']) == 'orbax'
    assert str(worlds[2][0]['preempted_method']) == 'orbax'


def test_replicated_keys_are_written_once(worlds):
    for n, r, res in _ranks(worlds):
        assert int(res['written_twice']) == 0, (n, r)
    assert int(worlds[2][0]['files']) == 2      # each process wrote a part


def test_zero_rows_are_written_by_their_own_process(worlds):
    for n, r, res in _ranks(worlds):
        assert list(res['row_ranks']) == list(range(n))
        assert list(res['stack_rows']) == [n]
        assert list(res['zero_diff']) == ['-'], (n, r)
        assert np.array_equal(res['zero_straight'], res['zero_resumed'])


def test_zero_two_to_one_matches_the_npz_elastic_resume(worlds):
    res = worlds[1][0]
    assert list(res['elastic_diff']) == ['-']
    a, b = res['elastic_losses']
    assert np.array_equal(a, b)
    # and it continues the two-process run's trajectory (the global
    # batch is the same at both sizes; only the reduction order differs)
    np.testing.assert_allclose(a, worlds[2][0]['zero_straight'], rtol=1e-5)


def test_torn_and_corrupt_steps_are_skipped(worlds):
    res = worlds[1][0]
    assert int(res['torn_resumed']) == 2
    assert list(res['skipped']) == ['incomplete', 'unreadable']
    assert list(res['complete']) == [True, False, True]


def test_verify_checkpoint_of_a_step_directory(worlds):
    res = worlds[1][0]
    assert int(res['verified_world']) == 1
    assert list(res['verify_kinds']) == ['shape', 'incomplete']


def test_chain_lists_step_directories(tmp_path):
    steps = tmp_path / 'preempt'
    for it in (3, 5):
        (steps / str(it)).mkdir(parents=True)
    (steps / '5.manifest.json').write_text(json.dumps({'complete': True}))
    (tmp_path / 'snapshot_iter_4.npz').write_bytes(b'')
    chain = recovery.snapshot_chain(str(tmp_path))
    assert [(k, it) for k, _, it in chain] == [
        ('orbax', 5), ('npz', 4), ('orbax', 3)]
    assert [it for _, _, it, _ in recovery.chain_heads(str(tmp_path))] == [5]
    assert recovery.latest_snapshot(str(tmp_path))[0] == 'orbax'
    assert serializers.checkpoint_complete(str(steps / '5'))
    assert not serializers.checkpoint_complete(str(steps / '3'))
