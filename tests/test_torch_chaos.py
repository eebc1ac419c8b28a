"""The port's fault injector against the JAX package's ``utils/chaos.py``.

- ``parse_spec`` of a table of specs (and its refusals) is the JAX one's;
- two port injectors with the same spec and seed log the same decisions
  over 1,000 occurrences of every site, and so does JAX's
  ``FaultInjector``; ``strip_sites`` is the JAX one's;
- ``corrupt_record``, ``corrupt_batch`` and ``corrupt_checkpoint`` give
  byte-identical output to the JAX hooks on the same input;
- ``ckpt_truncate`` / ``ckpt_flip`` fired inside the port's ``save_npz``
  make ``read_npz`` raise ``CheckpointCorruptError`` as the JAX reader
  does (the same kind, leaf and path), a single flip in a leaf's bytes
  naming that leaf's member; ``data_corrupt`` makes the port's shard
  reader raise ``DataCorruptError`` with the shard and offset that the
  JAX reader names on the same shard files;
- the wired sites: ``on_step`` in the updater (``nan_batch`` through the
  collation), the object channel's ``drop_send`` / ``dup_send`` /
  ``stall_kv`` (a message still delivered exactly once), an injected
  fault's ``chaos:<site>`` telemetry event, ``maybe_install_from_env``'s
  rank gate.
"""

import shutil

import numpy as np
import pytest
import torch

from chainermn_tpu import serializers as jserializers
from chainermn_tpu.data import recordio as jrecordio
from chainermn_tpu.utils import chaos as jchaos
from chainermn_tpu.utils import failure as jfailure
import chainermn_tpu_torch as cmt
from chainermn_tpu_torch import models, serializers, telemetry, training
from chainermn_tpu_torch.data import recordio
from chainermn_tpu_torch.utils import chaos, failure

torch.set_num_threads(1)

SPECS = [
    'seed=9;rank=1;drop_send=@0,2;delay_send=p0.25:0.05;stall_kv=*;'
    'kill_step=@5:7',
    'seed=7;drop_send=@0;delay_send=p0.5:0.02;stall_kv=p0.5:0.05;'
    'sigterm_step=@3',
    ' nan_batch = @1 : 3 ; ckpt_flip=p0.1;;slice_loss=@2:1',
    'serve_burst=*:2;serve_cancel=@0;swap_kill=p1;replica_kill=@4:1',
    'data_stall=p0.3;data_corrupt=@1,2,3;extra_collective=*;'
    'serve_longprompt=@0;serve_slow=p0.9:0.001',
    'hang_step=@4;ckpt_kill=@0:43;ckpt_stall=*;ckpt_truncate=@1:0.25;'
    'kill_recv=@2;dup_send=p0.75',
    '',
]
BAD = ['no_such_site=@0', 'drop_send=q1', 'drop_send=p1.5',
       'drop_send=@x', 'seed=abc']


def _rules(rules):
    return {k: (r.site, r.prob, r.at, r.always, r.arg)
            for k, r in rules.items()}


@pytest.fixture(autouse=True)
def _clean():
    chaos.uninstall()
    jchaos.uninstall()
    yield
    chaos.uninstall()
    jchaos.uninstall()
    telemetry.disable()


@pytest.mark.parametrize('spec', SPECS)
def test_parse_spec_matches_jax(spec):
    seed, rank, rules = chaos.parse_spec(spec)
    jseed, jrank, jrules = jchaos.parse_spec(spec)
    assert (seed, rank) == (jseed, jrank)
    assert _rules(rules) == _rules(jrules)


@pytest.mark.parametrize('spec', BAD)
def test_parse_spec_refuses_what_jax_refuses(spec):
    with pytest.raises(ValueError):
        jchaos.parse_spec(spec)
    with pytest.raises(ValueError):
        chaos.parse_spec(spec)


def test_sites_match_jax():
    assert chaos.SITES == jchaos.SITES
    assert (chaos.ENV_VAR, chaos.SLICE_ENV_VAR, chaos.REPLICA_ENV_VAR) == (
        jchaos.ENV_VAR, jchaos.SLICE_ENV_VAR, jchaos.REPLICA_ENV_VAR)


@pytest.mark.parametrize('seed', [0, 7, 2 ** 40 + 3])
def test_injector_logs_match_jax(seed):
    spec = ';'.join(['%s=p0.%d' % (s, 1 + i % 9)
                     for i, s in enumerate(chaos.SITES)]
                    + ['seed=%d' % seed])
    a, b = chaos.FaultInjector(spec), chaos.FaultInjector(spec)
    j = jchaos.FaultInjector(spec)
    for _ in range(1000):
        for site in chaos.SITES:
            a.fires(site), b.fires(site), j.fires(site)
    assert a.log == b.log == j.log
    assert a.counts() == j.counts()
    hits = sum(h for _, _, h in a.log)
    assert 0 < hits < len(a.log)
    # a seed given apart overrides the spec's, in both packages
    c = chaos.FaultInjector('drop_send=p0.5', seed=seed)
    jc = jchaos.FaultInjector('drop_send=p0.5', seed=seed)
    for _ in range(1000):
        c.fires('drop_send'), jc.fires('drop_send')
    assert c.log == jc.log


def test_strip_sites_matches_jax():
    for spec in SPECS:
        for sites in (['kill_step'], ['drop_send', 'stall_kv'], ['nope'],
                      list(chaos.SITES)):
            assert chaos.strip_sites(spec, sites) == \
                jchaos.strip_sites(spec, sites)
    assert chaos.strip_sites('kill_step=@3', ['kill_step']) == ''


@pytest.mark.parametrize('arg', ['', ':1', ':3', ':64'])
def test_corrupt_record_is_byte_identical(arg):
    payload = bytes(range(256)) * 3 + b'tail'
    for p in (payload, b'x', b''):
        chaos.install(chaos.FaultInjector('data_corrupt=*' + arg))
        jchaos.install(jchaos.FaultInjector('data_corrupt=*' + arg))
        got, want = chaos.corrupt_record(p), jchaos.corrupt_record(p)
        assert got == want
        if p == payload:
            assert got != p


@pytest.mark.parametrize('arg', ['', ':1', ':5'])
def test_corrupt_batch_is_identical(arg):
    rng = np.random.RandomState(0)
    batch = (rng.randint(0, 9, (4, 3)).astype(np.int32),
             rng.randn(4, 3).astype(np.float32),
             rng.randn(4).astype(np.float64))
    chaos.install(chaos.FaultInjector('nan_batch=*' + arg))
    jchaos.install(jchaos.FaultInjector('nan_batch=*' + arg))
    for b in (batch, list(batch)):
        got, want = chaos.corrupt_batch(b), jchaos.corrupt_batch(b)
        assert type(got) is type(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    assert np.isfinite(batch[1]).all()          # the caller's arrays kept
    # a torch column (a policy's collation) is poisoned the same way
    tbatch = (torch.as_tensor(batch[0]),
              torch.as_tensor(batch[1]).to(torch.bfloat16))
    got = chaos.corrupt_batch(tbatch)
    n = int(arg[1:]) if arg else 1
    assert torch.isnan(got[1].float().reshape(-1)[:n]).all()
    assert not torch.isnan(got[1].float().reshape(-1)[n:]).any()
    assert torch.isfinite(tbatch[1].float()).all()


def _tree():
    rng = np.random.RandomState(1)
    return {'w': {'kernel': rng.randn(64, 64).astype(np.float32)},
            'b': np.arange(3, dtype=np.int32)}


@pytest.mark.parametrize('spec', ['ckpt_truncate=@0', 'ckpt_truncate=@0:0.9',
                                  'ckpt_flip=@0', 'ckpt_flip=@0:1'])
def test_corrupt_checkpoint_is_byte_identical(spec, tmp_path):
    src = str(tmp_path / 'src.npz')
    jserializers.save_npz(src, _tree())
    mine, theirs = str(tmp_path / 'mine.npz'), str(tmp_path / 'theirs.npz')
    shutil.copy(src, mine)
    shutil.copy(src, theirs)
    chaos.install(chaos.FaultInjector(spec))
    jchaos.install(jchaos.FaultInjector(spec))
    chaos.corrupt_checkpoint(mine)
    jchaos.corrupt_checkpoint(theirs)
    with open(mine, 'rb') as a, open(theirs, 'rb') as b:
        assert a.read() == b.read()


@pytest.mark.parametrize('spec', ['ckpt_truncate=@0', 'ckpt_flip=@0',
                                  'ckpt_flip=@0:1'])
def test_save_npz_corruption_sites_raise_typed(spec, tmp_path):
    chaos.install(chaos.FaultInjector(spec))
    path = serializers.save_npz(str(tmp_path / 'snap'), _tree())
    assert chaos.active().log == [(spec.split('=')[0], 0, True)]
    chaos.uninstall()
    with pytest.raises(failure.CheckpointCorruptError) as ei:
        serializers.read_npz(path)
    with pytest.raises(jfailure.CheckpointCorruptError) as ej:
        jserializers.read_npz(path)
    assert (ei.value.kind, ei.value.leaf, ei.value.path) == (
        ej.value.kind, ej.value.leaf, ej.value.path)
    if spec == 'ckpt_flip=@0:1':
        # one byte inside the big leaf: the archive's own crc of that
        # member fails first, and the error names it
        assert "'w/kernel.npy'" in str(ei.value)
        assert "'w/kernel.npy'" in str(ej.value)
    if spec.startswith('ckpt_truncate'):
        assert serializers.checkpoint_complete(path) is False


def test_ckpt_kill_leaves_no_final_file(tmp_path, monkeypatch):
    exits = []

    def fake_exit(code):
        exits.append(code)
        raise SystemExit(code)

    monkeypatch.setattr(chaos.os, '_exit', fake_exit)
    serializers.save_npz(str(tmp_path / 'prev'), _tree())
    chaos.install(chaos.FaultInjector('ckpt_kill=@0'))
    with pytest.raises(SystemExit):
        serializers.save_npz(str(tmp_path / 'snap'), _tree())
    assert exits == [43]
    assert not (tmp_path / 'snap.npz').exists()
    assert (tmp_path / 'snap.npz.tmp').exists()
    assert serializers.checkpoint_complete(str(tmp_path / 'prev.npz'))


def test_data_corrupt_names_the_shard_and_offset_jax_names(tmp_path):
    examples = [(np.full(5, i, np.float32), np.int32(i)) for i in range(6)]
    paths = jrecordio.write_examples(examples, str(tmp_path), n_shards=2)
    for path in paths:
        reader, jreader = recordio.ShardReader(path), \
            jrecordio.ShardReader(path)
        for i in range(len(reader)):
            chaos.install(chaos.FaultInjector('data_corrupt=*'))
            jchaos.install(jchaos.FaultInjector('data_corrupt=*'))
            with pytest.raises(failure.DataCorruptError) as ei:
                reader.read(i)
            with pytest.raises(jfailure.DataCorruptError) as ej:
                jreader.read(i)
            got, want = ei.value, ej.value
            assert (got.shard, got.offset, got.record, got.kind) == (
                want.shard, want.offset, want.record, want.kind)
            assert got.kind == 'crc' and got.shard == path
            chaos.uninstall()
            jchaos.uninstall()
            assert reader.read(i) == jreader.read(i)
    # data_stall sleeps before the read
    slept = []
    chaos.install(chaos.FaultInjector('data_stall=@0:0.25'))
    orig = chaos.time.sleep
    chaos.time.sleep = slept.append
    try:
        recordio.ShardReader(paths[0]).read(0)
    finally:
        chaos.time.sleep = orig
    assert slept == [0.25]


def test_updater_sites_fire_where_jax_fires_them(monkeypatch):
    comm = cmt.create_communicator('xla', device='cpu')
    model = models.MLP(n_units=8, n_out=3, n_in=4, device='cpu')
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.1), comm)
    rng = np.random.RandomState(0)
    data = list(zip(rng.randn(8, 4).astype(np.float32),
                    rng.randint(0, 3, 8).astype(np.int32)))
    up = training.StandardUpdater(
        training.SerialIterator(data, 4, shuffle=False), opt,
        models.Classifier(model), model, comm)
    seen = []
    monkeypatch.setattr(chaos.time, 'sleep', seen.append)
    telemetry.enable()
    chaos.install(chaos.FaultInjector('hang_step=@1:0.5;nan_batch=@2'))
    for _ in range(3):
        m = up.update()
    assert seen == [0.5]                   # at update_core occurrence 1
    assert not np.isfinite(m['loss'])      # the poisoned third batch
    log = chaos.active().log
    assert [e for e in log if e[0] == 'hang_step'] == [
        ('hang_step', 0, False), ('hang_step', 1, True),
        ('hang_step', 2, False)]
    names = [e['name'] for e in telemetry.active().events
             if e.get('kind') == 'chaos']
    assert names == ['chaos:hang_step', 'chaos:nan_batch']


def test_channel_sites_deliver_exactly_once(monkeypatch):
    comm = cmt.create_communicator('xla', device='cpu')
    monkeypatch.setattr(chaos.time, 'sleep', lambda s: None)
    chaos.install(chaos.FaultInjector(
        'drop_send=@0;dup_send=@0;stall_kv=@0,1;delay_send=@1'))
    comm.send_obj({'a': 1}, dest=comm.rank, tag=3)
    comm.send_obj([2], dest=comm.rank, tag=3)
    assert comm.recv_obj(comm.rank, tag=3, timeout=5) == {'a': 1}
    assert comm.recv_obj(comm.rank, tag=3, timeout=5) == [2]
    with pytest.raises(failure.ChannelTimeout):
        comm.recv_obj(comm.rank, tag=3, timeout=0.2)
    fired = sorted({s for s, _, hit in chaos.active().log if hit})
    assert fired == ['delay_send', 'drop_send', 'dup_send', 'stall_kv']


def test_install_from_env_rank_gate(monkeypatch):
    monkeypatch.setenv(chaos.ENV_VAR, 'seed=3;drop_send=@0')
    inj = chaos.maybe_install_from_env()
    assert inj is not None and chaos.active() is inj and inj.seed == 3
    chaos.uninstall()
    monkeypatch.setenv(chaos.ENV_VAR, 'rank=999;drop_send=@0')
    assert chaos.maybe_install_from_env() is None
    chaos.uninstall()
    monkeypatch.delenv(chaos.ENV_VAR)
    monkeypatch.setenv(chaos.SLICE_ENV_VAR, '2')
    assert chaos.slice_id() == 2 and chaos.maybe_install_from_env() is None
