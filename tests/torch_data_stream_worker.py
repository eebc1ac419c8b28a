"""Worker of the port's streaming-loader multi-process scenarios
(``tests/test_torch_data_mp.py``), the twin of
``tests/data_stream_worker.py`` on the port alone: gloo processes train
an MLP fed by :class:`chainermn_tpu_torch.data.StreamingLoader` over
record shards, each rank appending its sample-id ledger, fsynced, so
that it survives a kill.

Two launch modes, one train loop:

- ``CMN_MP_*`` (the test's own launcher): ``stream_elastic`` --
  SIGTERM mid-epoch at N processes through the chaos injector, the npz
  preemption snapshot with the exact stream cursor, the resume at M
  processes; the fixed-topology oracle (losses and id stream) runs
  chaos-shielded in the resume phase;
- ``CMN_SUP_*`` (``python -m chainermn_tpu_torch.supervisor``): the
  convergence-under-chaos worker -- peer liveness into the live
  directory, ``auto_resume`` of the shared checkpoint directory
  (elastically when the world shrank), training to a target loss while
  the supervisor heals the injected death, and ``worker_main``'s typed
  exit codes.

The data is deterministic and learnable (the labels are a fixed linear
rule of the inputs).  The MLP starts from the flax weights the test
writes (``CMN_DATA_PARAMS``, an npz of ``params/...`` keys).
"""

import json
import os
import sys

N_TOTAL = 48        # epoch id set: range(48)
GLOBAL_BATCH = 12   # divisible by 2 and 3 processes
N_SHARDS = 3
SEED = 5
PARAMS_ENV = 'CMN_DATA_PARAMS'


def make_examples():
    """The deterministic learnable dataset: y = argmax(x @ W_true)."""
    import numpy as np
    rs = np.random.RandomState(1234)
    xs = rs.randn(N_TOTAL, 8).astype(np.float32)
    w_true = np.random.RandomState(77).randn(8, 4).astype(np.float32)
    ys = np.argmax(xs @ w_true, axis=1).astype(np.int32)
    return [(xs[i], ys[i]) for i in range(N_TOTAL)]


def ensure_shards(dirpath):
    """Write the shard set if absent (every rank its own directory)."""
    import glob
    from chainermn_tpu_torch.data import ShardSet, write_examples
    if not sorted(glob.glob(os.path.join(dirpath, '*.rec'))):
        write_examples(make_examples(), dirpath, n_shards=N_SHARDS)
    return ShardSet.from_dir(dirpath)


def _params():
    import numpy as np
    tree = {}
    with np.load(os.environ[PARAMS_ENV]) as data:
        for key in data.files:
            node = tree
            parts = key.split('/')
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return tree


def build_train(comm, loader):
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import models, training
    model = models.MLP(n_units=16, n_out=4, n_in=8, device='cpu')
    models.load_flax_variables(model, _params())
    opt = cmt.create_multi_node_optimizer(
        torch.optim.SGD(model.parameters(), lr=0.2, momentum=0.9), comm)
    return training.StandardUpdater(loader, opt,
                                    models.classifier_loss(model), model,
                                    comm)


def _batch(loader):
    import numpy as np
    import torch
    batch = next(loader)
    xs = np.stack([np.asarray(b[0]) for b in batch])
    ys = np.stack([np.asarray(b[1]) for b in batch]).astype(np.int64)
    return torch.as_tensor(xs), torch.as_tensor(ys)


def step_streamed(upd, loader):
    """One step over this rank's slice of the global batch; the loss is
    the mean over the ranks (``update_core``'s metrics)."""
    return float(upd.update_core(_batch(loader))['loss'])


def make_loader(shards, nprocs, rank, ledger_path=None):
    from chainermn_tpu_torch.data import StreamingLoader
    return StreamingLoader(
        shards, GLOBAL_BATCH, size=nprocs, rank=rank, seed=SEED,
        n_workers=2, prefetch=2, ledger_path=ledger_path)


def _param_sum(upd):
    from chainermn_tpu_torch.models.flax_weights import _leaves
    return float(sum(float(leaf.sum()) for _, leaf in _leaves(upd.params)))


def oracle_run(rank, nprocs, comm, shard_dir, steps):
    """The fixed-topology oracle at this world size: a fresh loader and
    updater stepped ``steps`` times, chaos-shielded.  Returns ``(losses,
    ledger entries, final parameter sum)``."""
    from chainermn_tpu_torch.utils import chaos
    saved = chaos.active()
    chaos.uninstall()
    try:
        loader = make_loader(ensure_shards(shard_dir), nprocs, rank)
        upd = build_train(comm, loader)
        losses = [step_streamed(upd, loader) for _ in range(steps)]
        psum = _param_sum(upd)
        ledger = list(loader.ledger)
        loader.finalize()
        return losses, ledger, psum
    finally:
        if saved is not None:
            chaos.install(saved)


def mp_main():
    import datetime
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    rank = int(os.environ['CMN_MP_RANK'])
    nprocs = int(os.environ['CMN_MP_NPROCS'])
    outdir = os.environ['CMN_MP_OUT']
    phase = os.environ.get('CMN_MP_PHASE', 'first')
    steps = int(os.environ.get('CMN_MP_STEPS', '8'))
    dist.init_process_group(
        'gloo', init_method='tcp://127.0.0.1:%s' % os.environ['CMN_MP_PORT'],
        rank=rank, world_size=nprocs,
        timeout=datetime.timedelta(seconds=120))

    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch.training import recovery
    from chainermn_tpu_torch.utils import chaos

    chaos.maybe_install_from_env()
    comm = cmt.create_communicator('xla', device='cpu')
    shard_dir = os.path.join(outdir, 'shards-rank%d' % rank)
    ckdir = os.path.join(outdir, 'stream_state')
    res = {'rank': rank, 'world': nprocs, 'phase': phase}

    loader = make_loader(ensure_shards(shard_dir), nprocs, rank)
    upd = build_train(comm, loader)
    handler = recovery.PreemptionHandler(upd, out=ckdir, method='npz')
    if phase == 'resume':
        res['oracle'], res['oracle_ledger'], res['oracle_param_sum'] \
            = oracle_run(rank, nprocs, comm, shard_dir, steps)
        res['resumed_at'] = recovery.auto_resume(upd, ckdir)
        res['resume_state'] = loader.state()
    losses = []
    while upd.iteration < steps:
        losses.append(step_streamed(upd, loader))
        if handler.maybe_checkpoint():
            res['preempted_at'] = upd.iteration
            res['preempt_state'] = loader.state()
            break
    res.update(losses=losses, final_iteration=upd.iteration,
               ledger=list(loader.ledger), param_sum=_param_sum(upd))
    loader.finalize()
    with open(os.path.join(outdir, 'rank%d.json' % rank), 'w') as f:
        json.dump(res, f)
        f.flush()
        os.fsync(f.fileno())
    dist.destroy_process_group()


def supervised_worker():
    import torch
    import chainermn_tpu_torch as cmt
    from chainermn_tpu_torch import serializers, telemetry
    from chainermn_tpu_torch.training import recovery
    from chainermn_tpu_torch.training import supervisor as sup
    from chainermn_tpu_torch.utils import failure
    torch.set_num_threads(1)

    device = sup.handout_device()
    rank, nprocs = sup.init_process_group(device)
    out = os.environ[sup.ENV_OUT]
    attempt = int(os.environ.get(sup.ENV_ATTEMPT, '0'))
    steps = int(os.environ.get(sup.ENV_STEPS, '16'))
    ckpt_every = int(os.environ.get(sup.ENV_CKPT_EVERY, '2'))
    live = os.environ.get(sup.ENV_LIVE) or os.path.join(out, 'live')
    target = float(os.environ.get('CMN_DATA_TARGET_LOSS', '1.25'))

    comm = cmt.create_communicator('xla', device=device)
    hb = comm.enable_peer_liveness(live, interval=0.2, stall_timeout=1.0)
    shard_dir = os.path.join(out, 'shards-rank%d' % rank)
    ledger_dir = os.path.join(out, 'ledgers')
    os.makedirs(ledger_dir, exist_ok=True)
    loader = make_loader(
        ensure_shards(shard_dir), nprocs, rank,
        ledger_path=os.path.join(ledger_dir,
                                 'a%d-rank%d.jsonl' % (attempt, rank)))
    upd = build_train(comm, loader)
    ckdir = os.path.join(out, 'state')
    handler = recovery.PreemptionHandler(upd, out=ckdir, method='npz')
    res = {'rank': rank, 'attempt': attempt, 'world_size': nprocs,
           'steps': steps, 'target_loss': target}
    try:
        resumed_at = recovery.auto_resume(upd, ckdir)
        if resumed_at is None and recovery.snapshot_chain(ckdir):
            raise failure.CheckpointCorruptError(
                'restart found snapshots under %s but none valid -- '
                'refusing to train from scratch' % ckdir,
                path=ckdir, kind='crc')
        res['resumed_at'] = resumed_at
        res['resume_state'] = loader.state()
        sup.write_worker_json(out, attempt, rank, res)   # early
        hb.beat(upd.iteration)
        losses, preempted = [], False
        while upd.iteration < steps:
            # a peer's death becomes a typed PeerDeadError naming it
            loss = sup._demo_step(upd, _batch(loader))
            losses.append(loss)
            hb.beat(upd.iteration)
            if handler.maybe_checkpoint():
                preempted = True
                break
            # the loss is the ranks' mean: every rank stops in lockstep
            if loss <= target and loader.epoch >= 1:
                break
            if (ckpt_every and upd.iteration < steps
                    and upd.iteration % ckpt_every == 0):
                handler.checkpoint()
        res.update(losses=losses, final_loss=losses[-1] if losses else None,
                   final_iteration=upd.iteration,
                   epochs_completed=loader.epoch,
                   corrupt_skipped=loader.corrupt_skipped,
                   preempted=preempted,
                   reached_target=bool(losses and losses[-1] <= target),
                   param_sum=_param_sum(upd))
        sup.write_worker_json(out, attempt, rank, res)
    finally:
        hb.stop()
        loader.finalize()
    serializers.wait_checkpoints()
    telemetry.flush()
    return 'preempted' if preempted else None


def main():
    if os.environ.get('CMN_SUP_RANK') is not None:
        from chainermn_tpu_torch.training.supervisor import worker_main
        worker_main(supervised_worker)  # never returns
    mp_main()
    sys.stdout.flush()


if __name__ == '__main__':
    main()
