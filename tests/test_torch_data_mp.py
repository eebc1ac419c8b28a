"""The port's streaming loader across gloo processes: the twins of
``tests/test_data_mp.py``'s two pins, run by
``tests/torch_data_stream_worker.py`` on the port alone, from the JAX
package's MLP initialisation.

- ``stream_elastic``: streamed training at 3 processes, SIGTERM
  mid-epoch (the chaos injector; the npz snapshot carries the exact
  stream cursor), the resume at 2 processes: the per-rank sample-id
  ledgers of both phases tile the 2-process oracle's stream exactly
  (each (epoch, position) consumed once, with the oracle's id), and the
  losses are within 1e-4 of the oracle's.
- convergence under chaos: one ``python -m chainermn_tpu_torch.supervisor
  --device cpu`` run trains the learnable streamed set to its target loss
  while chaos kills rank 1; the supervisor shrinks 3 -> 2 and resumes
  from the periodic checkpoint, and the ids consumed over all attempts
  cover epoch 0 exactly, each position with the oracle stream's id.

These run only on the CPU: one card cannot hold three NCCL processes.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from chainermn_tpu.models import MLP as JaxMLP
from chainermn_tpu_torch.data import stream_order
from chainermn_tpu_torch.utils.ledger import Ledger
from torch_spawn import save_tree

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, 'tests', 'torch_data_stream_worker.py')

N_TOTAL = 48
GLOBAL_BATCH = 12
SEED = 5


def _free_port():
    s = socket.socket()
    s.bind(('localhost', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(tmp_path):
    """The workers' environment, with the JAX MLP's initial weights."""
    path = tmp_path / 'params.npz'
    if not path.exists():
        params = jax.device_get(JaxMLP(n_units=16, n_out=4).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.float32))['params'])
        save_tree(path, {'params': params})
    env = {k: v for k, v in os.environ.items()
           if k not in ('CHAINERMN_TPU_CHAOS', 'CHAINERMN_TPU_TELEMETRY')}
    env.update(PYTHONPATH=ROOT + os.pathsep + env.get('PYTHONPATH', ''),
               OMP_NUM_THREADS='1', CMN_DATA_PARAMS=str(path))
    return env


def _spawn(nprocs, outdir, extra_env=None, timeout=240):
    port = _free_port()
    base = _env(outdir)
    procs = []
    for r in range(nprocs):
        env = dict(base, CMN_MP_RANK=str(r), CMN_MP_NPROCS=str(nprocs),
                   CMN_MP_PORT=str(port), CMN_MP_OUT=str(outdir))
        env.update({k: str(v) for k, v in (extra_env or {}).items()})
        procs.append(subprocess.Popen(
            [sys.executable, WORKER], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outputs = []
    try:
        for p in procs:
            outputs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    results = {}
    for r, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, 'worker %d failed (rc=%r):\n%s' % (
            r, p.returncode, out)
        with open(os.path.join(str(outdir), 'rank%d.json' % r)) as f:
            results[r] = json.load(f)
    return results


def _merge_positions(ledger_lists):
    """``{(epoch, position): id}`` over every ledger entry (no position
    may take two ids), and the number of position records seen."""
    posid, records = {}, 0
    for entries in ledger_lists:
        for e in entries:
            for p, i in zip(e['positions'], e['ids']):
                key = (e['epoch'], int(p))
                prev = posid.get(key)
                assert prev is None or prev == int(i), (key, prev, i)
                posid[key] = int(i)
                records += 1
    return posid, records


def test_stream_elastic_sigterm_3_to_2_exact_stream(tmp_path):
    steps = 8  # x GLOBAL_BATCH = 96 samples = 2 epochs of 48
    first = _spawn(3, tmp_path, {'CHAINERMN_TPU_CHAOS':
                                 'seed=1;sigterm_step=@1',
                                 'CMN_MP_STEPS': steps})
    for r in range(3):
        assert first[r]['preempted_at'] == 2, first[r]
        assert first[r]['preempt_state'] == {'epoch': 0, 'cursor': 24}
        assert len(first[r]['losses']) == 2
    for r in (1, 2):
        np.testing.assert_allclose(first[0]['losses'], first[r]['losses'],
                                   atol=1e-6)
    second = _spawn(2, tmp_path, {'CMN_MP_PHASE': 'resume',
                                  'CMN_MP_STEPS': steps})
    for r in (0, 1):
        res = second[r]
        assert res['resumed_at'] == 2, res
        assert res['resume_state'] == {'epoch': 0, 'cursor': 24}
        assert res['final_iteration'] == steps
        full = first[0]['losses'] + res['losses']
        np.testing.assert_allclose(full, res['oracle'], rtol=0, atol=1e-4)
    assert abs(second[0]['param_sum'] - second[1]['param_sum']) < 1e-5
    posid, records = _merge_positions(
        [first[r]['ledger'] for r in range(3)]
        + [second[r]['ledger'] for r in range(2)])
    assert records == 2 * N_TOTAL
    assert set(posid) == {(e, p) for e in range(2) for p in range(N_TOTAL)}
    oracle_posid, oracle_records = _merge_positions(
        [second[r]['oracle_ledger'] for r in range(2)])
    assert oracle_records == 2 * N_TOTAL
    assert posid == oracle_posid
    for e in range(2):
        ids = [i for (ep, _), i in posid.items() if ep == e]
        assert sorted(ids) == list(range(N_TOTAL))


def test_convergence_under_chaos_supervisor_heals_and_converges(tmp_path):
    out = tmp_path / 'run'
    env = _env(tmp_path)
    env['CHAINERMN_TPU_CHAOS'] = 'rank=1;kill_step=@2'
    env['CMN_DATA_TARGET_LOSS'] = '1.25'
    proc = subprocess.run(
        [sys.executable, '-m', 'chainermn_tpu_torch.supervisor',
         '-n', '3', '--out', str(out), '--steps', '16',
         '--ckpt-every', '2', '--stall-timeout', '90',
         '--startup-grace', '180', '--term-grace', '6',
         '--drain-grace', '3', '--backoff-initial', '0.2',
         '--attempt-timeout', '360', '--device', 'cpu',
         '--', sys.executable, WORKER],
        env=env, capture_output=True, text=True, timeout=600)
    ledger = Ledger.read(os.path.join(str(out), 'supervisor_ledger.jsonl'))
    assert proc.returncode == 0, (proc.stdout + proc.stderr + '\n'
                                  + json.dumps(ledger))
    fails = [e for e in ledger if e['event'] == 'failure']
    assert len(fails) == 1 and fails[0]['rank'] == 1, fails
    assert fails[0]['chaos_site'] == 'kill_step'
    decs = [e for e in ledger if e['event'] == 'decision']
    assert decs[0]['action'] == 'shrink'
    assert (decs[0]['world_before'], decs[0]['world_after']) == (3, 2)
    comps = [e for e in ledger if e['event'] == 'complete']
    assert len(comps) == 1 and comps[0]['world_size'] == 2
    for r in range(2):
        with open(os.path.join(str(out), 'workers', 'a%d-rank%d.json'
                               % (comps[0]['attempt'], r))) as f:
            res = json.load(f)
        assert res['reached_target'] is True, res
        assert res['final_loss'] <= 1.25
        assert res['epochs_completed'] >= 1
        assert res['corrupt_skipped'] == 0
    entries = []
    for path in sorted(glob.glob(os.path.join(str(out), 'ledgers',
                                              'a*-rank*.jsonl'))):
        with open(path) as f:
            for line in f:
                try:
                    entries.append(json.loads(line))
                except ValueError:
                    pass  # the torn tail of a killed rank's last write
    assert entries
    posid, _ = _merge_positions([entries])
    epoch0 = {p: i for (e, p), i in posid.items() if e == 0}
    assert set(epoch0) == set(range(N_TOTAL))
    order = stream_order(N_TOTAL, SEED, 0)
    for p, i in epoch0.items():
        assert int(order[p]) == i, (p, i, int(order[p]))
    assert sorted(epoch0.values()) == list(range(N_TOTAL))
