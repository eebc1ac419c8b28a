"""The port's fleet over real subprocess replicas, on the CPU.

One ``python -m chainermn_tpu_torch.serving.fleet --device cpu``
invocation per scenario: the controller trains the demo LM for real
steps, snapshots with the manifest and its sentinel, boots two replica
worker processes (newline JSON over a local socket), serves open-loop
traffic through the canary-routing front and rolls each new snapshot,
with every verdict read from ``fleet_ledger.jsonl``, as the JAX package's
``tests/test_fleet_mp.py`` reads its own:

- **promote** (tier 1): a healthy snapshot rolls canary -> promote with
  nothing shed;
- **canary breach -> rollback**, **swap_kill mid-roll -> restart
  convergence**, **replica_kill -> exact-replay requeue and respawn** and
  the **crash loop -> abort**: marked ``slow`` as in the JAX package,
  because each boots three or more interpreters and the restart scenario
  runs the CLI twice (about 20-40 s each on the CPU).
"""

import json
import os
import subprocess
import sys

import pytest

from chainermn_tpu_torch.serving.fleet import LEDGER_NAME
from chainermn_tpu_torch.utils.ledger import Ledger, events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAST_FLAGS = ['--device', 'cpu', '--replicas', '2', '--rate', '25',
              '--debounce', '0.2', '--duration', '1', '--boot-steps', '2',
              '--steps-per-roll', '2', '--roll-timeout', '120']


def _run_fleet(out, args, chaos=None, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if k not in ('CHAINERMN_TPU_CHAOS', 'CHAINERMN_TPU_TELEMETRY',
                        'CHAINERMN_TPU_REPLICA')}
    env['PYTHONPATH'] = ROOT + os.pathsep + env.get('PYTHONPATH', '')
    if chaos:
        env['CHAINERMN_TPU_CHAOS'] = chaos
    proc = subprocess.run(
        [sys.executable, '-m', 'chainermn_tpu_torch.serving.fleet',
         '--out', str(out)] + FAST_FLAGS + args,
        env=env, capture_output=True, text=True, timeout=timeout)
    ledger = Ledger.read(os.path.join(str(out), LEDGER_NAME))
    return proc, ledger


def _summary(proc):
    for line in reversed(proc.stdout.strip().splitlines()):
        try:
            return json.loads(line)
        except ValueError:
            continue
    raise AssertionError('no summary JSON in output:\n%s\n%s'
                         % (proc.stdout, proc.stderr))


def test_roll_promotes_under_live_traffic_zero_sheds(tmp_path):
    out = tmp_path / 'run'
    # a healthy canary on a loaded CPU must not breach on scheduling
    # noise: the judge's floor sits above it
    proc, ledger = _run_fleet(out, ['--rolls', '1',
                                    '--canary-seconds', '2.5',
                                    '--latency-floor-ms', '250'])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = _summary(proc)
    assert [e['event'] for e in ledger] == [
        'start', 'version_seen', 'roll_start', 'replica_swap',
        'canary_verdict', 'replica_swap', 'promote', 'converged',
        'complete']
    swaps = events(ledger, 'replica_swap')
    assert {s['replica'] for s in swaps} == {'replica-0', 'replica-1'}
    assert all(s['ok'] and s['shed_during_swap'] == 0 and s['drained']
               for s in swaps)
    comp = events(ledger, 'complete')[0]
    assert (comp['promotes'], comp['rollbacks']) == (1, 0)
    assert comp['dropped_during_swap'] == 0
    traffic = comp['traffic']
    assert traffic['served'] == traffic['offered'] > 0
    assert traffic['shed_submit'] == traffic['shed_result'] == 0
    assert summary['version'] == 4
    conv = events(ledger, 'converged')[0]
    assert conv['version'] == 4 and set(conv['replicas'].values()) == {4}
    # each replica process served from its own engine and recorder
    for name in ('replica-0', 'replica-1'):
        assert os.path.exists(os.path.join(str(out), 'logs',
                                           '%s.log' % name))


@pytest.mark.slow
def test_serve_slow_canary_breach_rolls_back(tmp_path):
    out = tmp_path / 'run'
    proc, ledger = _run_fleet(
        out, ['--rolls', '1', '--canary-seconds', '5',
              '--latency-floor-ms', '20', '--min-events', '4',
              '--replica-chaos', 'serve_slow=*:0.12'])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    cv = events(ledger, 'canary_verdict')
    assert len(cv) == 1 and cv[0]['verdict'] == 'breach'
    assert any('intertoken_p99' in r for r in cv[0]['reasons'])
    rbs = events(ledger, 'rollback')
    assert len(rbs) == 1
    assert (rbs[0]['version'], rbs[0]['to_version']) == (4, 2)
    assert not events(ledger, 'promote')
    swaps = events(ledger, 'replica_swap')
    assert len(swaps) == 2
    assert all(s['replica'] == 'replica-0' for s in swaps)
    assert swaps[1]['rollback'] and swaps[1]['to_version'] == 2
    assert all(s['shed_during_swap'] == 0 for s in swaps)
    conv = events(ledger, 'converged')[0]
    assert conv['version'] == 2 and set(conv['replicas'].values()) == {2}
    traffic = events(ledger, 'complete')[0]['traffic']
    assert traffic['served'] > 0
    assert traffic['shed_submit'] == traffic['shed_result'] == 0


@pytest.mark.slow
def test_swap_kill_mid_roll_converges_on_restart(tmp_path):
    out = tmp_path / 'run'
    proc, ledger = _run_fleet(out, ['--rolls', '1',
                                    '--canary-seconds', '2',
                                    '--latency-floor-ms', '250'],
                              chaos='swap_kill=@1:44')
    assert proc.returncode == 44, proc.stdout + proc.stderr
    assert [e['event'] for e in ledger] == [
        'start', 'version_seen', 'roll_start', 'replica_swap',
        'canary_verdict']
    assert events(ledger, 'replica_swap')[0]['to_version'] == 4
    proc2, ledger2 = _run_fleet(out, ['--rolls', '0'])
    assert proc2.returncode == 0, proc2.stdout + proc2.stderr
    conv = events(ledger2, 'converged')
    assert len(conv) == 1
    assert (conv[0]['version'], conv[0]['recovered_roll']) == (4, 4)
    assert set(conv[0]['replicas'].values()) == {4}
    assert events(ledger2, 'start')[-1]['version'] == 4
    assert events(ledger2, 'complete')[-1]['traffic']['served'] > 0


@pytest.mark.slow
def test_replica_kill_recovers_all_inflight_and_respawns(tmp_path):
    out = tmp_path / 'run'
    proc, ledger = _run_fleet(
        out, ['--rolls', '0', '--duration', '8', '--recover',
              '--max-prompt-len', '16', '--traffic-prompt-max', '4',
              '--max-new-tokens', '8', '--replica-chaos',
              'replica_kill=@2:1'])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    summary = _summary(proc)
    rec = summary['recovery']
    assert (rec['deaths'], rec['respawns']) == (1, 1)
    assert not rec['aborted'] and rec['lost_requests'] == 0
    t = summary['traffic']
    assert t['errors'] == 0 and t['served'] == t['offered'] > 0
    dead = events(ledger, 'replica_dead')
    assert len(dead) == 1 and dead[0]['replica'] == 'replica-1'
    assert (dead[0]['exit'], dead[0]['returncode']) == ('crash', 46)
    requeues = [e['request_id'] for e in events(ledger, 'requeue')]
    assert events(ledger, 'recovered')[0]['request_ids'] == requeues
    respawn = events(ledger, 'respawn')[0]
    assert respawn['replica'] == 'replica-1r1'
    assert respawn['version'] == summary['version']


@pytest.mark.slow
def test_replica_kill_crash_loop_aborts_rc1(tmp_path):
    out = tmp_path / 'run'
    proc, ledger = _run_fleet(
        out, ['--rolls', '0', '--duration', '60', '--recover',
              '--max-prompt-len', '16', '--traffic-prompt-max', '4',
              '--replica-chaos', 'replica_kill=*'])
    assert proc.returncode == 1, proc.stdout + proc.stderr
    rec = _summary(proc)['recovery']
    assert rec['aborted'] and 'crash_loop' in rec['abort_reason']
    assert rec['deaths'] == 3
    assert rec['lost_requests'] == 0
    aborts = events(ledger, 'abort')
    assert len(aborts) == 1 and 'crash_loop' in aborts[0]['reason']
