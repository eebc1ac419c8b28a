"""The ``train_lm`` twin under ``torchrun`` on gloo: four processes on
``--mesh 2x2`` and ``--mesh 1x4`` under both sequence-parallel schemes,
at ``--quick`` widths for 10 steps; the script exits 0 only when its
loss improved (the JAX example's ``loss did not improve`` exit), and
its first and last losses are read from what rank 0 prints."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize('scheme', ['ring', 'ulysses'])
@pytest.mark.parametrize('mesh', ['2x2', '1x4'])
def test_train_lm_twin_runs_under_torchrun(tmp_path, mesh, scheme):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    cmd = [sys.executable, '-m', 'torch.distributed.run',
           '--standalone', '--nproc-per-node', '4',
           '-m', 'chainermn_tpu_torch.examples.lm.train_lm',
           '--cpu', '--quick', '--mesh', mesh, '--sp-scheme', scheme,
           '--steps', '10']
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    dp, sp = mesh.split('x')
    assert 'mesh: dp=%s x sp=%s  scheme=%s  T=256' % (dp, sp, scheme) \
        in out.stdout
    first, last = (float(v) for v in re.search(
        r'loss ([0-9.]+) -> ([0-9.]+) \(uniform', out.stdout).groups())
    assert last < first
