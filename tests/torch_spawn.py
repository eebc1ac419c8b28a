"""Spawn a world of gloo processes for the port's multi-process tests.

``spawn(tmp_path, body, n, argv)`` runs ``body`` (Python source) in
``n`` processes on one ``FileStore``, each with ``rank``, ``n``,
``argv`` (strings) and an empty dict ``res`` in scope; each saves
``res`` as an npz, and the list of the ranks' dicts comes back.  Every
process has a deadline: ``faulthandler`` dumps its stacks and exits it
when the deadline passes (a collective that never matches fails the test
instead of hanging it).  ``save_tree`` / ``load_tree`` (also in the
workers' scope) carry a flax tree of numpy arrays through an npz with
``/``-joined keys.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_HELPERS = r'''
def flat_tree(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat_tree(v, prefix + k + '/'))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def load_tree(path, prefix=''):
    out = {}
    with np.load(path) as data:
        for key in data.files:
            if not key.startswith(prefix):
                continue
            node = out
            parts = key[len(prefix):].split('/')
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = data[key]
    return out
'''

_PRELUDE = r'''
import faulthandler
import sys
faulthandler.dump_traceback_later(float(sys.argv[4]), exit=True)
import numpy as np
import torch
import torch.distributed as dist
torch.set_num_threads(1)
store, rank, _out_path, n = (sys.argv[1], int(sys.argv[2]), sys.argv[3],
                              int(sys.argv[5]))
argv = sys.argv[6:]
dist.init_process_group('gloo', store=dist.FileStore(store, n), rank=rank,
                        world_size=n)
res = {}
''' + _HELPERS

_EPILOGUE = r'''
np.savez(_out_path, **res)
dist.destroy_process_group()
'''

exec(_HELPERS)


def save_tree(path, tree, **extra):
    """``tree`` (a flax tree) and ``extra`` arrays as one npz."""
    np.savez(path, **flat_tree(tree), **extra)


def spawn(tmp_path, body, n, argv=(), deadline=240):
    script = _PRELUDE + body + _EPILOGUE
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS='1')
    env.pop('CHAINERMN_TPU_TELEMETRY', None)
    store = tmp_path / 'store'
    if store.exists():
        store.unlink()
    procs = [subprocess.Popen(
        [sys.executable, '-c', script, str(store), str(r),
         str(tmp_path / ('r%d.npz' % r)), str(deadline), str(n)]
        + [str(a) for a in argv], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(n)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=deadline + 30)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out.decode(errors='replace')))
    for r, (rc, out) in enumerate(outs):
        assert rc == 0, 'rank %d exited %d:\n%s' % (r, rc, out)
    return [dict(np.load(tmp_path / ('r%d.npz' % r))) for r in range(n)]
