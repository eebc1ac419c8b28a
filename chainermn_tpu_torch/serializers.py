"""Checkpoint serialization: npz snapshots and their integrity checks.

Counterpart of the npz half of ``chainermn_tpu/serializers.py`` (the
reference delegates checkpoint / resume to Chainer's npz serializers,
``train_mnist.py:44-45,117-118``).  The container is the JAX package's,
so each package reads the other's files:

- keys are tree paths joined by ``/``; a bfloat16 leaf is stored as
  ``uint16`` under ``<path>::bfloat16``;
- ``__manifest__`` holds JSON bytes: the format, the write-complete
  sentinel, the world size and device count, and each leaf's shape,
  dtype and crc32 (over the stored bytes);
- the file is written to ``<path>.tmp`` and renamed, so a crash
  mid-write never leaves a torn file under the final name.

Every integrity failure raises the typed
:class:`~chainermn_tpu_torch.utils.failure.CheckpointCorruptError`
naming the leaf.  Elastic resume (another process count), orbax
checkpoints, asynchronous checkpoints and the fault-injection hooks
are not ported yet (ROADMAP.md A9).

Leaves are numpy arrays, except that a bfloat16 leaf is read back as a
CPU ``torch.bfloat16`` tensor: numpy has no such dtype (the JAX package
reads it through ``ml_dtypes``).

A snapshot's ``params`` are the flax parameter tree
(``params/Dense_0/kernel``).  The JAX MNIST example hands its updater
the whole variables dict as its parameters, so its snapshots nest them
once more (``params/params/Dense_0/kernel``); :func:`load_npz` with a
template of that shape reads them.
"""

import json
import os
import zlib

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.models.flax_weights import (
    _leaves, load_flax_variables, to_flax_variables)
from chainermn_tpu_torch.utils.failure import CheckpointCorruptError

#: Reserved npz key holding the JSON manifest (uint8 bytes); user trees
#: must not use it as a top-level leaf name.
MANIFEST_KEY = '__manifest__'

MANIFEST_FORMAT = 1

_BF16 = 'bfloat16'


def _dtype_name(leaf):
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace('torch.', '')
    return str(np.asarray(leaf).dtype)


def _leaf_shape(leaf):
    return tuple(leaf.shape) if hasattr(leaf, 'shape') \
        else np.shape(leaf)


def _to_stored(leaf):
    """``(numpy array as stored, dtype name for the key or None)``."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), None
    return np.asarray(leaf), None


def _from_stored(arr, dtype_name):
    if not dtype_name:
        return arr
    if dtype_name != _BF16:
        raise TypeError('dtype %s has no counterpart here' % dtype_name)
    return torch.from_numpy(np.array(arr).view(np.int16)).view(
        torch.bfloat16)


def _crc(arr):
    return zlib.crc32(np.ascontiguousarray(arr).tobytes())


def _corrupt(message, path, leaf, kind):
    return CheckpointCorruptError('%s [snapshot %s]' % (message, path),
                                  path=path, leaf=leaf, kind=kind)


def _manifest(leaves):
    return {
        'format': MANIFEST_FORMAT,
        'complete': True,
        'world_size': dist.get_world_size() if dist.is_initialized() else 1,
        'device_count': torch.cuda.device_count() or 1,
        'mesh_shape': None,
        'leaves': leaves,
    }


def _npz_path(path):
    if not path.endswith('.npz') and not os.path.exists(path):
        return path + '.npz'
    return path


def save_npz(path, tree):
    """Write a tree (nested dicts) of arrays, tensors and numbers to
    ``path`` (``.npz`` is appended when missing), keys = tree paths, with
    the manifest, atomically.  Returns the path written."""
    stored, leaves = {}, {}
    for path_keys, leaf in _leaves(tree):
        key = '/'.join(map(str, path_keys))
        arr, dtype_name = _to_stored(leaf)
        stored[key if dtype_name is None else key + '::' + dtype_name] = arr
        leaves[key] = {'shape': list(arr.shape),
                       'dtype': dtype_name or str(arr.dtype),
                       'crc32': _crc(arr)}
    blob = json.dumps(_manifest(leaves)).encode()
    stored[MANIFEST_KEY] = np.frombuffer(blob, np.uint8)
    if not path.endswith('.npz'):
        path = path + '.npz'
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **stored)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def read_npz(path):
    """Read a :func:`save_npz` file into ``({key: array}, manifest)``.

    ``manifest`` is None for a file without one.  A zero-byte,
    truncated or unreadable file, a leaf the manifest lists but the
    archive lacks, or a crc32 mismatch raises
    :class:`CheckpointCorruptError`; a MISSING file raises ``OSError``.
    """
    path = _npz_path(path)
    if os.path.getsize(path) == 0:
        raise _corrupt('zero-byte snapshot', path, None, 'unreadable')
    by_key, crcs, manifest = {}, {}, None
    try:
        with np.load(path) as data:
            if MANIFEST_KEY in data.files:
                manifest = json.loads(bytes(data[MANIFEST_KEY]))
            for stored_key in data.files:
                if stored_key == MANIFEST_KEY:
                    continue
                key, _, dtype_name = stored_key.partition('::')
                arr = data[stored_key]
                if manifest is not None:
                    crcs[key] = _crc(arr)
                by_key[key] = _from_stored(arr, dtype_name)
    except Exception as e:
        raise _corrupt('unreadable snapshot (%s: %s)'
                       % (type(e).__name__, e), path, None,
                       'unreadable') from e
    if manifest is not None:
        for key, meta in manifest.get('leaves', {}).items():
            if key not in by_key:
                raise _corrupt('manifest lists leaf %r but the archive '
                               'lacks it' % key, path, key, 'missing')
            if 'crc32' in meta and crcs.get(key) != meta['crc32']:
                raise _corrupt('crc32 mismatch for leaf %r (bit rot or '
                               'torn write)' % key, path, key, 'crc')
    return by_key, manifest


def _fetch(by_key, key, template, path):
    """``by_key[key]``, checked against ``template``'s shape and dtype."""
    if key not in by_key:
        raise _corrupt('checkpoint is missing leaf %r' % key, path, key,
                       'missing')
    value = by_key[key]
    if _leaf_shape(value) != _leaf_shape(template):
        raise _corrupt('shape mismatch for %r: snapshot %r vs template %r'
                       % (key, _leaf_shape(value), _leaf_shape(template)),
                       path, key, 'shape')
    if _dtype_name(value) != _dtype_name(template):
        raise _corrupt('dtype mismatch for %r: snapshot %s vs template %s'
                       % (key, _dtype_name(value), _dtype_name(template)),
                       path, key, 'dtype')
    return value


def _fetch_tree(by_key, template, prefix, path):
    """``template``'s nested dicts filled from ``by_key`` under
    ``prefix``, leaf by leaf checked."""
    if isinstance(template, dict):
        return {k: _fetch_tree(by_key, v, '%s/%s' % (prefix, k)
                               if prefix else str(k), path)
                for k, v in template.items()}
    return _fetch(by_key, prefix or '_root', template, path)


def load_npz(path, template):
    """Read a :func:`save_npz` file back into ``template``'s structure
    (nested dicts), each leaf checked against the template's shape and
    dtype."""
    by_key, _ = read_npz(path)
    return _fetch_tree(by_key, template, '', path)


def checkpoint_complete(path):
    """Cheap probe: True iff ``path`` is a non-empty npz whose manifest
    carries the write-complete sentinel (a torn write never has the
    final name).  Orbax step directories are not recognised here
    (ROADMAP.md A9)."""
    try:
        p = _npz_path(path)
        if os.path.isdir(p) or os.path.getsize(p) == 0:
            return False
        with np.load(p) as data:
            if MANIFEST_KEY not in data.files:
                return False
            return bool(json.loads(bytes(data[MANIFEST_KEY])).get(
                'complete'))
    except Exception:
        return False


def verify_checkpoint(path, template=None):
    """Full integrity probe without restoring; returns the manifest.
    The file must unzip, carry a complete manifest, and match every
    leaf's crc32; with ``template`` (nested dicts) each leaf's shape and
    dtype are checked too."""
    if os.path.isdir(path):
        raise NotImplementedError(
            'orbax checkpoints are not ported yet (ROADMAP.md A9)')
    by_key, manifest = read_npz(path)
    if not (manifest and manifest.get('complete')):
        raise _corrupt('no write-complete manifest sentinel (legacy or '
                       'torn snapshot)', path, None, 'incomplete')
    if template is not None:
        _fetch_tree(by_key, template, '', path)
    return manifest


# -- trainer state ----------------------------------------------------------

def _optimizer(updater):
    """``(multi-node wrapper or None, the torch optimizer inside)``."""
    opt = updater.optimizer
    inner = getattr(opt, 'actual_optimizer', None)
    return (opt, inner) if inner is not None else (None, opt)


def updater_state(updater):
    """The snapshot tree of a live updater:

    - ``params``: the flax-named parameter tree (``updater.params``);
    - ``model_state``: ``{'batch_stats': ...}`` when the model has
      buffers (BatchNorm running statistics);
    - ``opt_state``: the wrapped optimizer's per-parameter state
      (``state_dict()['state']``, keyed by parameter index) under
      ``actual_state``, and the multi-node wrapper's
      ``needs_broadcast`` (the JAX package keeps it in its optimizer
      state too, so a resumed run does not broadcast again);
    - ``iteration``, ``epoch`` and ``epoch_detail``.
    """
    wrapper, inner = _optimizer(updater)
    opt_state = {'actual_state': {
        str(i): dict(s) for i, s in inner.state_dict()['state'].items()}}
    if wrapper is not None:
        opt_state['needs_broadcast'] = np.bool_(wrapper.needs_broadcast)
    state = {
        'params': updater.params,
        'opt_state': opt_state,
        'iteration': updater.iteration,
        'epoch': updater.epoch,
        'epoch_detail': float(updater.epoch_detail),
    }
    stats = to_flax_variables(updater.model)['batch_stats']
    if stats:
        state['model_state'] = {'batch_stats': stats}
    return state


def restore_counters(updater, iteration, epoch=0, epoch_detail=None):
    """Restore the step counter and the iterator's epoch position
    (``restore_position(epoch_detail)`` where the iterator has it, else
    its integer ``epoch``)."""
    updater.iteration = int(iteration)
    it = getattr(updater, 'iterator', None)
    if epoch_detail is not None and hasattr(it, 'restore_position'):
        it.restore_position(float(epoch_detail))
    elif hasattr(it, 'epoch'):
        it.epoch = int(epoch)


def _opt_state_from(by_key, inner, path):
    """The wrapped optimizer's ``state`` from the snapshot's
    ``opt_state/actual_state/<index>/<key>`` leaves.  A tensor of a
    parameter's shape is checked against it and laid out as it is
    (channels_last conv weights: ``FusedMomentumSGD`` walks a velocity
    and its parameter as flat arrays of the same order)."""
    params = [p for g in inner.param_groups for p in g['params']]
    prefix = 'opt_state/actual_state/'
    state = {}
    for key, value in by_key.items():
        if not key.startswith(prefix):
            continue
        index, _, name = key[len(prefix):].partition('/')
        i = int(index)
        if not 0 <= i < len(params):
            raise _corrupt('optimizer state for parameter %d of %d'
                           % (i, len(params)), path, key, 'shape')
        t = torch.as_tensor(value)
        if t.ndim:
            if tuple(t.shape) != tuple(params[i].shape):
                raise _corrupt('shape mismatch for %r: snapshot %r vs '
                               'parameter %r' % (key, tuple(t.shape),
                                                 tuple(params[i].shape)),
                               path, key, 'shape')
            t = torch.empty_like(params[i], dtype=t.dtype,
                                 device='cpu').copy_(t)
        state.setdefault(i, {})[name] = t.clone()
    return state


def resume_updater(path, updater, comm=None, elastic=False):
    """Restore a snapshot written by ``extensions.snapshot()`` into a
    live updater: parameters, BatchNorm statistics, optimizer state
    (the multi-node wrapper's ``needs_broadcast`` too) and the
    iteration / epoch counters, so stop triggers and file names
    continue rather than restart.  Everything is read and checked
    before anything is assigned, so a corrupt leaf never leaves the
    updater half-restored.  ``comm`` is unused (every process reads
    the same file).  Returns ``{'iteration', 'manifest'}``."""
    del comm
    if elastic:
        raise NotImplementedError(
            'elastic resume is not ported yet (ROADMAP.md A9)')
    by_key, manifest = read_npz(path)
    live = updater_state(updater)
    variables = {'params': _fetch_tree(by_key, live['params'], 'params',
                                       path)}
    if 'model_state' in live:
        variables['batch_stats'] = _fetch_tree(
            by_key, live['model_state']['batch_stats'],
            'model_state/batch_stats', path)
    wrapper, inner = _optimizer(updater)
    opt_state = _opt_state_from(by_key, inner, path)
    if wrapper is not None:
        flag = _fetch(by_key, 'opt_state/needs_broadcast', np.bool_(True),
                      path)
    iteration = _fetch(by_key, 'iteration', np.int64(0), path)
    load_flax_variables(updater.model, variables)
    inner.load_state_dict({'state': opt_state,
                           'param_groups': inner.state_dict()[
                               'param_groups']})
    if wrapper is not None:
        wrapper.needs_broadcast = bool(flag)
    detail = by_key.get('epoch_detail')
    restore_counters(updater, iteration, by_key.get('epoch', 0),
                     None if detail is None else float(detail))
    return {'iteration': updater.iteration, 'manifest': manifest}
