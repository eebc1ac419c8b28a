"""Checkpoint serialization: npz snapshots, sharded step directories and
their integrity checks.

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
naming the leaf.  A ZeRO-1 snapshot resumes at another process count
(:func:`resume_updater`'s elastic reshard); the manifest records the
writing topology (``mesh_shape``).  :func:`save_npz` carries the chaos
checkpoint sites of the JAX package (``ckpt_kill`` / ``ckpt_stall``
between the fsync and the rename, ``ckpt_truncate`` / ``ckpt_flip``
after it).  The preemption handler, the asynchronous writer and the
resume walk over a snapshot chain are
:mod:`chainermn_tpu_torch.training.recovery`.

The JAX package's sharded save (:func:`save_checkpoint` /
:func:`restore_checkpoint`, orbax there) keeps its name and its
manifest here, but its files are ``torch.distributed.checkpoint``'s
(DCP): a step directory ``<directory>/<step>/`` that every process
writes its part of, and the sidecar ``<step>.manifest.json`` beside it,
written by process 0 once the write has committed.  Every DCP call
passes :func:`checkpoint_group`, a gloo group over the default group's
processes: DCP's asynchronous save refuses a group without a CPU
backend, and the port's default group on the card is NCCL alone.

Leaves are numpy arrays, except that a bfloat16 leaf is read back as a
CPU ``torch.bfloat16`` tensor: numpy has no such dtype (the JAX package
reads it through ``ml_dtypes``).

A snapshot's ``params`` are the flax parameter tree
(``params/Dense_0/kernel``).  The JAX MNIST example hands its updater
the whole variables dict as its parameters, so its snapshots nest them
once more (``params/params/Dense_0/kernel``); :func:`load_npz` with a
template of that shape reads them.
"""

import atexit
import json
import os
import threading
import zlib

import numpy as np
import torch
import torch.distributed as dist

from chainermn_tpu_torch.models.flax_weights import (
    _leaves, gather_leaf, load_flax_variables, shard_leaf,
    to_flax_variables)
from chainermn_tpu_torch.parallel import zero as zero_mod
from chainermn_tpu_torch.utils import chaos as _chaos
from chainermn_tpu_torch.utils.failure import CheckpointCorruptError

#: Reserved npz key holding the JSON manifest (uint8 bytes); user trees
#: must not use it as a top-level leaf name.
MANIFEST_KEY = '__manifest__'

MANIFEST_FORMAT = 1

_BF16 = 'bfloat16'


def _dtype_name(leaf):
    dtype = getattr(leaf, 'dtype', None)
    if isinstance(dtype, torch.dtype):
        return str(dtype).replace('torch.', '')
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


def _world():
    """``(rank, world size)`` of the default group, ``(0, 1)`` without
    one."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _manifest(leaves, mesh_shape=None):
    return {
        'format': MANIFEST_FORMAT,
        'complete': True,
        'world_size': _world()[1],
        'device_count': torch.cuda.device_count() or 1,
        'mesh_shape': ({k: int(v) for k, v in dict(mesh_shape).items()}
                       if mesh_shape is not None else None),
        'leaves': leaves,
    }


def mesh_shape_of(updater):
    """The topology a snapshot of ``updater`` records, as the JAX
    package's ``dict(comm.mesh.shape)``: a plan's axes (``{'data': 2,
    'model': 2}``), a pipeline updater's mesh, or a communicator's
    ``{'inter': ..., 'intra': ...}``; None when there is none."""
    comm = getattr(updater, 'comm', None)
    plan = getattr(comm, 'plan', None)
    if plan is not None:
        return dict(plan.mesh.shape)
    mesh = getattr(updater, 'mesh', None)
    if isinstance(getattr(mesh, 'shape', None), dict):
        return dict(mesh.shape)
    if getattr(comm, 'mesh_shape', None) is not None:
        inter, intra = comm.mesh_shape
        return {'inter': int(inter), 'intra': int(intra)}
    return None


def _npz_path(path):
    if not path.endswith('.npz') and not os.path.exists(path):
        return path + '.npz'
    return path


def save_npz(path, tree, mesh_shape=None):
    """Write a tree (nested dicts) of arrays, tensors and numbers to
    ``path`` (``.npz`` is appended when missing), keys = tree paths, with
    the manifest, atomically.  ``mesh_shape`` (a dict of axis sizes, e.g.
    :func:`mesh_shape_of`) records the writing topology.  Returns the
    path written."""
    stored, leaves = {}, {}
    for path_keys, leaf in _leaves(tree):
        key = '/'.join(map(str, path_keys))
        arr, dtype_name = _to_stored(leaf)
        stored[key if dtype_name is None else key + '::' + dtype_name] = arr
        leaves[key] = {'shape': list(arr.shape),
                       'dtype': dtype_name or str(arr.dtype),
                       'crc32': _crc(arr)}
    blob = json.dumps(_manifest(leaves, mesh_shape)).encode()
    stored[MANIFEST_KEY] = np.frombuffer(blob, np.uint8)
    if not path.endswith('.npz'):
        path = path + '.npz'
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        np.savez(f, **stored)
        f.flush()
        os.fsync(f.fileno())
    if _chaos._active is not None:  # ckpt_kill / ckpt_stall: mid-write
        _chaos.on_checkpoint_write(tmp)
    os.replace(tmp, path)
    if _chaos._active is not None:  # ckpt_truncate / ckpt_flip
        _chaos.corrupt_checkpoint(path)
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


def _check_leaf(key, shape, dtype, template, path):
    """A saved leaf's ``shape`` (a tuple, or None when it is missing) and
    dtype name against ``template``'s."""
    if shape is None:
        raise _corrupt('checkpoint is missing leaf %r' % key, path, key,
                       'missing')
    if tuple(shape) != tuple(_leaf_shape(template)):
        raise _corrupt('shape mismatch for %r: snapshot %r vs template %r'
                       % (key, tuple(shape), tuple(_leaf_shape(template))),
                       path, key, 'shape')
    if dtype != _dtype_name(template):
        raise _corrupt('dtype mismatch for %r: snapshot %s vs template %s'
                       % (key, dtype, _dtype_name(template)),
                       path, key, 'dtype')


def _fetch(by_key, key, template, path):
    """``by_key[key]``, checked against ``template``'s shape and dtype."""
    value = by_key.get(key)
    _check_leaf(key, None if key not in by_key else _leaf_shape(value),
                _dtype_name(value), template, path)
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
    """Cheap probe (no array data read): True iff ``path`` is a snapshot
    whose write committed -- a non-empty npz whose manifest carries the
    write-complete sentinel (a torn write never has the final name), or
    a step directory of :func:`save_checkpoint` whose sidecar exists and
    is complete (process 0 writes it only after the save commits)."""
    try:
        p = _npz_path(path)
        if os.path.isdir(p):
            directory, step = os.path.split(os.path.abspath(p))
            m = read_orbax_manifest(directory, step)
            return bool(m and m.get('complete'))
        if os.path.getsize(p) == 0:
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

    npz: the file must unzip, carry a complete manifest, and match every
    leaf's crc32; with ``template`` (nested dicts) each leaf's shape and
    dtype are checked too.  A step directory: its sidecar must exist and
    be complete (the shards' content is DCP's to check when they are
    read); with ``template`` each leaf's shape and dtype are checked
    against the sidecar, as the JAX package's ``_check_template`` does.
    """
    if os.path.isdir(path):
        directory, step = os.path.split(os.path.abspath(path))
        manifest = read_orbax_manifest(directory, step)
        if not (manifest and manifest.get('complete')):
            raise _corrupt('missing or incomplete manifest sidecar (torn '
                           'or legacy step directory)', path, None,
                           'incomplete')
        if template is not None:
            _check_template(manifest, template, path)
        return manifest
    by_key, manifest = read_npz(path)
    if not (manifest and manifest.get('complete')):
        raise _corrupt('no write-complete manifest sentinel (legacy or '
                       'torn snapshot)', path, None, 'incomplete')
    if template is not None:
        _fetch_tree(by_key, template, '', path)
    return manifest


def _check_template(manifest, template, path):
    """Each leaf of ``template`` against the sidecar's shape and dtype."""
    leaves = manifest.get('leaves', {})
    for path_keys, leaf in _leaves(template):
        key = '/'.join(map(str, path_keys))
        meta = leaves.get(key, {})
        _check_leaf(key, meta.get('shape'), meta.get('dtype'), leaf, path)


# -- trainer state ----------------------------------------------------------

def _optimizer(updater):
    """``(multi-node wrapper or None, the torch optimizer inside)``."""
    opt = updater.optimizer
    inner = getattr(opt, 'actual_optimizer', None)
    return (opt, inner) if inner is not None else (None, opt)


class StackRow:
    """Row ``rank`` of an ``(n, k)`` stack that lies split over the
    processes, one row each (a ZeRO-1 optimizer partition).
    :func:`save_checkpoint` writes each row from its own process under
    ``<key>@rank<rank>`` and lists the whole stack in the sidecar;
    ``shape`` and ``dtype`` are the stack's."""

    def __init__(self, row, rank, n):
        self.row, self.rank, self.n = row, int(rank), int(n)

    @property
    def shape(self):
        return (self.n,) + tuple(self.row.shape)

    @property
    def dtype(self):
        return self.row.dtype


def gather_replicated(updater):
    """The optimizer state of ``updater`` with every part that lies
    split over processes made whole on each of them, keyed by parameter
    index, as :func:`updater_state` saves it: a ZeRO-1 run's
    shard-sized state gathered into its ``(n, k)`` stacks
    (``ZeroStep.gathered_state``), a tensor-parallel model's sharded
    moments gathered to their parameters' full shape.  The JAX
    package's ``gather_replicated(tree, mesh)`` reads the layout from
    each array's sharding; a torch tensor carries none, so the port
    reads it from the updater.  A collective: every process calls it."""
    _, inner = _optimizer(updater)
    zero = getattr(updater, '_zero', None)
    if zero is not None:
        return zero.gathered_state()
    return _gather_sharded(updater, inner, {
        i: dict(s) for i, s in inner.state_dict()['state'].items()})


def updater_state(updater, sharded=False):
    """The snapshot tree of a live updater:

    - ``params``: the flax-named parameter tree (``updater.params``);
    - ``model_state``: ``{'batch_stats': ...}`` when the model has
      buffers (BatchNorm running statistics);
    - ``opt_state``: the wrapped optimizer's per-parameter state
      (``state_dict()['state']``, keyed by parameter index) under
      ``actual_state``, and the multi-node wrapper's
      ``needs_broadcast`` (the JAX package keeps it in its optimizer
      state too, so a resumed run does not broadcast again); under
      ``double_buffering`` also ``have_pending`` and, when it is true,
      the reduced gradients still to apply, ``pending/<index>`` (the
      JAX package's ``DoubleBufferState``), so a resumed run applies
      them at its first step as the uninterrupted run does; under
      ``StandardUpdater(zero=True)`` each shard-sized state tensor
      gathered into its ``(N, k)`` stack, and under a tensor-parallel
      model each sharded moment gathered to its parameter's full shape
      (both collectives: every process must call this);
    - ``iteration``, ``epoch`` and ``epoch_detail``;
    - ``stream_cursor``, when the iterator has one (a streaming loader,
      directly or under ``DevicePrefetchIterator``): the exact global
      stream position, so a resume at another process count replays the
      remaining samples with no repeat and no drop;
    - ``scale_state`` (``scale``, ``growth_count``) under a loss-scaled
      policy, so a resumed f16 run goes on at its adapted scale, as the
      JAX package's snapshot does.

    A pipeline updater (``training.PipelineUpdater``) gives its own
    tree (``snapshot_state``): the stacked body gathered over the stages
    under the JAX keys, the ``extra`` ends, its optimizer's state by
    parameter path, the counters (a collective: every process calls
    it).

    ``sharded=True`` (the step directories' tree) gathers no ZeRO-1
    partition: each shard-sized state tensor is this process's
    :class:`StackRow`.
    """
    own = getattr(updater, 'snapshot_state', None)
    if own is not None:
        return own()
    wrapper, _ = _optimizer(updater)
    zero = getattr(updater, '_zero', None)
    if sharded and zero is not None:
        actual = {i: {key: StackRow(v, zero.rank, zero.n) if row else v
                      for key, (v, row) in entry.items()}
                  for i, entry in zero.local_state().items()}
    else:
        actual = gather_replicated(updater)
    opt_state = {'actual_state': {str(i): s for i, s in actual.items()}}
    if wrapper is not None:
        opt_state['needs_broadcast'] = np.bool_(wrapper.needs_broadcast)
        if wrapper.double_buffering:
            pending = wrapper.pending
            opt_state['have_pending'] = np.bool_(pending is not None)
            if pending is not None:
                opt_state['pending'] = {
                    str(i): g.detach().cpu() for i, g in enumerate(pending)}
    scale_state = getattr(updater, 'scale_state', None)
    state = {
        'params': updater.params,
        'opt_state': opt_state,
        'iteration': updater.iteration,
        'epoch': updater.epoch,
        'epoch_detail': float(updater.epoch_detail),
    }
    cursor = getattr(getattr(updater, 'iterator', None), 'stream_cursor',
                     None)
    if cursor is not None:
        state['stream_cursor'] = int(cursor)
    stats = to_flax_variables(updater.model)['batch_stats']
    if stats:
        state['model_state'] = {'batch_stats': stats}
    if scale_state is not None:
        state['scale_state'] = {k: v.detach().cpu().numpy()
                                for k, v in scale_state._asdict().items()}
    return state


def _gather_sharded(updater, inner, state):
    """``state`` (index -> entries) with every tensor shaped like a
    model-sharded parameter gathered to the full shape."""
    mesh = getattr(updater, '_mesh', None)
    spec_of = getattr(updater, 'param_spec_of', None)
    if mesh is None or spec_of is None or updater.param_specs is None:
        return state
    params = [p for g in inner.param_groups for p in g['params']]
    for i in sorted(state):
        spec = spec_of(params[i])
        if not spec or all(e is None for e in spec):
            continue
        for key, value in state[i].items():
            if torch.is_tensor(value) and value.shape == params[i].shape:
                state[i][key] = gather_leaf(value, spec, mesh,
                                            params[i].device)
    return state


def restore_counters(updater, iteration, epoch=0, epoch_detail=None,
                     stream_cursor=None):
    """Restore the step counter and the iterator's position, the most
    exact first, in the JAX package's order: a ``stream_cursor`` through
    the iterator's ``restore_cursor`` (the global stream position, at the
    epoch of ``epoch_detail``, else ``epoch``); else ``epoch_detail``
    through its ``restore_position``; else the integer ``epoch`` through
    its ``restore_epoch``, else its ``epoch`` attribute."""
    updater.iteration = int(iteration)
    it = getattr(updater, 'iterator', None)
    if it is None:
        return
    if stream_cursor is not None and hasattr(it, 'restore_cursor'):
        base = (int(float(epoch_detail)) if epoch_detail is not None
                else int(epoch))
        it.restore_cursor(base, int(stream_cursor))
    elif epoch_detail is not None and hasattr(it, 'restore_position'):
        it.restore_position(float(epoch_detail))
    elif hasattr(it, 'restore_epoch'):
        it.restore_epoch(int(epoch))
    elif hasattr(it, 'epoch'):
        it.epoch = int(epoch)


def _raw_opt_state(by_key):
    """``{index: {key: tensor}}`` of the snapshot's
    ``opt_state/actual_state/<index>/<key>`` leaves."""
    prefix = 'opt_state/actual_state/'
    state = {}
    for key, value in by_key.items():
        if key.startswith(prefix):
            index, _, name = key[len(prefix):].partition('/')
            state.setdefault(int(index), {})[name] = torch.as_tensor(value)
    return state


def _opt_state_from(by_key, inner, path, updater=None):
    """The wrapped optimizer's ``state`` from the snapshot's
    ``opt_state/actual_state/<index>/<key>`` leaves.  A tensor of a
    parameter's shape is checked against it and laid out as it is
    (channels_last conv weights: ``FusedMomentumSGD`` walks a velocity
    and its parameter as flat arrays of the same order); a
    tensor-parallel model's moment is saved full and cut to this
    process's shard first."""
    params = [p for g in inner.param_groups for p in g['params']]
    spec_of = getattr(updater, 'param_spec_of', None)
    mesh = getattr(updater, '_mesh', None)
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
        spec = spec_of(params[i]) if spec_of is not None else None
        if (t.ndim and mesh is not None and spec
                and any(e is not None for e in spec)
                and tuple(t.shape) != tuple(params[i].shape)):
            t = shard_leaf(t, spec, mesh)
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


def resume_updater(path, updater, comm=None, elastic=True,
                   require_manifest=False):
    """Restore a snapshot written by ``extensions.snapshot()`` into a
    live updater: parameters, BatchNorm statistics, optimizer state
    (the multi-node wrapper's ``needs_broadcast`` too), the loss-scale
    state under a loss-scaled policy, and the
    iteration / epoch counters and the stream cursor
    (:func:`restore_counters`), so stop triggers and file names
    continue rather than restart.  Everything is read and checked
    before anything is assigned, so a corrupt leaf never leaves the
    updater half-restored.

    ELASTIC (default): a ``StandardUpdater(zero=True)`` snapshot written
    at another data-process count (its ``(N, k)`` optimizer stacks
    disagree with this run's) is resharded N -> M
    (``ZeroStep.load_gathered_state``), and the iterator's epoch
    position is re-expressed at this run's shard length (``epoch_detail``
    through ``restore_position``).  ``elastic=False`` turns such a
    mismatch into :class:`CheckpointCorruptError` (``kind='shape'``,
    ``leaf='opt_state'``).  ``require_manifest=True`` also refuses a
    snapshot without the write-complete manifest.  ``comm`` is unused
    (every process reads the same file).  Returns ``{'iteration',
    'resharded', 'manifest'}``."""
    del comm
    by_key, manifest = read_npz(path)
    return _restore_state(updater, by_key, manifest, path, elastic,
                          require_manifest)


def restore_updater_from_tree(updater, state, manifest=None, elastic=True,
                              path=None):
    """Restore a live updater from a snapshot tree held in memory (a raw
    :func:`restore_checkpoint` above all), with :func:`resume_updater`'s
    checks, elastic ZeRO-1 reshard and counters.  A :class:`StackRow`
    leaf is this process's own row; a leaf may be a tensor, a numpy
    array or a number.  Returns ``{'iteration', 'resharded',
    'manifest'}``."""
    by_key = {}
    for path_keys, leaf in _leaves(state):
        if isinstance(leaf, StackRow):
            leaf = leaf.row
        if isinstance(leaf, torch.Tensor) and leaf.dtype != torch.bfloat16:
            leaf = leaf.detach().cpu().numpy()
        by_key['/'.join(map(str, path_keys))] = leaf
    return _restore_state(updater, by_key, manifest,
                          path or '<in-memory tree>', elastic)


def _restore_state(updater, by_key, manifest, path, elastic=True,
                   require_manifest=False):
    """The restore core of :func:`resume_updater` and
    :func:`restore_updater_from_tree` over ``{key: leaf}``."""
    if require_manifest and not (manifest and manifest.get('complete')):
        raise _corrupt('no write-complete manifest sentinel (legacy or '
                       'torn snapshot)', path, None, 'incomplete')
    load = getattr(updater, 'load_snapshot', None)
    if load is not None:
        # a pipeline updater: its stage (and shard) cut at the same mesh
        # shape
        load(by_key, path)
        return _restore_counters_from(updater, by_key, manifest, path)
    live = updater_state(updater)
    variables = {'params': _fetch_tree(by_key, live['params'], 'params',
                                       path)}
    if 'model_state' in live:
        variables['batch_stats'] = _fetch_tree(
            by_key, live['model_state']['batch_stats'],
            'model_state/batch_stats', path)
    wrapper, inner = _optimizer(updater)
    zero = getattr(updater, '_zero', None)
    resharded = False
    if zero is not None:
        opt_state = _raw_opt_state(by_key)
        mismatch = zero.stack_mismatches(opt_state)
        if mismatch and not elastic:
            raise _corrupt(
                'optimizer-state shape mismatch (snapshot %r vs live %r) '
                'and no elastic ZeRO-1 reshard applies -- the snapshot '
                'was written under a different topology' % mismatch[0],
                path, 'opt_state', 'shape')
        if mismatch:
            opt_state = zero_mod.reshard_stacked_state(opt_state, {
                i: {k: torch.empty(zero.stack_shape(i), device='meta')
                    for k in entry} for i, entry in opt_state.items()})
        resharded = bool(mismatch)
    else:
        opt_state = _opt_state_from(by_key, inner, path, updater)
    pending = None
    if wrapper is not None:
        flag = _fetch(by_key, 'opt_state/needs_broadcast', np.bool_(True),
                      path)
        if wrapper.double_buffering and bool(_fetch(
                by_key, 'opt_state/have_pending', np.bool_(True), path)):
            params = wrapper._params()
            # in the parameter's layout, as a reduced gradient is
            pending = [torch.empty_like(p).copy_(torch.as_tensor(_fetch(
                by_key, 'opt_state/pending/%d' % i, p.detach().cpu(),
                path))) for i, p in enumerate(params)]
    iteration = _fetch(by_key, 'iteration', np.int64(0), path)
    scale = (_fetch_tree(by_key, live['scale_state'], 'scale_state', path)
             if 'scale_state' in live else None)
    load_flax_variables(updater.model, variables)
    if zero is not None:
        zero.load_gathered_state(opt_state)
        zero.refresh()
    else:
        inner.load_state_dict({'state': opt_state,
                               'param_groups': inner.state_dict()[
                                   'param_groups']})
    if wrapper is not None:
        wrapper.needs_broadcast = bool(flag)
        if wrapper.double_buffering:
            wrapper.pending = pending
    if scale is not None:
        updater.scale_state = type(updater.scale_state)(**{
            k: torch.as_tensor(v).to(updater.device)
            for k, v in scale.items()})
    return _restore_counters_from(updater, by_key, manifest, path,
                                  iteration, resharded)


def _restore_counters_from(updater, by_key, manifest, path, iteration=None,
                           resharded=False):
    if iteration is None:
        iteration = _fetch(by_key, 'iteration', np.int64(0), path)
    detail = by_key.get('epoch_detail')
    cursor = by_key.get('stream_cursor')
    restore_counters(updater, iteration, by_key.get('epoch', 0),
                     None if detail is None else float(detail),
                     None if cursor is None else int(cursor))
    return {'iteration': updater.iteration, 'resharded': resharded,
            'manifest': manifest}


# -- step directories (torch.distributed.checkpoint) -------------------------

#: ``(default group, gloo group over its processes)``: see
#: :func:`checkpoint_group`
_side = None
#: ``(thread, outcome)`` of the asynchronous write in flight
_inflight = None
#: ``(directory, step, manifest, group)`` of asynchronous writes not
#: joined yet
_pending_manifests = []
_at_exit = False
_ROW = '@rank'


def checkpoint_group():
    """The process group every DCP call of this module passes: a gloo
    group over the default group's processes (None without a default
    group).  DCP's asynchronous save refuses a group without a CPU
    backend, and a DCP collective on the writer's thread must not share a
    communicator with the training's collectives.  It is made at the
    first call under a default group -- the first save or restore, which
    every process makes at the same point -- and made anew once that
    default group has been destroyed or replaced (destroying the default
    group destroys its sub-groups too)."""
    global _side
    if not dist.is_initialized():
        return None
    world = dist.group.WORLD
    if _side is None or _side[0] is not world:
        _side = (world, dist.new_group(backend='gloo'))
    return _side[1]


def _orbax_manifest_path(directory, step):
    return os.path.join(os.path.abspath(directory),
                        '%s.manifest.json' % step)


def _write_orbax_manifest(directory, step, manifest, group):
    """Process 0 writes the sidecar; then every process of ``group``
    waits for it, so none reads the step as torn while process 0 is
    still writing (skipped when ``group`` is no longer the live side
    group, as at exit after the default group was destroyed)."""
    if _world()[0] == 0:
        final = _orbax_manifest_path(directory, step)
        tmp = final + '.tmp'
        with open(tmp, 'w') as f:
            json.dump(manifest, f)
        os.replace(tmp, final)
    if (group is not None and _side is not None and group is _side[1]
            and _side[0] is dist.group.WORLD):
        dist.barrier(group=group)


def read_orbax_manifest(directory, step):
    """The sidecar of a step directory (written by process 0 after the
    save commits: it is the write-complete sentinel), or None for a torn
    step."""
    try:
        with open(_orbax_manifest_path(directory, step)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _dcp_tree(tree, host):
    """``({DCP key: tensor}, manifest leaves)`` of a tree: a numpy array
    or a number becomes a tensor of its own (numbers 0-d, of their numpy
    dtype), a :class:`StackRow` goes under ``<key>@rank<r>``.  ``host``
    copies every tensor to host memory that no later step can change;
    else a tensor is itself (what ``dcp.load`` fills in place)."""
    flat, leaves = {}, {}
    for path_keys, leaf in _leaves(tree):
        key = '/'.join(map(str, path_keys))
        leaves[key] = {'shape': list(_leaf_shape(leaf)),
                       'dtype': _dtype_name(leaf)}
        name = key
        if isinstance(leaf, StackRow):
            name = '%s%s%d' % (key, _ROW, leaf.rank)
            leaf = leaf.row
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach()
            if host:
                t = t.cpu() if t.is_cuda else t.clone()
        else:
            t = torch.from_numpy(np.array(leaf))
        flat[name] = t
    return flat, leaves


def _dcp_save(flat, path, group):
    import torch.distributed.checkpoint as dcp
    dcp.save(flat, storage_writer=dcp.FileSystemWriter(path),
             process_group=group)


def save_checkpoint(directory, tree, step=0, async_=False, mesh_shape=None):
    """The JAX package's sharded checkpoint (orbax there), written with
    ``torch.distributed.checkpoint``: ``<directory>/<step>/`` holds DCP's
    files (``.metadata`` and one ``.distcp`` a process), not orbax's; the
    method keeps its JAX name.  A collective over
    :func:`checkpoint_group`: every process calls it with its own tree.
    A leaf every process holds alike is written once (DCP keeps one of
    the duplicate keys); a :class:`StackRow` is written by its own
    process.  ``tree`` is nested dicts of tensors, numpy arrays and
    numbers (stored as 0-d tensors).

    Process 0 then writes the sidecar ``<step>.manifest.json`` beside the
    step directory: the npz manifest's keys (``format``, ``complete``,
    ``world_size``, ``device_count`` -- the world size, one process a
    device -- ``mesh_shape``, and each leaf's shape and dtype).  It is the
    write-complete sentinel :func:`checkpoint_complete` and the resume
    walk require, so a step killed mid-write is never chosen.

    ``async_=True`` copies every tensor to fresh host memory (the next
    step overwrites the live ones in place), hands the write to a
    background thread and returns; the sidecar waits for the join.  Any
    save, and :func:`wait_checkpoints`, first joins the write in flight,
    so at most one is in flight and they commit in order.  Returns the
    directory."""
    global _inflight, _at_exit
    directory = os.path.abspath(directory)
    path = os.path.join(directory, str(step))
    group = checkpoint_group()
    wait_checkpoints()
    flat, leaves = _dcp_tree(tree, host=True)
    manifest = dict(_manifest(leaves, mesh_shape),
                    device_count=_world()[1])
    if _world()[0] == 0:
        try:        # a step written again is not complete until it commits
            os.unlink(_orbax_manifest_path(directory, step))
        except FileNotFoundError:
            pass
    if not async_:
        _dcp_save(flat, path, group)
        _write_orbax_manifest(directory, step, manifest, group)
        return directory
    outcome = {}

    def write():
        try:
            _dcp_save(flat, path, group)
        except BaseException as e:      # re-raised at the join
            outcome['error'] = e

    if not _at_exit:
        atexit.register(wait_checkpoints)
        _at_exit = True
    thread = threading.Thread(target=write, name='dcp_checkpoint',
                              daemon=True)
    _inflight = (thread, outcome)
    _pending_manifests.append((directory, step, manifest, group))
    thread.start()
    return directory


def wait_checkpoints():
    """Join the asynchronous write in flight, then write the sidecars it
    deferred: a sidecar only ever describes data that is on disk.  A
    failed write re-raises here and leaves its step without a sidecar.
    Registered at exit by the first asynchronous save."""
    global _inflight
    if _inflight is not None:
        thread, outcome = _inflight
        thread.join()
        _inflight = None
        if 'error' in outcome:
            del _pending_manifests[:]
            raise outcome['error']
    while _pending_manifests:
        _write_orbax_manifest(*_pending_manifests.pop(0))


def _row_of(name):
    """``(key, rank)`` of a ``<key>@rank<r>`` DCP key, else ``(name,
    None)``."""
    key, sep, r = name.rpartition(_ROW)
    return (key, int(r)) if sep and r.isdigit() else (name, None)


def _join_rows(flat, rank=None):
    """``{key: leaf}`` with the ``<key>@rank<r>`` rows of every key
    stacked in rank order into the ``(n, k)`` stack ``<key>``, or with
    ``rank`` given (only that process's rows read) each row as its
    :class:`StackRow`."""
    rows, out = {}, {}
    for name, t in flat.items():
        key, r = _row_of(name)
        if r is None:
            out[name] = t
        elif rank is None:
            rows.setdefault(key, {})[r] = t
        else:
            out[key] = StackRow(t, r, _world()[1])
    for key, by_rank in rows.items():
        out[key] = torch.stack([by_rank[r] for r in sorted(by_rank)])
    return out


def _unflatten(flat):
    tree = {}
    for key, value in flat.items():
        node = tree
        parts = key.split('/')
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _restored(leaf, t):
    """``t`` loaded for template leaf ``leaf``, in the leaf's kind."""
    if isinstance(leaf, (torch.Tensor, StackRow)):
        return leaf
    if isinstance(leaf, np.ndarray):
        return t.numpy()
    if isinstance(leaf, np.generic):
        return t.numpy()[()]
    return type(leaf)(t.item())


def restore_checkpoint(directory, template, step=0, rank=None):
    """Read step ``step`` of :func:`save_checkpoint` under ``directory``
    (a collective over :func:`checkpoint_group`).  Any write in flight is
    joined first.

    With a template (nested dicts), each tensor or :class:`StackRow` row
    is loaded in place (``dcp.load``) and the tree is returned, numbers
    and numpy arrays in their own kind; each leaf is checked against the
    step's shapes and dtypes first.  With ``template=None`` a raw restore
    to host tensors: the tree is built from the step's metadata (each
    entry's size and dtype), the rows of a ZeRO-1 stack stacked again --
    how a step written at another process count is read; with ``rank``
    (at the writing process count) only the leaves every process shares
    and process ``rank``'s own rows are read, each row a
    :class:`StackRow` (a torch optimizer that has not stepped yet holds
    no state a template could name).  An unreadable
    or torn step raises
    :class:`~chainermn_tpu_torch.utils.failure.CheckpointCorruptError`
    (``kind='unreadable'``), a leaf that does not fit the template one of
    kind ``missing``, ``shape`` or ``dtype``."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint.api import CheckpointException
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata
    wait_checkpoints()
    group = checkpoint_group()
    path = os.path.join(os.path.abspath(directory), str(step))
    try:
        meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    except Exception as e:
        raise _corrupt('unreadable step directory (%s: %s)'
                       % (type(e).__name__, e), path, None,
                       'unreadable') from e
    if template is None:
        flat = {k: torch.empty(tuple(m.size), dtype=m.properties.dtype)
                for k, m in meta.items()
                if isinstance(m, TensorStorageMetadata)
                and (rank is None or _row_of(k)[1] in (None, rank))}
    else:
        flat, _ = _dcp_tree(template, host=False)
        for name, t in flat.items():
            m = meta.get(name)
            ok = isinstance(m, TensorStorageMetadata)
            _check_leaf(name, tuple(m.size) if ok else None,
                        ok and _dtype_name(m.properties), t, path)
    try:
        dcp.load(flat, storage_reader=dcp.FileSystemReader(path),
                 process_group=group)
    except (Exception, CheckpointException) as e:   # the latter is no
        # Exception: DCP gathers every process's failure into it
        raise _corrupt('unreadable step directory (%s: %s)'
                       % (type(e).__name__, e), path, None,
                       'unreadable') from e
    if template is None:
        return _unflatten(_join_rows(flat, rank))
    out = {}
    names = iter(flat.values())
    for path_keys, leaf in _leaves(template):
        node = out
        for part in path_keys[:-1]:
            node = node.setdefault(part, {})
        node[path_keys[-1]] = _restored(leaf, next(names))
    return out
