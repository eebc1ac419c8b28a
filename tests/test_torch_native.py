"""The port's native host core (``chainermn_tpu_torch/csrc/chainermn_core.cpp``
built by ``ops._build``) against the JAX package's ``native`` module.

The arena and the pack / unpack; ``augment_batch`` bit for bit against
the JAX package's native kernel and its numpy loop; the same rejections
of bad crops and indices; ``NativeCommunicator`` across two spawned
processes (bfloat16 as a tensor's raw bytes); the error taxonomy.
"""

import ast
import ctypes
import multiprocessing as mp
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from chainermn_tpu import native as jnative
from chainermn_tpu_torch import native
from chainermn_tpu_torch.datasets.imagenet import _augment_ref
from chainermn_tpu_torch.native import core
from chainermn_tpu_torch.ops import _build

import torch_native_worker

REPO = Path(__file__).resolve().parent.parent

torch.set_num_threads(2)


def test_library_is_built_into_the_port_build_dir():
    path = Path(native.lib_path())
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith('libchainermn_core-')
    assert path.exists() and not path.with_suffix('.so.tmp').exists()
    # a second request is a cache hit, never a rebuild
    assert _build.LIBRARIES.build_host('chainermn_core') == (path, 0.0)
    assert path != Path(jnative.lib_path or '/')
    assert native.pool_threads() >= 1


def test_failed_host_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises."""
    bad = tmp_path / 'broken.cpp'
    bad.write_text('int f( {\n')
    monkeypatch.setattr(_build, 'CSRC', tmp_path)
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    libs = _build._Libraries()
    with pytest.raises(RuntimeError, match='broken'):
        libs.host('broken')
    assert not list((tmp_path / 'build').glob('*.so'))


def test_port_native_imports_nothing_of_jax():
    roots = set()
    for name in ('native/core.py', 'native/__init__.py', 'data/loader.py',
                 'data/recordio.py', 'data/__init__.py'):
        tree = ast.parse((REPO / 'chainermn_tpu_torch' / name).read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                roots |= {a.name.split('.')[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                roots.add(node.module.split('.')[0])
    assert not roots & {'jax', 'jaxlib', 'flax', 'optax', 'ml_dtypes',
                        'chainermn_tpu'}, roots


# ---------------------------------------------------------------------
# arena, pack, unpack

def test_arena_grow_only():
    a = native.Arena()
    a.assign(100)
    cap = a.capacity
    assert cap >= 100
    a.assign(50)
    assert a.capacity == cap
    a.assign(1000)
    assert a.capacity >= 1000
    view = a.asarray(16, np.float32)
    assert view.shape == (4,) and view.ctypes.data % 64 == 0


def test_pack_unpack_roundtrip_equal_jax():
    rng = np.random.RandomState(0)
    arrays = [rng.rand(17).astype(np.float32),
              rng.rand(3, 5).astype(np.float64),
              (rng.rand(2, 2, 2) * 100).astype(np.int32),
              np.zeros(0, np.float32)]
    flat = native.pack_arrays(arrays)
    np.testing.assert_array_equal(flat, jnative.pack_arrays(arrays))
    assert flat.nbytes == sum(a.nbytes for a in arrays)
    for a, b in zip(arrays, native.unpack_arrays(flat, arrays)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(a, b.reshape(a.shape))
    arena = native.Arena()
    packed = native.pack_arrays(arrays[:2], arena=arena)
    np.testing.assert_array_equal(packed, flat[:packed.nbytes])
    assert arena.capacity >= packed.nbytes


# ---------------------------------------------------------------------
# augment_batch

def _case(seed, n, h, w, c, b, crop):
    rng = np.random.RandomState(seed)
    samples = (rng.rand(n, h, w, c) * 255).astype(np.float32)
    samples[0, 0, 0, 0] = -0.0
    mean = samples.mean(axis=0)
    idx = rng.randint(0, n, b)
    tops = rng.randint(0, h - crop + 1, b).astype(np.int32)
    lefts = rng.randint(0, w - crop + 1, b).astype(np.int32)
    flips = (rng.rand(b) > 0.5).astype(np.uint8)
    return samples, mean, idx, tops, lefts, flips


@pytest.mark.parametrize('with_mean', [False, True])
@pytest.mark.parametrize('shape', [(5, 12, 14, 3, 9, 8),
                                   (6, 40, 40, 3, 17, 32),
                                   (3, 9, 9, 1, 4, 9)])
def test_augment_batch_bit_equal_to_jax(with_mean, shape):
    n, h, w, c, b, crop = shape
    samples, mean, idx, tops, lefts, flips = _case(sum(shape), *shape)
    mean = mean if with_mean else None
    for scale in (1.0 / 255.0, 0.5):
        got = native.augment_batch(samples, idx, tops, lefts, flips, crop,
                                   mean=mean, scale=scale)
        want = jnative.augment_batch(samples, idx, tops, lefts, flips,
                                     crop, mean=mean, scale=scale)
        ref = _augment_ref(samples, idx, tops, lefts, flips, crop,
                           mean=mean, scale=scale)
        assert got.dtype == np.float32 and got.shape == (b, crop, crop, c)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))
    out = np.empty_like(got)
    assert native.augment_batch(samples, idx, tops, lefts, flips, crop,
                                mean=mean, scale=0.5, out=out) is out


def test_augment_batch_of_nothing():
    samples = np.zeros((2, 4, 4, 1), np.float32)
    out = native.augment_batch(samples, [], [], [], [], 4)
    assert out.shape == (0, 4, 4, 1)


@pytest.mark.parametrize('args', [
    ((1, 4, 4, 1), [0], [3], [3], [0], 4),     # window outside
    ((1, 4, 4, 1), [0], [0], [0], [0], 5),     # crop larger than sample
    ((2, 4, 4, 1), [-1], [0], [0], [0], 4),    # negative index
    ((2, 4, 4, 1), [2], [0], [0], [0], 4),     # index past the end
    ((1, 6, 6, 1), [0], [0], [3], [0], 4),     # left outside
])
def test_bad_windows_and_indices_rejected_as_jax(args):
    shape, idx, tops, lefts, flips, crop = args
    samples = np.zeros(shape, np.float32)
    with pytest.raises(ValueError) as ours:
        native.augment_batch(samples, idx, tops, lefts, flips, crop)
    with pytest.raises(ValueError) as theirs:
        jnative.augment_batch(samples, idx, tops, lefts, flips, crop)
    assert str(ours.value) == str(theirs.value)
    with pytest.raises(ValueError, match='mean shape'):
        native.augment_batch(np.zeros((1, 4, 4, 1), np.float32), [0],
                             [0], [0], [0], 4, mean=np.zeros((4, 4, 3)))


def test_kernel_itself_refuses_a_window_outside_with_status_4():
    """Past the wrapper's checks, the C function returns the same
    invalid-argument status (4) in both libraries."""
    samples = np.zeros((1, 4, 4, 1), np.float32)
    out = np.empty((1, 2, 2, 1), np.float32)
    idx = np.zeros(1, np.int64)
    tops = np.array([3], np.int32)
    zero32, flips = np.zeros(1, np.int32), np.zeros(1, np.uint8)

    def call(lib, crop):
        return lib.cmn_augment_batch(
            samples.ctypes.data_as(ctypes.c_void_p), 4, 4, 1,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            tops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            zero32.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            1, crop, None, 1.0, out.ctypes.data_as(ctypes.c_void_p))

    for lib in (core._lib(), jnative.core._lib):
        assert call(lib, 2) == 4   # window rows 3..4 of 4
        assert call(lib, 5) == 4   # crop beyond the sample
    with pytest.raises(native.CommError) as ei:
        core._check(call(core._lib(), 2))
    assert ei.value.status == 4 and 'invalid argument' in str(ei.value)


# ---------------------------------------------------------------------
# NativeCommunicator

def test_collectives_across_two_spawned_processes():
    native.lib_path()   # built once here, not by each rank
    ctx = mp.get_context('spawn')
    n = 2
    comm_id = native.NativeCommunicator.make_comm_id()
    queue = ctx.Queue()
    procs = [ctx.Process(target=torch_native_worker.run,
                         args=(comm_id, n, r, queue)) for r in range(n)]
    try:
        for p in procs:
            p.start()
        results = dict(queue.get(timeout=90) for _ in range(n))
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        shm = '/dev/shm' + comm_id
        if os.path.exists(shm):
            os.unlink(shm)
    assert not any(p.is_alive() for p in procs)
    errors = {r: v for r, v in results.items() if isinstance(v, str)}
    assert not errors, errors
    assert not os.path.exists('/dev/shm' + comm_id)   # rank 0 unlinked it
    base = np.arange(6, dtype=np.float32)
    bf = [torch.arange(6, dtype=torch.bfloat16) * 0.5 + r for r in range(n)]
    bf_sum = (bf[0].float() + bf[1].float()).to(torch.bfloat16)
    for r in range(n):
        got = results[r]
        np.testing.assert_array_equal(got['allreduce'], base * 2 + 1)
        np.testing.assert_array_equal(got['allreduce_max_i64'], [1, 0])
        assert got['allreduce_f16'].dtype == np.float16
        np.testing.assert_array_equal(got['allreduce_f16'], base * 2 + 1)
        assert got['allreduce_bf16_dtype'] == 'torch.bfloat16'
        np.testing.assert_array_equal(
            got['allreduce_bf16'], bf_sum.view(torch.int16).numpy())
        np.testing.assert_array_equal(got['bcast'], base + 1)
        np.testing.assert_array_equal(
            got['reduce_scatter'],
            np.arange(4, dtype=np.float32)[2 * r:2 * r + 2] * 2 + 1)
        np.testing.assert_array_equal(got['allgather'], [0.0, 1.0])
        np.testing.assert_array_equal(got['allgather_i32'], [0, 10, 1, 11])
    np.testing.assert_array_equal(results[0]['reduce'], base + 1)
    assert results[1]['reduce'] is None
    assert results[0]['reduce_prod'] is None
    np.testing.assert_array_equal(results[1]['reduce_prod'],
                                  (base + 1) * (base + 2))


def test_single_rank_identities_and_kinds():
    c = native.NativeCommunicator(native.NativeCommunicator.make_comm_id(),
                                  1, 0)
    try:
        assert (c.rank, c.size) == (0, 1)
        x = np.arange(4, dtype=np.float32)
        np.testing.assert_array_equal(c.allreduce(x), x)
        np.testing.assert_array_equal(c.allgather(x), x)
        t = torch.arange(4, dtype=torch.bfloat16).reshape(2, 2)
        out = c.allreduce(t, 'max')
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
        assert out.shape == (2, 2) and torch.equal(out, t)
        assert torch.equal(c.bcast(t), t)
        np.testing.assert_array_equal(c.reduce_scatter(x), x)
    finally:
        c.destroy()
    c.destroy()   # idempotent


def test_error_taxonomy_equal_jax():
    ours = native.NativeCommunicator(
        native.NativeCommunicator.make_comm_id(), 1, 0, slot_bytes=64)
    theirs = jnative.NativeCommunicator(
        jnative.NativeCommunicator.make_comm_id(), 1, 0, slot_bytes=64)
    try:
        for bad in (np.zeros(1000, np.float32), np.zeros(2, np.complex64)):
            with pytest.raises(native.CommError) as a:
                ours.allreduce(bad)
            with pytest.raises(jnative.CommError) as b:
                theirs.allreduce(bad)
            assert a.value.status == b.value.status
            assert str(a.value) == str(b.value)
        with pytest.raises(native.CommError) as a:
            ours.allreduce(torch.zeros(2, dtype=torch.complex64))
        assert a.value.status == 4
        with pytest.raises(native.CommError) as a:
            ours.reduce(np.zeros(2, np.float32), root=3)
        assert a.value.status == 4
    finally:
        ours.destroy()
        theirs.destroy()
    with pytest.raises(native.CommError) as a:
        native.NativeCommunicator('/cmn-bad', 2, 5)
    assert a.value.status == 2
    assert [str(native.CommError(s)) for s in range(10)] == \
        [str(jnative.CommError(s)) for s in range(10)]
    for s in range(9):
        assert core._lib().cmn_error_string(s).decode() == core._STATUS[s]


def test_comm_ids_unique():
    ids = {native.NativeCommunicator.make_comm_id() for _ in range(64)}
    assert len(ids) == 64
    assert all(i.startswith('/cmn-') and len(i) == 29 for i in ids)
