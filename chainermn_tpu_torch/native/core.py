"""``ctypes`` bindings of the port's native host core
(``chainermn_tpu_torch/csrc/chainermn_core.cpp``).

Counterpart of ``chainermn_tpu/native/core.py``: the grow-only
:class:`Arena`, :func:`pack_arrays` / :func:`unpack_arrays`, the batch
augmentation :func:`augment_batch` (crop + flip + mean-subtract + scale
on a C++ thread pool) and :class:`NativeCommunicator`, the shared-memory
host collectives with the reference NCCL binding's surface and error
taxonomy (:class:`CommError`).

The library is built at first use by ``ops._build.LIBRARIES.host`` into
``build/chainermn_tpu_torch/`` (never beside the JAX package's own
``.so``).  A failed build raises: there is no flag that turns the
callers into numpy.  The collectives take numpy arrays or CPU tensors;
bfloat16 travels as a ``torch.bfloat16`` tensor's raw bytes (numpy has
no such dtype).
"""

import ctypes
import threading
import uuid

import numpy as np
import torch

_STATUS = ['success', 'unhandled error', 'system error', 'internal error',
           'invalid argument', 'invalid usage', 'buffer overflow',
           'timeout', 'rank mismatch']

# the enums of chainermn_core.cpp
_OPS = {'sum': 0, 'prod': 1, 'max': 2, 'min': 3}
_NP_DTYPES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1,
              np.dtype(np.int32): 2, np.dtype(np.int64): 3,
              np.dtype(np.float16): 5}
_TORCH_DTYPES = {torch.float32: 0, torch.float64: 1, torch.int32: 2,
                 torch.int64: 3, torch.bfloat16: 4, torch.float16: 5}


class CommError(RuntimeError):
    """A non-zero status of the native core (parity: NcclError,
    ``nccl.pyx:94-104``); ``status`` is the code."""

    def __init__(self, status):
        self.status = status
        msg = (_STATUS[status] if 0 <= status < len(_STATUS)
               else 'unknown error')
        super().__init__('%s (status=%d)' % (msg, status))


_LIB = None
_LIB_LOCK = threading.Lock()


def _declare(lib):
    lib.cmn_error_string.restype = ctypes.c_char_p
    lib.cmn_error_string.argtypes = [ctypes.c_int]
    lib.cmn_pool_threads.restype = ctypes.c_int
    lib.cmn_pool_threads.argtypes = []
    lib.cmn_arena_create.restype = ctypes.c_void_p
    lib.cmn_arena_create.argtypes = []
    lib.cmn_arena_assign.restype = ctypes.c_int
    lib.cmn_arena_assign.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    lib.cmn_arena_ptr.restype = ctypes.c_void_p
    lib.cmn_arena_ptr.argtypes = [ctypes.c_void_p]
    lib.cmn_arena_capacity.restype = ctypes.c_size_t
    lib.cmn_arena_capacity.argtypes = [ctypes.c_void_p]
    lib.cmn_arena_destroy.restype = None
    lib.cmn_arena_destroy.argtypes = [ctypes.c_void_p]
    for name in ('cmn_pack', 'cmn_unpack'):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_size_t), ctypes.c_int]
    lib.cmn_augment_batch.restype = ctypes.c_int
    lib.cmn_augment_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_float,
        ctypes.c_void_p]
    lib.cmn_comm_create.restype = ctypes.c_void_p
    lib.cmn_comm_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int64,
                                    ctypes.c_double]
    lib.cmn_comm_destroy.restype = None
    lib.cmn_comm_destroy.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.cmn_comm_rank.restype = ctypes.c_int
    lib.cmn_comm_rank.argtypes = [ctypes.c_void_p]
    lib.cmn_comm_size.restype = ctypes.c_int
    lib.cmn_comm_size.argtypes = [ctypes.c_void_p]
    lib.cmn_allreduce.restype = ctypes.c_int
    lib.cmn_allreduce.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_int]
    lib.cmn_reduce.restype = ctypes.c_int
    lib.cmn_reduce.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.cmn_bcast.restype = ctypes.c_int
    lib.cmn_bcast.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int64, ctypes.c_int, ctypes.c_int]
    lib.cmn_reduce_scatter.restype = ctypes.c_int
    lib.cmn_reduce_scatter.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int, ctypes.c_int]
    lib.cmn_allgather.restype = ctypes.c_int
    lib.cmn_allgather.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_int]
    lib.cmn_barrier.restype = ctypes.c_int
    lib.cmn_barrier.argtypes = [ctypes.c_void_p]
    return lib


def _lib():
    """The loaded library, built on first use (a failed build raises)."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            from chainermn_tpu_torch.ops._build import LIBRARIES
            _LIB = _declare(LIBRARIES.host('chainermn_core'))
        return _LIB


def lib_path():
    """Where the library is (built first when it is not)."""
    from chainermn_tpu_torch.ops._build import LIBRARIES
    return str(LIBRARIES.build_host('chainermn_core')[0])


def pool_threads():
    """The most threads one augmentation or pack call runs on."""
    return _lib().cmn_pool_threads()


def _check(status):
    if status != 0:
        raise CommError(status)


def _as_void_p_array(arrays):
    ptrs = (ctypes.c_void_p * len(arrays))()
    sizes = (ctypes.c_size_t * len(arrays))()
    for i, a in enumerate(arrays):
        ptrs[i] = a.ctypes.data_as(ctypes.c_void_p)
        sizes[i] = a.nbytes
    return ptrs, sizes


class Arena:
    """Grow-only 64-byte aligned host buffer (parity: DeviceMemory,
    ``_memory_utility.py:43-74``)."""

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.cmn_arena_create()

    @property
    def capacity(self):
        return self._lib.cmn_arena_capacity(self._h)

    def assign(self, nbytes):
        _check(self._lib.cmn_arena_assign(self._h, nbytes))

    def asarray(self, nbytes, dtype=np.uint8):
        """numpy view of the first ``nbytes`` bytes."""
        self.assign(nbytes)
        ptr = self._lib.cmn_arena_ptr(self._h)
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype)

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.cmn_arena_destroy(self._h)
            self._h = None


def pack_arrays(arrays, arena=None):
    """Fuse a list of numpy arrays into one flat ``uint8`` buffer
    (parity: pack_params, ``_memory_utility.py:77-83``)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    total = sum(a.nbytes for a in arrays)
    out = np.empty(total, np.uint8) if arena is None \
        else arena.asarray(total)
    ptrs, sizes = _as_void_p_array(arrays)
    _check(_lib().cmn_pack(out.ctypes.data_as(ctypes.c_void_p), ptrs,
                           sizes, len(arrays)))
    return out


def unpack_arrays(flat, templates):
    """Scatter a packed buffer back into arrays shaped like
    ``templates`` (parity: unpack_params,
    ``_memory_utility.py:86-92``)."""
    outs = [np.empty_like(np.ascontiguousarray(t)) for t in templates]
    ptrs, sizes = _as_void_p_array(outs)
    _check(_lib().cmn_unpack(flat.ctypes.data_as(ctypes.c_void_p), ptrs,
                             sizes, len(outs)))
    return outs


def augment_batch(samples, indices, tops, lefts, flips, crop, mean=None,
                  scale=1.0 / 255.0, out=None):
    """Crop + horizontal flip + mean-subtract + scale of a batch on the
    native thread pool: ``out[i] = (samples[indices[i]][window] -
    mean[window]) * scale``, flipped where ``flips[i]``, in float32 in
    that order (the mean window tracks the crop window and is subtracted
    before the flip).

    samples: ``(N, H, W, C)`` float32; indices / tops / lefts / flips:
    each batch item's source sample and window; returns ``(B, crop,
    crop, C)`` float32.  Every index is validated here (the C function
    is not told N), with the JAX package's ``ValueError``s.
    """
    samples = np.ascontiguousarray(samples, np.float32)
    n, h, w, c = samples.shape
    b = len(indices)
    indices = np.ascontiguousarray(indices, np.int64)
    tops = np.ascontiguousarray(tops, np.int32)
    lefts = np.ascontiguousarray(lefts, np.int32)
    flips = np.ascontiguousarray(flips, np.uint8)
    if crop > h or crop > w:
        raise ValueError('crop %d exceeds sample size (%d, %d)'
                         % (crop, h, w))
    if b:
        if indices.min() < 0 or indices.max() >= n:
            raise ValueError('sample_indices out of range [0, %d)' % n)
        if tops.min() < 0 or tops.max() > h - crop:
            raise ValueError('tops out of range [0, %d]' % (h - crop))
        if lefts.min() < 0 or lefts.max() > w - crop:
            raise ValueError('lefts out of range [0, %d]' % (w - crop))
    if not len(tops) == len(lefts) == len(flips) == b:
        raise ValueError('indices, tops, lefts and flips differ in length')
    if out is None:
        out = np.empty((b, crop, crop, c), np.float32)
    elif (out.dtype != np.float32 or out.shape != (b, crop, crop, c)
          or not out.flags.c_contiguous):
        raise ValueError('out must be a C-contiguous float32 array of '
                         'shape %r' % ((b, crop, crop, c),))
    mean_ptr = None
    if mean is not None:
        mean = np.ascontiguousarray(mean, np.float32)
        if mean.shape != (h, w, c):
            raise ValueError('mean shape %r != sample shape %r'
                             % (mean.shape, (h, w, c)))
        mean_ptr = mean.ctypes.data_as(ctypes.c_void_p)
    _check(_lib().cmn_augment_batch(
        samples.ctypes.data_as(ctypes.c_void_p), h, w, c,
        indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        tops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lefts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        flips.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b, crop, mean_ptr, scale,
        out.ctypes.data_as(ctypes.c_void_p)))
    return out


def _operand(x):
    """``(contiguous host buffer, dtype code)`` of a numpy array or a
    tensor (copied to the CPU when it is not there); an unsupported
    dtype is ``CommError(4)``, invalid argument."""
    if isinstance(x, torch.Tensor):
        buf = x.detach().cpu().contiguous()
        code = _TORCH_DTYPES.get(buf.dtype)
    else:
        buf = np.ascontiguousarray(x)
        code = _NP_DTYPES.get(buf.dtype)
    if code is None:
        raise CommError(4)
    return buf, code


def _ptr(buf):
    if buf is None:
        return None
    if isinstance(buf, torch.Tensor):
        return ctypes.c_void_p(buf.data_ptr())
    return buf.ctypes.data_as(ctypes.c_void_p)


def _size(buf):
    return buf.numel() if isinstance(buf, torch.Tensor) else buf.size


def _empty(buf, n=None):
    """A new buffer of ``buf``'s kind and dtype: its shape, or ``n``
    elements flat."""
    if isinstance(buf, torch.Tensor):
        return (torch.empty_like(buf) if n is None
                else torch.empty(n, dtype=buf.dtype))
    return np.empty_like(buf) if n is None else np.empty(n, buf.dtype)


class NativeCommunicator:
    """Shared-memory host collectives among processes of one host.

    Parity surface with the reference's ``NcclCommunicator``
    (``nccl.pyx:118-199``): five collectives, the comm-id handshake and
    the error taxonomy.  Each call returns a new buffer of its input's
    kind (numpy array or CPU tensor).  Rank 0 unlinks the shared-memory
    segment in :meth:`destroy`.
    """

    @staticmethod
    def make_comm_id():
        """A fresh segment name (parity: ncclGetUniqueId,
        ``nccl.pyx:107-115``)."""
        return '/cmn-' + uuid.uuid4().hex[:24]

    def __init__(self, comm_id, n_ranks, rank, slot_bytes=1 << 20,
                 timeout=60.0):
        self._lib = _lib()
        self._h = None
        h = self._lib.cmn_comm_create(comm_id.encode(), n_ranks, rank,
                                      slot_bytes, timeout)
        if not h:
            raise CommError(2)
        self._h = h
        self._rank = rank
        self._size = n_ranks
        self._owner = rank == 0

    rank = property(lambda self: self._rank)
    size = property(lambda self: self._size)

    def allreduce(self, arr, op='sum'):
        buf, code = _operand(arr)
        out = _empty(buf)
        _check(self._lib.cmn_allreduce(self._h, _ptr(buf), _ptr(out),
                                       _size(buf), code, _OPS[op]))
        return out

    def reduce(self, arr, op='sum', root=0):
        """The reduction on ``root``; None elsewhere."""
        buf, code = _operand(arr)
        out = _empty(buf) if self._rank == root else None
        _check(self._lib.cmn_reduce(self._h, _ptr(buf), _ptr(out),
                                    _size(buf), code, _OPS[op], root))
        return out

    def bcast(self, arr, root=0):
        buf, code = _operand(arr)
        out = buf.clone() if isinstance(buf, torch.Tensor) else buf.copy()
        _check(self._lib.cmn_bcast(self._h, _ptr(out), _size(out), code,
                                   root))
        return out

    def reduce_scatter(self, arr, op='sum'):
        """Rank r gets the reduction of everyone's r-th chunk of
        ``size(arr) / n_ranks`` elements."""
        buf, code = _operand(arr)
        if _size(buf) % self._size:
            raise CommError(4)
        recvcount = _size(buf) // self._size
        out = _empty(buf, recvcount)
        _check(self._lib.cmn_reduce_scatter(self._h, _ptr(buf), _ptr(out),
                                            recvcount, code, _OPS[op]))
        return out

    def allgather(self, arr):
        """Every rank's elements, flat, in rank order."""
        buf, code = _operand(arr)
        out = _empty(buf, _size(buf) * self._size)
        _check(self._lib.cmn_allgather(self._h, _ptr(buf), _ptr(out),
                                       _size(buf), code))
        return out

    def barrier(self):
        _check(self._lib.cmn_barrier(self._h))

    def destroy(self):
        if self._h:
            self._lib.cmn_comm_destroy(self._h, 1 if self._owner else 0)
            self._h = None

    def __del__(self):
        try:
            self.destroy()
        except Exception:
            pass
