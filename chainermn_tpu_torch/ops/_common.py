"""Shared plumbing for the kernel layer.

Counterpart of ``chainermn_tpu/ops/_common.py``.  Dispatch goes by the
tensor's device alone: a CUDA tensor launches the hand-written kernel, a
CPU tensor takes the plain PyTorch version.  There is no switch that
swaps one for the other, and a CUDA tensor never takes the plain
version: a kernel that fails to build or launch raises.
"""

import contextlib
import ctypes
import functools
import threading

import torch

#: the element types' codes in the kernels' C interfaces
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the types every kernel takes; the BN kernels take float16 as well
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

#: the finite "minus infinity" of masked attention scores (the JAX
#: package's convention: exp(NEG_INF - m) underflows to 0, never NaN)
NEG_INF = -1e30


def resolve_device(device=None):
    """The device an entry point runs on: ``device`` as given, else the
    current CUDA device.  Raises when no device is given and CUDA is not
    available -- nothing carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            'no CUDA device is available; pass device="cpu" to run the '
            'plain PyTorch versions on the CPU')
    return torch.device('cuda', torch.cuda.current_device())


def on_cuda(*tensors):
    """True when the tensors lie on a CUDA device (launch the kernel),
    False when they lie on the CPU (plain version).  Raises on a mix of
    devices or on any other device type."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError('tensors on different devices: %s'
                         % sorted(map(str, devices)))
    kind = devices.pop().type
    if kind == 'cuda':
        return True
    if kind == 'cpu':
        return False
    raise ValueError('unsupported device type %r' % kind)


def forbid_grad(what, *tensors):
    """Raise when autograd would record a forward-only op (the JAX
    package gives it no backward either)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            '%s is forward-only, as in the JAX package: call it under '
            'torch.no_grad() or torch.inference_mode()' % what)


def dtype_code(t, what, dtypes=KERNEL_DTYPES):
    """``t``'s code in :data:`DTYPE_CODES`; raises TypeError unless its
    dtype is one of ``dtypes`` (the kernel's instantiations)."""
    if t.dtype not in dtypes:
        raise TypeError('%s: dtype %s is not supported by the kernel (%s)'
                        % (what, t.dtype, ' or '.join(
                            str(d).replace('torch.', '') for d in dtypes)))
    return DTYPE_CODES[t.dtype]


def ptr(t):
    return ctypes.c_void_p(t.data_ptr()) if t is not None \
        else ctypes.c_void_p(None)


def stream_ptr(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(err, strerror, what):
    """Raise when the C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError('%s: CUDA error %d (%s)' % (
            what, err, strerror(err).decode(errors='replace')))


# (device, stream) -> ticket counters of the kernels whose last block
# finishes a launch (the decode merge, the BN column sums): zero between
# launches (each launch's last block leaves its counters at zero), so they
# are allocated once, zeroed, and kept; one set a stream, since launches
# on one stream never overlap
_TICKETS = {}

# the counters of the CUDA graph this thread is capturing (None: none)
_CAPTURE = threading.local()


def tickets(device, n):
    """At least ``n`` int32 ticket counters, zero, for launches on the
    current stream of ``device``.  While a CUDA graph is being captured
    they are the capture's own (:func:`capture_tickets`): a graph replays
    its launches with the counters it was captured with, so they must be
    neither memory of a graph's pool nor counters that an eager launch
    or another graph uses."""
    stream = torch.cuda.current_stream(device)
    if torch.cuda.is_current_stream_capturing():
        found = getattr(_CAPTURE, 'tickets', None)
        if found is None or found.numel() < n:
            raise RuntimeError(
                'a CUDA graph capture needs ticket counters of its own (%d '
                'wanted, %s given): capture through serving.engine.'
                'capture_graph' % (n, None if found is None
                                   else found.numel()))
        return found
    key = (torch.device(device), stream.cuda_stream)
    found = _TICKETS.get(key)
    if found is None or found.numel() < n:
        found = torch.zeros(n, dtype=torch.int32, device=device)
        _TICKETS[key] = found
    return found


def release_tickets(stream):
    """Take the ticket counters of ``stream`` out of the shared table and
    return them (None when no launch on it took any): the counters of a
    warm-up on a capture's side stream, which the capture then owns."""
    found = None
    for key in [k for k in _TICKETS if k[1] == stream.cuda_stream]:
        found = _TICKETS.pop(key)
    return found


@contextlib.contextmanager
def capture_tickets(counters):
    """While a CUDA graph is captured on this thread, :func:`tickets`
    hands out ``counters`` (zero, allocated outside any graph's pool, and
    kept by the graph for as long as it may replay)."""
    before = getattr(_CAPTURE, 'tickets', None)
    _CAPTURE.tickets = counters
    try:
        yield
    finally:
        _CAPTURE.tickets = before


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device):
    """Streaming multiprocessors of a CUDA device (cached: the launch
    wrappers ask on every call)."""
    return _sm_count(torch.device(device).index
                     if torch.device(device).index is not None
                     else torch.cuda.current_device())
