"""Build and load the hand-written CUDA kernels and the host C++ core.

Every ``chainermn_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``.  Builds happen once, at first use, into
``build/chainermn_tpu_torch/`` at the root of the checkout, and every
missing library is compiled at the same time (one ``nvcc`` process per
source).  The host route (:meth:`_Libraries.host`) builds a
``csrc/<name>.cpp`` the same way with the host compiler (``g++ -O3
-std=c++17 -shared -fPIC -pthread``; no ``-ffast-math`` and no
``-march=native``, so its float arithmetic is numpy's, bit for bit).

The cache key is a hash of the source and the compiler flags: editing a
source builds a new library under a new name.  A library is written to a
temporary name and renamed into place, so a second process of the same
run (or a second test worker) never loads a half-written file.  A failed
build raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = (Path(__file__).resolve().parent.parent.parent / 'build'
             / 'chainermn_tpu_torch')
# -Xptxas -v: each kernel's registers, shared memory and spills go to
# the build log
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
HOST_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC', '-pthread')


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH') \
        or '/usr/local/cuda'
    path = os.path.join(home, 'bin', 'nvcc')
    if not os.path.exists(path):
        raise RuntimeError(
            'nvcc not found (looked on PATH and in %s): the CUDA kernels '
            'of chainermn_tpu_torch need the CUDA toolkit' % path)
    return path


def _host_compiler():
    found = shutil.which('g++')
    if not found:
        raise RuntimeError('g++ not found on PATH: the host core of '
                           'chainermn_tpu_torch (csrc/*.cpp) needs it')
    return found


def _library_path(src, flags=NVCC_FLAGS):
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    digest.update(' '.join(flags).encode())
    return BUILD_DIR / ('lib%s-%s.so' % (src.stem, digest.hexdigest()[:16]))


class _Libraries:
    """The loaded kernel libraries, built on first request."""

    def __init__(self):
        self._lock = threading.Lock()
        self._loaded = {}

    def build_all(self):
        """Compile every source whose library is missing, all at once;
        returns ``{name: seconds}`` of the builds it ran (empty when the
        cache was complete).  The compiler's output of every build is
        kept beside the library as ``.log``."""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = {}
        for src in sorted(CSRC.glob('*.cu')):
            out = _library_path(src)
            if out.exists():
                continue
            tmp = out.with_name('%s.tmp%d' % (out.name, os.getpid()))
            cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
                   str(src)]
            jobs[src.stem] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT),
                tmp, out, time.perf_counter())
        times, failures = {}, []
        for name, (proc, tmp, out, t0) in jobs.items():
            log, _ = proc.communicate()
            times[name] = time.perf_counter() - t0
            out.with_suffix('.log').write_bytes(log)
            if proc.returncode != 0:
                failures.append('%s (nvcc exit %d):\n%s' % (
                    name, proc.returncode, log.decode(errors='replace')))
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)  # atomic: readers see all or nothing
        if failures:
            raise RuntimeError('CUDA kernel build failed: '
                               + '\n'.join(failures))
        return times

    def build_host(self, name):
        """Compile ``csrc/<name>.cpp`` with the host compiler unless its
        library exists; returns ``(path, seconds)`` (0 on a cache hit).
        The compiler's output is kept beside the library as ``.log``."""
        src = CSRC / ('%s.cpp' % name)
        out = _library_path(src, HOST_FLAGS)
        if out.exists():
            return out, 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name('%s.tmp%d' % (out.name, os.getpid()))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_host_compiler(), *HOST_FLAGS, str(src), '-o', str(tmp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, timeout=600)
        out.with_suffix('.log').write_bytes(proc.stdout)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError('host library build failed: %s (g++ exit '
                               '%d):\n%s' % (name, proc.returncode,
                                             proc.stdout.decode(
                                                 errors='replace')))
        os.replace(tmp, out)  # atomic: readers see all or nothing
        return out, time.perf_counter() - t0

    def host(self, name):
        """The ``ctypes`` handle of ``csrc/<name>.cpp``'s library."""
        key = name + '.cpp'
        with self._lock:
            lib = self._loaded.get(key)
            if lib is None:
                path, _ = self.build_host(name)
                lib = ctypes.CDLL(str(path))
                self._loaded[key] = lib
            return lib

    def get(self, name):
        """The ``ctypes`` handle of ``csrc/<name>.cu``'s library."""
        with self._lock:
            lib = self._loaded.get(name)
            if lib is None:
                src = CSRC / ('%s.cu' % name)
                path = _library_path(src)
                if not path.exists():
                    self.build_all()
                lib = ctypes.CDLL(str(path))
                self._loaded[name] = lib
            return lib


LIBRARIES = _Libraries()
