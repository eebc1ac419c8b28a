"""Build and load the hand-written CUDA kernels.

Every ``chainermn_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``.  Builds happen once, at first use, into
``build/chainermn_tpu_torch/`` at the root of the checkout, and every
missing library is compiled at the same time (one ``nvcc`` process per
source).

The cache key is a hash of the source and the compiler flags: editing a
``.cu`` file builds a new library under a new name.  A library is written
to a temporary name and renamed into place, so a second process of the
same run never loads a half-written file.  A failed build raises.
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


def _library_path(src):
    digest = hashlib.sha256()
    digest.update(src.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
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
