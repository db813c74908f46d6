"""Build and load the CUDA kernels of ``csrc/`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface and loaded with ``ctypes`` (no PyTorch headers, so a build takes
seconds).  Libraries go to ``build/ciri_torch_kernels/`` at the root of the
checkout, named by a hash of the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  A failed build raises.
Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / 'csrc'
BUILD_DIR = _PKG.parent / 'build' / 'ciri_torch_kernels'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_LOCK = threading.Lock()
_LIBS = {}
# source name -> ptxas report (registers, spills) of the last build
BUILD_LOGS = {}


def _nvcc():
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME') or '/usr/local/cuda'
    cand = os.path.join(home, 'bin', 'nvcc')
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found on PATH or under CUDA_HOME '
                       '(needed to build csrc/ kernels)')


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` if its library is missing; returns the
    library path."""
    src = CSRC / source
    text = src.read_bytes()
    tag = hashlib.sha1(text + ' '.join(NVCC_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / '{}_{}.so'.format(src.stem, tag)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix('.so.tmp{}'.format(os.getpid()))
    cmd = [_nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError('nvcc failed ({}) building {}:\n{}{}'.format(
            proc.returncode, src, proc.stdout, proc.stderr))
    os.replace(tmp, lib)
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    return lib


def build_all(sources):
    """Compile several sources at once, one nvcc each, all started
    together; returns {source: library path}.  Raises if any build fails."""
    with ThreadPoolExecutor(max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def load(source: str, symbols):
    """ctypes handle on the built ``csrc/<source>``; ``symbols`` maps each
    C function name to its (argtypes, restype)."""
    with _LOCK:
        if source not in _LIBS:
            handle = ctypes.CDLL(str(build(source)))
            for name, (argtypes, restype) in symbols.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _LIBS[source] = handle
        return _LIBS[source]
