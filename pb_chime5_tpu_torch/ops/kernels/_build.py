"""Build and load the port's CUDA kernels at first use.

``nvcc`` compiles ``pb_chime5_tpu_torch/csrc/<name>.cu`` for ``sm_90a``
into a shared library with a plain C interface, which is loaded with
``ctypes`` (no PyTorch headers: the build takes seconds).  The library
goes to ``<repo>/build/pb_chime5_tpu_torch/``, keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the cached library.  Libraries asked for together build in
concurrent nvcc processes.  A failed build raises; there is no fallback.

Each library's C entry launches on the stream it is given and returns
the ``cudaError_t`` of the launch; :func:`kernel_entry` and
:func:`check_launch` are that convention on the Python side.

``stats`` counts the nvcc builds started and the libraries loaded in this
process: after ``GssPipeline.warmup`` a session's dispatches add to
neither (the port's reading of the JAX package's "no new compiles").
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ['load_libraries', 'load_library', 'kernel_entry', 'check_launch',
           'build_log', 'find_nvcc', 'stats', 'LIBRARIES', 'BUILD_DIR',
           'CSRC_DIR']

CSRC_DIR = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / \
    'pb_chime5_tpu_torch'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

# every kernel library of the port
LIBRARIES = ('fused_em', 'wpe_stats', 'gj_inverse', 'chol_solve')

_lock = threading.Lock()
_libraries = {}
stats = {'builds': 0, 'loads': 0}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
    ``nvcc`` on the PATH.  Raises when none exists."""
    candidates = []
    for var in ('CUDA_HOME', 'CUDA_PATH'):
        if os.environ.get(var):
            candidates.append(Path(os.environ[var]) / 'bin' / 'nvcc')
    candidates.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError(
            'nvcc not found (set CUDA_HOME); the CUDA kernels of '
            'pb_chime5_tpu_torch are built from source at first use')
    return found


def _library_path(name: str) -> Path:
    source = CSRC_DIR / f'{name}.cu'
    digest = hashlib.sha256(
        source.read_bytes() + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:16]}.so'


def _build(names) -> None:
    """Start one nvcc per library of ``names`` not built yet, all at once,
    and wait for them all; the compiler output goes to ``<library>.log``."""
    builds = []
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
        log = lib.with_suffix('.log')
        cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp),
               str(CSRC_DIR / f'{name}.cu')]
        with open(log, 'w') as out:
            out.write(f'{" ".join(cmd)}\n')
            out.flush()
            proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT)
        stats['builds'] += 1
        builds.append((lib, tmp, log, cmd, proc))
    start = time.perf_counter()
    for lib, tmp, log, cmd, proc in builds:
        if proc.wait() != 0:
            raise RuntimeError(f'nvcc failed ({proc.returncode}) building '
                               f'{lib.name}:\n{log.read_text()}')
        with open(log, 'a') as out:
            out.write(f'build_seconds={time.perf_counter() - start:.3f}\n')
        os.replace(tmp, lib)


def load_libraries(names) -> list:
    """Build (if needed) and load ``csrc/<name>.cu`` for each of
    ``names``; cached per process."""
    with _lock:
        missing = [name for name in names if name not in _libraries]
        _build(missing)
        for name in missing:
            _libraries[name] = ctypes.CDLL(str(_library_path(name)))
            stats['loads'] += 1
        return [_libraries[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    return load_libraries([name])[0]


@functools.cache
def kernel_entry(name: str, entry: str, argtypes: tuple):
    """The C function ``entry`` of library ``name``, typed with
    ``argtypes``, returning the launch's ``cudaError_t`` as an int."""
    fn = getattr(load_library(name), entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def check_launch(err: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if err:
        torch.cuda.cudart()          # the runtime bindings CudaError reads
        raise RuntimeError(f'{name} kernel launch failed: '
                           f'{torch.cuda.CudaError(err)}')


def build_log(name: str) -> str:
    """The compiler output (``-Xptxas -v`` register / shared-memory
    report) of the loaded build of ``name``; '' if its log is missing."""
    log = Path(load_library(name)._name).with_suffix('.log')
    return log.read_text() if log.exists() else ''
