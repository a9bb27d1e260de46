"""Build and load the port's native libraries at first use.

The CUDA kernels: ``nvcc`` compiles ``pb_chime5_tpu_torch/csrc/<name>.cu``
for ``sm_90a`` into a shared library with a plain C interface, which is
loaded with ``ctypes`` (no PyTorch headers: the build takes seconds).  The
host readers (``HOST_LIBRARIES``: the segmented WAV I/O and the interval
algebra): the host compiler (``$CXX``, else ``c++`` or ``g++``) compiles
``csrc/<name>.cpp`` the same way; they need no card and no CUDA.  A
library goes to ``<repo>/build/pb_chime5_tpu_torch/``, keyed by a hash of
the source and the flags, so an edited source rebuilds and an unchanged
one loads the cached library.  Libraries asked for together build in
concurrent compiler processes.  A failed build raises; there is no
fallback.

Each kernel library's C entry launches on the stream it is given and
returns the ``cudaError_t`` of the launch; :func:`kernel_entry` and
:func:`check_launch` are that convention on the Python side.

``stats`` counts the builds started and the libraries loaded in this
process, host libraries included: after ``GssPipeline.warmup`` a
session's dispatches add to neither (the port's reading of the JAX
package's "no new compiles").
"""

import ctypes
import functools
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ['load_libraries', 'load_library', 'kernel_entry', 'check_launch',
           'build_log', 'find_nvcc', 'find_cxx', 'compile_command', 'stats',
           'LIBRARIES', 'HOST_LIBRARIES', 'HOLD_GIL', 'BUILD_DIR', 'CSRC_DIR']

CSRC_DIR = Path(__file__).resolve().parents[2] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[3] / 'build' / \
    'pb_chime5_tpu_torch'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
HOST_FLAGS = ('-O3', '-std=c++17', '-shared', '-fPIC')

# every kernel library of the port
LIBRARIES = ('fused_em', 'wpe_stats', 'gj_inverse', 'chol_solve')
# the host readers: csrc/<name>.cpp, built with the host compiler
HOST_LIBRARIES = ('wav_ops', 'interval_ops')
# libraries whose calls take less than a hand-over of the GIL: loaded as
# ctypes.PyDLL, whose calls keep it, where a CDLL's release it and then wait
# for it behind the session's other threads (as a CPython extension that
# does not release it would)
HOLD_GIL = ('interval_ops',)

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


def find_cxx() -> list:
    """The host C++ compiler as a command: ``$CXX`` (split as a shell
    would), else ``c++`` or ``g++`` on the PATH.  Raises when none
    exists."""
    if os.environ.get('CXX'):
        return shlex.split(os.environ['CXX'])
    for name in ('c++', 'g++'):
        found = shutil.which(name)
        if found is not None:
            return [found]
    raise RuntimeError(
        'no host C++ compiler (set CXX); the host readers of '
        'pb_chime5_tpu_torch are built from csrc/*.cpp at first use')


def _source_and_flags(name: str):
    if name in HOST_LIBRARIES:
        return CSRC_DIR / f'{name}.cpp', HOST_FLAGS
    return CSRC_DIR / f'{name}.cu', NVCC_FLAGS


def compile_command(name: str, output) -> list:
    """The command that compiles library ``name`` into ``output``."""
    source, flags = _source_and_flags(name)
    compiler = find_cxx() if name in HOST_LIBRARIES else [find_nvcc()]
    return [*compiler, *flags, '-o', str(output), str(source)]


def _library_path(name: str) -> Path:
    source, flags = _source_and_flags(name)
    digest = hashlib.sha256(
        source.read_bytes() + ' '.join(flags).encode()).hexdigest()
    return BUILD_DIR / f'lib{name}-{digest[:16]}.so'


def _build(names) -> None:
    """Start one compiler per library of ``names`` not built yet, all at
    once, and wait for them all; the compiler output goes to
    ``<library>.log``."""
    builds = []
    for name in names:
        lib = _library_path(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f'.{os.getpid()}.tmp')
        log = lib.with_suffix('.log')
        cmd = compile_command(name, tmp)
        with open(log, 'w') as out:
            out.write(f'{" ".join(cmd)}\n')
            out.flush()
            try:
                proc = subprocess.Popen(cmd, stdout=out,
                                        stderr=subprocess.STDOUT)
            except OSError as e:
                raise RuntimeError(f'{cmd[0]} did not start building '
                                   f'{lib.name} (log {log}): {e}') from e
        stats['builds'] += 1
        builds.append((lib, tmp, log, cmd, proc))
    start = time.perf_counter()
    for lib, tmp, log, cmd, proc in builds:
        if proc.wait() != 0:
            raise RuntimeError(f'{cmd[0]} failed ({proc.returncode}) '
                               f'building {lib.name} (log {log}):\n'
                               f'{log.read_text()}')
        with open(log, 'a') as out:
            out.write(f'build_seconds={time.perf_counter() - start:.3f}\n')
        os.replace(tmp, lib)


def load_libraries(names) -> list:
    """Build (if needed) and load ``csrc/<name>.cu`` (``.cpp`` for the
    host libraries) for each of ``names``; cached per process."""
    with _lock:
        missing = [name for name in names if name not in _libraries]
        _build(missing)
        for name in missing:
            loader = ctypes.PyDLL if name in HOLD_GIL else ctypes.CDLL
            _libraries[name] = loader(str(_library_path(name)))
            stats['loads'] += 1
        return [_libraries[name] for name in names]


def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load library ``name``; cached per process."""
    return load_libraries([name])[0]


@functools.cache
def kernel_entry(name: str, entry: str, argtypes: tuple,
                 restype=ctypes.c_int):
    """The C function ``entry`` of library ``name``, typed with
    ``argtypes`` and ``restype`` (a kernel entry's: the launch's
    ``cudaError_t`` as an int)."""
    fn = getattr(load_library(name), entry)
    fn.argtypes = list(argtypes)
    fn.restype = restype
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
