"""K5 (``csrc/chol_solve.cu``: the blocked Cholesky solve, the WPE filter
solve of the default path) on the card: its parts switched off in copies
of its source, and an earlier source, timed in turns at the headline.

    python scripts_dev/diag_k5_card.py [--parent OLD.cu]

* Parts: copies of the source with one device function's body emptied,
  each built by its own nvcc (all started together), its ptxas report
  printed: the substitutions (``forward_rhs``, ``forward_apply``,
  ``backward``), the
  trailing update with its look-ahead factor (``trailing``), the L21
  panel with its forward block (``panel_l21``), the diagonal-block
  factor (``factor_block``);
  and the trailing update without its old-tile loads or without its
  FMAs.  Their outputs are wrong; only their times are
  read: the kernel's time less a copy's is what that part costs on the
  critical path.
* Design variants, whole functions replaced (outputs checked equal to
  the kernel's): the diagonal-block factor on one warp, with its 32
  steps fully unrolled and shuffles (``factor_unrolled``) or rolled with
  shared-memory broadcasts (``factor_one_warp``), against the kernel's
  two warps (Cholesky steps and inverse rows side by side).
* Timing with CUDA events in turns at the WPE headline (513 HPD systems
  of 240 x 240, 24 right-hand sides, ``chip_smoke.py``'s inputs, load
  1e-4): the complex entry and each copy, the real instantiation on the
  real block form of the same systems, and ``--parent``'s
  ``pb_chol_solve`` (an earlier source of the real entry, e.g. the
  previous kernel, whose work buffer is (F, S, S)) on that block form.

Needs one CUDA card; imports the port only, never JAX.
"""

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from pb_chime5_tpu_torch.ops import linalg  # noqa: E402
from pb_chime5_tpu_torch.ops.kernels import _build, chol_solve  # noqa: E402
from tests.test_torch_kernels_cuda import (  # noqa: E402
    frobenius_errors, hpd_system)

OUT = REPO / 'build' / 'diag_k5'
LOAD = 1e-4
# each: (old, new) pairs edited into the source: the trailing update
# without its old-tile loads, or without its FMAs (and so without the
# shared-memory loads that feed them)
EDITS = {
    'trailing_no_loads': (
        ('copy_vec(prev[i], q.tile(R, C) + (4 * ry + i) * kB + 8 * cx);',
         'for (int jj = 0; jj < 8; ++jj) prev[i][jj] = T{};'),
        ('prev[i][jj] = as_elem(q.A, q.sinv, R * kB + 4 * ry + i,\n'
         '                              C * kB + 8 * cx + jj, q.d, q.load, '
         'true);', 'prev[i][jj] = T{};')),
    'trailing_no_fma': (
        ('for (int jj = 0; jj < 8; ++jj) fadd_cj(acc[i][jj], av[i], bv[jj]);',
         'if (i == 0) fadd_cj(acc[0][0], av[0], bv[0]);'),),
}


# the diagonal-block factor on warp 0 alone (warp 1 idle), as whole-
# function replacements: its 32 steps fully unrolled, the pivot columns
# and the inverse's rows by shuffles (the kernel's first form); and the
# rolled steps with both in shared memory (its second)
FACTOR_UNROLLED = """__device__ __forceinline__ float shfl2(float v, int src) {
  return __shfl_sync(kFull, v, src);
}
__device__ __forceinline__ float2 shfl2(float2 v, int src) {
  return make_float2(__shfl_sync(kFull, v.x, src),
                     __shfl_sync(kFull, v.y, src));
}

template <typename T>
__device__ __noinline__ void factor_block(T* dg, wide_t<T>* inv, float* rp,
                                          T* w, float pivfloor, int warp,
                                          int lane) {
  if (warp != 0) return;
  T prow[kB];
  T invc[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) {
    prow[c] = dg[lane * kB + c];
    invc[c] = T{};
  }
#pragma unroll
  for (int p = 0; p < kB; ++p) {
    const float piv = re(shfl2(prow[p], p));
    const float rpiv = sqrtf(max_nan(piv, pivfloor));
    const T lcol = lane >= p ? div_real(prow[p], rpiv) : T{};
#pragma unroll
    for (int c = p + 1; c < kB; ++c) {
      wide_t<T> a = {};
      madd_cj(a, wide(lcol), wide(shfl2(lcol, c)));
      prow[c] = sub(prow[c], rnd(a));
    }
    prow[p] = lcol;
    wide_t<T> acc = {};
#pragma unroll
    for (int s = 0; s < p; ++s)
      madd(acc, wide(shfl2(prow[s], p)), wide(invc[s]));
    invc[p] = div_real(sub(unit_of(T{}, lane == p), rnd(acc)), rpiv);
  }
#pragma unroll
  for (int s = 0; s < kB; ++s) {
    const T v = lane <= s ? invc[s] : T{};
    inv[s * kB + lane] = wide(v);
    w[s * kB + lane] = v;
  }
}"""
FACTOR_ONE_WARP = """template <int P0, int P1, typename T>
__device__ __forceinline__ void one_warp_steps(T (&prow)[kB],
                                               wide_t<T>* col,
                                               wide_t<T>* inv, T* w,
                                               float pivfloor, int lane) {
#pragma unroll 1
  for (int p = P0; p < P1; ++p) {
    T pp = prow[P0];
#pragma unroll
    for (int c = P0 + 1; c < P1; ++c)
      if (c == p) pp = prow[c];
    const float rpiv =
        sqrtf(max_nan(__shfl_sync(kFull, re(pp), p), pivfloor));
    const wide_t<T> lcol = wide(lane >= p ? div_real(pp, rpiv) : T{});
    col[p * kB + lane] = lcol;
    __syncwarp();
#pragma unroll
    for (int c = P0 + 1; c < kB; ++c)
      if (c > p) {
        wide_t<T> a = {};
        madd_cj(a, lcol, col[p * kB + c]);
        prow[c] = sub(prow[c], rnd(a));
      }
    wide_t<T> acc = {};
#pragma unroll
    for (int s = 0; s < P1 - 1; ++s)
      if (s < p) madd(acc, col[s * kB + p], inv[s * kB + lane]);
    T v = div_real(sub(unit_of(T{}, lane == p), rnd(acc)), rpiv);
    if (lane > p) v = T{};
    inv[p * kB + lane] = wide(v);
    w[p * kB + lane] = v;
    __syncwarp();
  }
}

template <typename T>
__device__ __noinline__ void factor_block(T* dg, wide_t<T>* inv, float* rp,
                                          T* w, float pivfloor, int warp,
                                          int lane) {
  if (warp != 0) return;
  wide_t<T>* const col = reinterpret_cast<wide_t<T>*>(dg);
  T prow[kB];
#pragma unroll
  for (int c = 0; c < kB; ++c) prow[c] = dg[lane * kB + c];
  __syncwarp();
  one_warp_steps<0, 8>(prow, col, inv, w, pivfloor, lane);
  one_warp_steps<8, 16>(prow, col, inv, w, pivfloor, lane);
  one_warp_steps<16, 24>(prow, col, inv, w, pivfloor, lane);
  one_warp_steps<24, 32>(prow, col, inv, w, pivfloor, lane);
}"""
FACTOR = 'template <typename T>\n__device__ __noinline__ void factor_block('
# whole-function replacements: {name: (head, new text)}; their outputs are
# the kernel's and are checked against it
REPLACED = {'factor_unrolled': (FACTOR, FACTOR_UNROLLED),
            'factor_one_warp': (FACTOR, FACTOR_ONE_WARP)}
# each part: the head of the device function whose body is emptied
PARTS = {
    'no_substitutions': ('template <typename T>\n__device__ void '
                         'forward_rhs(',
                         'template <typename T>\n__device__ void '
                         'forward_apply(',
                         'template <typename T>\n__device__ void backward('),
    'no_trailing': ('template <typename T>\n__device__ void trailing(',),
    'no_panel_l21': ('template <typename T>\n__device__ void panel_l21(',),
    'no_factor': (FACTOR,),
}


def function_span(text, head):
    """(start, end) of the function whose definition starts at ``head``
    (braces matched)."""
    start = text.index(head)
    depth = 0
    for i in range(text.index('{', start), len(text)):
        depth += {'{': 1, '}': -1}.get(text[i], 0)
        if depth == 0:
            return start, i + 1
    raise RuntimeError(f'no end of {head!r}')


def emptied(text, head):
    """``text`` with the body of the function starting at ``head``
    emptied."""
    start, end = function_span(text, head)
    return text[:text.index('{', start) + 1] + '}' + text[end:]


def sass_sizes(name):
    """{kernel instantiation: its SASS instruction count} of a built
    variant (cuobjdump beside nvcc)."""
    cuobjdump = Path(_build.find_nvcc()).with_name('cuobjdump')
    sass = subprocess.run(
        [str(cuobjdump), '-sass', str(OUT / f'lib{name}.so')],
        capture_output=True, text=True).stdout
    sizes = {}
    for part in sass.split('Function : ')[1:]:
        kernel = 'complex' if 'float2' in part.split('\n', 1)[0] else 'real'
        sizes[kernel] = sum(1 for line in part.splitlines()
                            if line.strip().startswith('/*') and ';' in line)
    return sizes


def build(parent):
    source = (_build.CSRC_DIR / 'chol_solve.cu').read_text()
    sources = {'kernel': source}
    for name, heads in PARTS.items():
        text = source
        for head in heads:
            text = emptied(text, head)
        sources[name] = text
    for name, pairs in EDITS.items():
        text = source
        for old, new in pairs:
            if text.count(old) != 1:
                raise RuntimeError(f'{old!r}: {text.count(old)} times')
            text = text.replace(old, new)
        sources[name] = text
    for name, (head, new) in REPLACED.items():
        start, end = function_span(source, head)
        sources[name] = source[:start] + new + source[end:]
    if parent:
        sources['parent'] = Path(parent).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f'{name}.cu'
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, '-o',
             str(OUT / f'lib{name}.so'), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libraries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        report = [line.split(':', 1)[-1].strip() for line in log.splitlines()
                  if 'registers' in line or 'spill' in line]
        print(f'{name}: {report}; SASS instructions {sass_sizes(name)}',
              flush=True)
        lib = ctypes.CDLL(str(OUT / f'lib{name}.so'))
        lib.pb_chol_solve.argtypes = chol_solve._REAL_ARGTYPES
        lib.pb_chol_solve.restype = ctypes.c_int
        if name != 'parent':
            lib.pb_hermitian_solve_chol.argtypes = chol_solve._COMPLEX_ARGTYPES
            lib.pb_hermitian_solve_chol.restype = ctypes.c_int
        libraries[name] = lib
    return libraries


def complex_caller(lib, A, B, refine=0):
    F, d, E = B.shape
    work = chol_solve._work(A, d)
    X = torch.empty_like(B)

    def call():
        err = lib.pb_hermitian_solve_chol(
            A.data_ptr(), B.data_ptr(), work.data_ptr(), X.data_ptr(), F, d,
            E, LOAD, refine, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: {err}')
        return X
    return call


def real_caller(lib, A2, B2, work):
    F, S, E = B2.shape
    X2 = torch.empty_like(B2)

    def call():
        err = lib.pb_chol_solve(A2.data_ptr(), B2.data_ptr(), work.data_ptr(),
                                X2.data_ptr(), F, S, E,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: {err}')
        return X2
    return call


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('diag_k5_card: needs a CUDA card')
    libraries = build(args.parent)
    F, D, E = chip_smoke.HEADLINE[0], chip_smoke.WPE_TAPS * \
        chip_smoke.HEADLINE[2], chip_smoke.HEADLINE[2]
    A, B = hpd_system(F, D, E, seed=14, device='cuda')
    _, As, Bs, _ = linalg.equilibrate(A, B, LOAD)
    A2, B2 = chol_solve.real_block_form(As, Bs)
    fns = {name: (complex_caller(lib, A, B), 5)
           for name, lib in libraries.items() if name != 'parent'}
    fns['refine=1'] = (complex_caller(libraries['kernel'], A, B, 1), 3)
    fns['real form (this source)'] = (real_caller(
        libraries['kernel'], A2, B2, chol_solve._work(A2, A2.shape[1])), 3)
    if 'parent' in libraries:
        fns['real form (parent)'] = (real_caller(
            libraries['parent'], A2, B2, torch.empty_like(A2)), 3)
    ref = chol_solve.hermitian_solve_chol_reference(A, B, relative_load=LOAD)
    X = fns['kernel'][0]().clone()
    print(f'kernel vs plain: {frobenius_errors(X, ref):.3e}', flush=True)
    for name in REPLACED:
        print(f'{name} equals the kernel: '
              f'{bool(torch.equal(fns[name][0](), X))}', flush=True)
    times = chip_smoke.in_turns(torch, fns)
    for name, ms in times.items():
        print(f'{name}: {ms:.4f} ms', flush=True)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == '__main__':
    main()
