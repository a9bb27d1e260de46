"""K3 / K4 (``csrc/gj_inverse.cu``: the Gauss-Jordan kernel and the EM
finalize built on it) on the card: variants of its source, and an earlier
source, timed in turns at the headline.

    python scripts_dev/diag_k3_card.py [--parent OLD.cu]

* Variants: the kernel as it is and copies of its source with one design
  choice changed, each a whole function replaced by an edited copy, each
  built by its own nvcc (all started together), its ptxas report
  printed: the pivot column broadcast through a per-warp shared-memory
  slice in place of shuffles (``invert``), two frequencies a CTA of the
  finalize (``pb_em_finalize``, ``opt_in``) and the pivot loops not
  unrolled (``invert``).  None changes the arithmetic: their outputs
  must equal the kernel's bit for bit.
* Timing with CUDA events in turns at F=513, K=5, D=24: the inverse-only
  entry in each floor mode on ``chip_smoke.py``'s HPD batch, and the
  finalize in both floor modes on its EM state, eager and from a CUDA
  graph, beside the plain finalize.  ``--parent`` adds an earlier source
  of ``pb_gj_inverse`` (e.g. the previous kernel, whose
  ``floor_reciprocal`` 1 / 0 is mode 1 / 0 here) to the inverse-only
  turns.
* Probes of the rounding of the plain version's PyTorch operations that
  the kernel mirrors, on random inputs: the trace
  (``torch.diagonal(B).sum(-1)``) against the orders of PyTorch's CUDA
  reduce kernel (w threads, 4 accumulators each, a tree up or down),
  replayed with elementwise adds (the kernel's ``torch_order_sum`` is
  "w32down"); the complex reciprocal (``1.0 / z``) and product against
  candidate formulas compiled by nvcc (the share of bit-equal results of
  each).  ``--probes-only`` stops after them.

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
from pb_chime5_tpu_torch.ops.kernels import _build, gj_inverse  # noqa: E402
from tests.test_torch_kernels_cuda import (  # noqa: E402
    DIAGONAL_FLOOR, em_state, finalize_errors, inverse_errors, random_hpd)

OUT = REPO / 'build' / 'diag_k3'
# the pivot column through a per-warp shared-memory slice in place of
# shuffles (two buffers: one __syncwarp a step)
PUBLISH = """
__device__ __forceinline__ const float2* publish(
    float2* slice, const float2 (&m)[kMaxD], int p, int lane, int D) {
  float2* buf = slice + (p & 1) * kMaxD;
  if (lane == p) {
#pragma unroll
    for (int r = 0; r < kMaxD; ++r) {
      if (r >= D) break;
      buf[r] = m[r];
    }
  }
  __syncwarp();
  return buf;
}

"""
INVERT = 'template <int MODE>\n__device__ __forceinline__ float invert('
OPT_IN = 'template <int MODE>\ncudaError_t opt_in('
FINALIZE = 'int pb_em_finalize('


def function_span(text, head):
    """(start, end) of the C++ function whose definition starts with
    ``head``, found by matching its braces."""
    start = text.index(head)
    depth = 0
    for i in range(text.index('{', start), len(text)):
        depth += {'{': 1, '}': -1}.get(text[i], 0)
        if depth == 0:
            return start, i + 1
    raise RuntimeError(f'no end of {head!r}')


def edited(text, pairs):
    """``text`` with each (old, new, count) replaced, ``count`` times."""
    for old, new, count in pairs:
        if text.count(old) != count:
            raise RuntimeError(f'{old!r}: {text.count(old)} times in the '
                               f'source, expected {count}')
        text = text.replace(old, new)
    return text


def smem_broadcast(invert):
    return PUBLISH + edited(invert, [
        ('float ld = 0.f;',
         'float ld = 0.f;\n  __shared__ float2 columns[kMaxWarps * 2 * kMaxD];'
         '\n  float2* const slice = columns + (threadIdx.x >> 5) * 2 * kMaxD;',
         1),
        ('const float2 mp = pick(m, p, D);',
         'const float2* col_p = publish(slice, m, p, lane, D);\n'
         '      const float2 mp = pick(m, p, D);', 2),
        ('shfl2(mp, p)', 'col_p[p]', 2),
        ('shfl2(m[r], p)', 'col_p[r]', 2)])


def rolled_pivots(invert):
    return edited(invert, [('#pragma unroll\n    for (int p = 0',
                            '#pragma unroll 1\n    for (int p = 0', 1),
                           ('#pragma unroll\n  for (int p = 0',
                            '#pragma unroll 1\n  for (int p = 0', 1)])


# each variant: {function head: its replacement, made from its text}
VARIANTS = {
    'smem_broadcast': {INVERT: smem_broadcast},
    'two_freqs_a_cta': {
        OPT_IN: lambda f: edited(f, [('finalize_smem(kMaxK, kMaxD)',
                                      'finalize_smem(2 * kMaxK, kMaxD)', 1)]),
        FINALIZE: lambda f: edited(f, [
            ('const int warps = K;', 'const int warps = 2 * K;', 1),
            ('finalize_smem(K, D)', 'finalize_smem(2 * K, D)', 1)])},
    'rolled_pivots': {INVERT: rolled_pivots},
}
MODES = {'flushed_log (K4)': 0, 'flt_min (K3)': 1, 'relative': 2}
FINALIZE_MODES = {'flt_min': 1, 'relative': 2}


def build_variants(parent):
    source = (_build.CSRC_DIR / 'gj_inverse.cu').read_text()
    sources = {'kernel': source}
    for name, replacements in VARIANTS.items():
        text = source
        for head, make in replacements.items():
            start, end = function_span(text, head)
            text = text[:start] + make(text[start:end]) + text[end:]
        sources[name] = text
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
        print(f'{name}: {report}', flush=True)
        lib = ctypes.CDLL(str(OUT / f'lib{name}.so'))
        lib.pb_gj_inverse.argtypes = gj_inverse._INVERSE_ARGTYPES
        lib.pb_gj_inverse.restype = ctypes.c_int
        if name != 'parent':
            lib.pb_em_finalize.argtypes = gj_inverse._FINALIZE_ARGTYPES
            lib.pb_em_finalize.restype = ctypes.c_int
        libraries[name] = lib
    return libraries


def inverse_caller(lib, B, mode):
    D = B.shape[-1]
    inv = torch.empty_like(B)
    ld = torch.empty(B.shape[:-2], device=B.device)

    def call():
        err = lib.pb_gj_inverse(B.data_ptr(), inv.data_ptr(), ld.data_ptr(),
                                B.numel() // (D * D), D, mode,
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: {err}')
        return inv, ld
    return call


def finalize_caller(lib, S, den, mode):
    F, K, D, _ = S.shape
    prec = torch.empty_like(S)
    ld = torch.empty_like(den)
    lw = torch.empty_like(den)

    def call():
        err = lib.pb_em_finalize(
            S.data_ptr(), den.data_ptr(), prec.data_ptr(), ld.data_ptr(),
            lw.data_ptr(), F, K, D, mode, DIAGONAL_FLOOR,
            gj_inverse._denom_floor(D),
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: {err}')
        return lw, prec, ld
    return call


PROBE = r"""
#include <cuda_runtime.h>
#include <math.h>
// candidate formulas of PyTorch's complex reciprocal and product
__global__ void probe_kernel(const float2* z, const float2* w, float2* out,
                             int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float a = 1.f, b = 0.f, c = z[i].x, d = z[i].y;
  float2* o = out + i;
  {  // 0: c10::complex operator/= (numpy's scaled division)
    const float ac = fabsf(c), ad = fabsf(d);
    if (ac >= ad) {
      const float rat = d / c, scl = 1.0f / (c + d * rat);
      o[0] = make_float2((a + b * rat) * scl, (b - a * rat) * scl);
    } else {
      const float rat = c / d, scl = 1.0f / (d + c * rat);
      o[0] = make_float2((a * rat + b) * scl, (b * rat - a) * scl);
    }
  }
  {  // 1: the textbook quotient
    const float den = c * c + d * d;
    o[n] = make_float2((a * c + b * d) / den, (b * c - a * d) / den);
  }
  {  // 2: libc++'s quotient, scaled by logb / scalbn
    int ilogbw = 0;
    float cc = c, dd = d;
    const float logbw = logbf(fmaxf(fabsf(cc), fabsf(dd)));
    if (isfinite(logbw)) {
      ilogbw = (int)logbw;
      cc = scalbnf(cc, -ilogbw);
      dd = scalbnf(dd, -ilogbw);
    }
    const float den = cc * cc + dd * dd;
    o[2 * n] = make_float2(scalbnf((a * cc + b * dd) / den, -ilogbw),
                           scalbnf((b * cc - a * dd) / den, -ilogbw));
  }
  {  // 3: the product as c10::complex writes it, nvcc contracting
    const float2 x = z[i], y = w[i];
    o[3 * n] = make_float2(x.x * y.x - x.y * y.y, x.x * y.y + x.y * y.x);
  }
  {  // 4: the product without contraction
    const float2 x = z[i], y = w[i];
    o[4 * n] = make_float2(__fsub_rn(__fmul_rn(x.x, y.x), __fmul_rn(x.y, y.y)),
                           __fadd_rn(__fmul_rn(x.x, y.y), __fmul_rn(x.y, y.x)));
  }
  {  // 5: the product, the first product of each part fused
    const float2 x = z[i], y = w[i];
    o[5 * n] = make_float2(__fmaf_rn(x.x, y.x, -__fmul_rn(x.y, y.y)),
                           __fmaf_rn(x.x, y.y, __fmul_rn(x.y, y.x)));
  }
  {  // 6: the product, the second product of each part fused
    const float2 x = z[i], y = w[i];
    o[6 * n] = make_float2(__fmaf_rn(-x.y, y.y, __fmul_rn(x.x, y.x)),
                           __fmaf_rn(x.y, y.x, __fmul_rn(x.x, y.y)));
  }
  {  // 7: c10's scaled reciprocal with its denominator fused
    const float ac = fabsf(c), ad = fabsf(d);
    if (ac >= ad) {
      const float rat = __fdiv_rn(d, c);
      const float scl = __fdiv_rn(1.0f, __fmaf_rn(d, rat, c));
      o[7 * n] = make_float2(__fmul_rn(__fmaf_rn(b, rat, a), scl),
                             __fmul_rn(__fmaf_rn(-a, rat, b), scl));
    } else {
      const float rat = __fdiv_rn(c, d);
      const float scl = __fdiv_rn(1.0f, __fmaf_rn(c, rat, d));
      o[7 * n] = make_float2(__fmul_rn(__fmaf_rn(a, rat, b), scl),
                             __fmul_rn(__fmaf_rn(b, rat, -a), scl));
    }
  }
}
extern "C" int probe(const void* z, const void* w, void* out, int n,
                     void* stream) {
  probe_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      (const float2*)z, (const float2*)w, (float2*)out, n);
  return (int)cudaGetLastError();
}
"""
PROBE_NAMES = ('reciprocal: c10 scaled', 'reciprocal: textbook',
               'reciprocal: libc++ logb/scalbn', 'product: contracted',
               'product: not contracted', 'product: first fused',
               'product: second fused', 'reciprocal: c10 scaled, fused')


def strided_tree_sum(d, w, down):
    """A reduction order of PyTorch's CUDA reduce kernel, replayed with
    elementwise adds over the last axis of d (N, D): w threads, thread t
    summing elements t, t + w, ... into 4 accumulators (4 at a time, then
    the tail), combined in order, then a tree over the w threads with
    shfl_down offsets 1, 2, ... (``down`` False) or w / 2, ..., 1."""
    D = d.shape[-1]
    zero = torch.zeros_like(d[..., 0])
    lanes = []
    for t in range(w):
        idx = list(range(t, D, w))
        acc = [zero] * 4
        i = 0
        while i + 4 <= len(idx):
            acc = [acc[k] + d[..., idx[i + k]] for k in range(4)]
            i += 4
        for k in range(len(idx) - i):
            acc[k] = acc[k] + d[..., idx[i + k]]
        lanes.append(((acc[0] + acc[1]) + acc[2]) + acc[3])
    offsets = []
    off = 1
    while off < w:
        offsets.append(off)
        off *= 2
    for off in (offsets[::-1] if down else offsets):
        lanes = [lanes[t] + lanes[t + off] if t + off < w else lanes[t]
                 for t in range(w)]
    return lanes[0]


def probes():
    """Share of bit-equal results: the trace orders, the reciprocal and
    product candidates."""
    for D in (1, 2, 3, 4, 5, 8, 9, 16, 17, 24, 31, 32):
        B = random_hpd((513, 5), D, seed=D, device='cuda')
        d = torch.diagonal(B, dim1=-2, dim2=-1)
        got = d.sum(-1).real
        rates = {}
        for w in (1, 2, 4, 8, 16, 32):
            for down in (False, True):
                rates[f'w{w}{"down" if down else "up"}'] = strided_tree_sum(
                    d.real, w, down)
        rates = {k: float((got == v).float().mean()) for k, v in rates.items()}
        best = max(rates.values())
        print(f'probe trace D={D}: bit-equal share per order {rates}; best '
              f'{[k for k, v in rates.items() if v == best]}', flush=True)
    for D in (1, 2, 3, 4, 8, 24):
        B = random_hpd((513, 5), D, seed=D, device='cuda')
        inv, ld = gj_inverse.gauss_jordan_inverse_and_logdet(B)
        inv_ref, ld_ref = gj_inverse.gauss_jordan_inverse_and_logdet_reference(B)
        eq = (torch.view_as_real(inv) == torch.view_as_real(inv_ref)).flatten(-3)
        print(f'probe relative inverse D={D}: matrices bit-equal to plain '
              f'{float(eq.all(-1).float().mean()):.4f}, entries '
              f'{float(eq.float().mean()):.6f}, logdets '
              f'{float((ld == ld_ref).float().mean()):.4f}', flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / 'probe.cu'
    cu.write_text(PROBE)
    subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, '-o',
                    str(OUT / 'libprobe.so'), str(cu)], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(OUT / 'libprobe.so')).probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    gen = torch.Generator(device='cuda').manual_seed(0)
    n = 1 << 20
    # nearly real pivots (Hermitian elimination) and general values
    z = torch.complex(torch.rand(n, device='cuda', generator=gen) + 0.5,
                      1e-4 * torch.randn(n, device='cuda', generator=gen))
    z[n // 2:] = torch.randn(n // 2, dtype=torch.complex64, device='cuda',
                             generator=gen)
    w = torch.randn(n, dtype=torch.complex64, device='cuda', generator=gen)
    out = torch.empty((len(PROBE_NAMES), n), dtype=torch.complex64,
                      device='cuda')
    if fn(z.data_ptr(), w.data_ptr(), out.data_ptr(), n,
          torch.cuda.current_stream().cuda_stream):
        raise RuntimeError('probe launch failed')
    targets = {'reciprocal': 1.0 / z, 'product': z * w}
    for name, row in zip(PROBE_NAMES, out):
        want = targets[name.split(':')[0]]
        eq = (torch.view_as_real(row) == torch.view_as_real(want)).all(-1)
        print(f'probe {name}: bit-equal to torch on {float(eq.float().mean()):.6f} '
              f'(nearly real {float(eq[:n // 2].float().mean()):.6f})',
              flush=True)


def same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent')
    parser.add_argument('--probes-only', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('diag_k3_card: needs a CUDA card')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout,
        flush=True)
    F, _, D, K = chip_smoke.HEADLINE
    hpd = random_hpd((F, K), D, seed=12, device='cuda')
    S, den = em_state(F, K, D, seed=15, device='cuda')
    probes()
    if args.probes_only:
        return
    libraries = build_variants(args.parent)
    refs = {'flushed_log (K4)':
            gj_inverse.hermitian_inverse_and_logdet_reference,
            'flt_min (K3)': gj_inverse.hermitian_inverse_and_logdet_2d_reference,
            'relative': gj_inverse.gauss_jordan_inverse_and_logdet_reference}
    for label, mode in MODES.items():
        calls = {name: inverse_caller(lib, hpd, mode)
                 for name, lib in libraries.items()
                 if name != 'parent' or mode < 2}
        first = calls['kernel']()
        first = tuple(x.clone() for x in first)
        for name, call in calls.items():
            out = call()
            rel, dld, _ = inverse_errors(*out, *refs[label](hpd))
            print(f'inverse {label} {name}: vs plain rel {rel:.3e}, logdet '
                  f'{dld:.3e}; equal to the kernel: {same(out, first)}',
                  flush=True)
        t = chip_smoke.in_turns(torch, {n: (c, 200) for n, c in calls.items()})
        for name, ms in t.items():
            print(f'time inverse {label} {name}: {ms:.4f} ms', flush=True)
        print(f'inverse {label} kernel device time from a CUDA graph: '
              f'{chip_smoke.graph_ms(torch, calls["kernel"], 200):.4f} ms',
              flush=True)
    for label, mode in FINALIZE_MODES.items():
        calls = {name: finalize_caller(lib, S, den, mode)
                 for name, lib in libraries.items() if name != 'parent'}
        first = tuple(x.clone() for x in calls['kernel']())
        ref = gj_inverse.em_finalize_reference(
            S, den, diagonal_floor=DIAGONAL_FLOOR, floor=label)
        for name, call in calls.items():
            out = call()
            print(f'finalize {label} {name}: vs plain (rel, logdet, '
                  f'log_weight) {finalize_errors(out, ref)}; equal to the '
                  f'kernel: {same(out, first)}; bit-equal to plain: '
                  f'{same(out, ref)}', flush=True)
        plain = (lambda: gj_inverse.em_finalize_reference(
            S, den, diagonal_floor=DIAGONAL_FLOOR, floor=label), 5)
        t = chip_smoke.in_turns(torch, {'plain': plain, **{
            n: (c, 200) for n, c in calls.items()}})
        for name, ms in t.items():
            print(f'time finalize {label} {name}: {ms:.4f} ms', flush=True)
        for name, call in calls.items():
            print(f'finalize {label} {name} device time from a CUDA graph: '
                  f'{chip_smoke.graph_ms(torch, call, 200):.4f} ms',
                  flush=True)
        print(f'finalize {label} plain device time from a CUDA graph: '
              f'{chip_smoke.graph_ms(torch, plain[0], 5):.4f} ms', flush=True)


if __name__ == '__main__':
    main()
