"""K2 (``csrc/wpe_stats.cu``) on the card: its issued work, and variants of
its source timed in turns at the headline shape.

    python scripts_dev/diag_k2_card.py [--parent OLD.cu]

* Issued work: the kernel's tiling replayed in Python (its tasks, the
  needed 4 x 8 tiles of each, whole warps) and the chunks it computes on
  ``chip_smoke.py``'s headline inputs (a chunk whose weighted rows of the
  task's row block are all zero is skipped), against the needed entries
  (R's lower triangle and P) over all frames and over the valid ones.
* Timing: the kernel as it is and copies of its source with one part
  switched off (the FFMAs, the cp.async staging, the weighting, the skip
  of zero chunks), each built by its own nvcc (all started together),
  its ptxas report printed, and timed with CUDA events in turns at F=513,
  dim=240, D=24, T=2504 and T=4191.  A variant without a part computes
  garbage; only its time is read.  Two variants compute the same sums:
  ``shared_flush`` keeps the float64 sums of the two-level T sum in shared
  memory (64 KB a CTA, a thread's 64 doubles strided by the CTA's
  threads) instead of registers, and ``shared_flush_4`` does so with
  launch bounds of 4 CTAs an SM (at most 128 registers); their R and P
  must be bit-identical to the kernel's.  Each variant's ptxas report and
  resident CTAs an SM are printed.  ``--parent`` adds another source of
  the same C entry (e.g. an earlier version of the kernel) to the turns.

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
from pb_chime5_tpu_torch.ops.kernels import _build, wpe_stats  # noqa: E402
from tests.test_torch_kernels_cuda import (  # noqa: E402
    stats_errors, wpe_inputs)

OUT = REPO / 'build' / 'diag_k2'
QUADS, BLOCK, FIRST_P, CHUNK = 16, 64, 24, 16   # as in csrc/wpe_stats.cu

# part switched off -> (text in csrc/wpe_stats.cu, replacement)
NO_SKIP = ('if (!__syncthreads_or(nonzero)) continue;',
           'if (!__syncthreads_or(1)) continue;')
PATCHES = {
    'no_fma': [('    if (computes) {', '    if (false) {')],
    'no_staging': [('cp_async8(dst + 16 * m',
                    'if (false) cp_async8(dst + 16 * m'), NO_SKIP],
    'no_weighting': [('    if (weights) {', '    if (false) {'), NO_SKIP],
    'no_skip': [NO_SKIP],
    'shared_flush': [
        ('(int)sizeof(float) * (2 * kRawFloats + kAFloats + 2 * kChunk);',
         '(int)sizeof(float) * (2 * kRawFloats + kAFloats + 2 * kChunk) +\n'
         '    64 * kThreads * (int)sizeof(double);'),
        ('  float* sRaw = reinterpret_cast<float*>(smem4);',
         '  double* sSum = reinterpret_cast<double*>(smem4) + threadIdx.x;\n'
         '  float* sRaw = reinterpret_cast<float*>(smem4) + 2 * 64 * kThreads;'),
        ('  double sre[4][8], sim[4][8];   // the spans\' float64 sums\n', ''),
        ('      sre[i][j] = sim[i][j] = 0.0;',
         '      sSum[(16 * i + 2 * j) * kThreads] = 0.0;\n'
         '      sSum[(16 * i + 2 * j + 1) * kThreads] = 0.0;'),
        ('        sre[i][j] += re[i][j];\n        sim[i][j] += im[i][j];',
         '        sSum[(16 * i + 2 * j) * kThreads] += re[i][j];\n'
         '        sSum[(16 * i + 2 * j + 1) * kThreads] += im[i][j];'),
        ('make_float2((float)sre[i][j], (float)sim[i][j]);',
         'make_float2((float)sSum[(16 * i + 2 * j) * kThreads],\n'
         '                                   (float)sSum[(16 * i + 2 * j + 1) * kThreads]);'),
    ],
}
PATCHES['shared_flush_4'] = PATCHES['shared_flush'] + [
    ('constexpr int kMinBlocks = 2;', 'constexpr int kMinBlocks = 4;')]
EXACT = ('shared_flush', 'shared_flush_4')   # the kernel's sums, bit for bit


def tasks(dim, D):
    """(I, rows of block I, kind, quad pairs of the other block) per task,
    in the kernel's order; kind 0: R block (I, J < I), 1: R's diagonal
    block and P's first columns, 2: a further block of P's columns."""
    nI = -(-dim // BLOCK)
    nP = -(-(D - FIRST_P) // BLOCK) if D > FIRST_P else 0
    out = []
    for I in range(nI):
        rows0 = min(BLOCK, dim - BLOCK * I)
        for J in range(I + 1):
            out.append((I, rows0, int(J == I),
                        QUADS // 2 if J < I else -(-min(FIRST_P, D) // 8)))
    for I in range(nI):
        for J in range(nP):
            rows = min(BLOCK, D - FIRST_P - BLOCK * J)
            out.append((I, min(BLOCK, dim - BLOCK * I), 2, -(-rows // 8)))
    return out


def lane_slots(rows0, kind, np1):
    """The task's working lanes in whole warps: its needed 4 x 8 tiles
    (a row quad by a quad pair; on the diagonal, the pairs whose first
    quad is not above the row quad)."""
    nq0 = -(-rows0 // 4)
    n = nq0 * np1 + (sum(i // 2 + 1 for i in range(nq0)) if kind == 1
                     else 0)
    return -(-n // 32) * 32


def issued_flops(Yt, Y, w):
    """(issued flops, lanes a frequency): 8 flops for each of a lane's 32
    entries and each frame of every chunk that its task computes."""
    F, dim, T = Yt.shape
    nchunks = -(-T // CHUNK)
    nonzero = torch.nn.functional.pad((Yt * w[:, None, :]) != 0,
                                      (0, nchunks * CHUNK - T))
    nonzero = nonzero.reshape(F, dim, nchunks, CHUNK).any(-1)
    total, lanes_f = 0, 0
    for I, rows0, kind, np1 in tasks(dim, Y.shape[1]):
        lanes = lane_slots(rows0, kind, np1)
        lanes_f += lanes
        computed = int(nonzero[:, BLOCK * I:BLOCK * I + rows0].any(1).sum())
        total += 8 * 32 * lanes * CHUNK * computed
    return total, lanes_f


def build_variants(parent):
    source = (_build.CSRC_DIR / 'wpe_stats.cu').read_text()
    sources = {'kernel': source}
    for name, patches in PATCHES.items():
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f'{name}: patch target not in the source')
            text = text.replace(old, new)
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
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        report = [line.split(':', 1)[-1].strip() for line in log.splitlines()
                  if 'registers' in line or 'spill' in line]
        lib = ctypes.CDLL(str(OUT / f'lib{name}.so'))
        smem, ctas = ctypes.c_int(), ctypes.c_int()
        if hasattr(lib, 'pb_wpe_statistics_resources'):
            lib.pb_wpe_statistics_resources(ctypes.byref(smem),
                                            ctypes.byref(ctas))
            report.append(f'{smem.value} B shared, {ctas.value} CTAs an SM')
        print(f'{name}: {report}', flush=True)
        fn = lib.pb_wpe_statistics
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def caller(fn, Yt, Y, w):
    F, dim, T = Yt.shape
    D = Y.shape[1]
    R = torch.empty((F, dim, dim), dtype=torch.complex64, device=Yt.device)
    P = torch.empty((F, dim, D), dtype=torch.complex64, device=Yt.device)

    def call():
        err = fn(Yt.data_ptr(), Y.data_ptr(), w.data_ptr(), R.data_ptr(),
                 P.data_ptr(), F, dim, D, T,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: {err}')
        return R, P
    return call


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('diag_k2_card: needs a CUDA card')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout,
        flush=True)
    F, T, D, _ = chip_smoke.HEADLINE
    entries_fn = build_variants(args.parent)
    Yt, Y, w, valid = wpe_inputs(F, D, T, taps=chip_smoke.WPE_TAPS, seed=11,
                                 device='cuda')
    dim = Yt.shape[1]
    flops, lanes = issued_flops(Yt, Y, w)
    entries = dim * (dim + 1) // 2 + dim * D
    needed_all = 8.0 * F * T * entries
    needed_valid = 8.0 * F * valid * entries
    print(f'issued: {lanes} lanes a frequency = {32 * lanes} entries a frame '
          f'against {entries} needed ({32 * lanes / entries:.4f}x); '
          f'{flops / 1e9:.2f} GFLOP against {needed_all / 1e9:.2f} (all '
          f'frames, {flops / needed_all:.4f}x) and {needed_valid / 1e9:.2f} '
          f'(valid frames, {flops / needed_valid:.4f}x)', flush=True)
    for frames in (T, 4191):
        if frames != T:
            del Yt, Y, w
            Yt, Y, w, _ = wpe_inputs(F, D, frames, taps=chip_smoke.WPE_TAPS,
                                     seed=11, device='cuda')
        calls = {name: caller(fn, Yt, Y, w)
                 for name, fn in entries_fn.items()}
        ref = wpe_stats.wpe_statistics_reference(Yt, Y, w)
        outputs = {}
        for name in ('kernel', *EXACT, 'parent'):
            if name in calls:
                outputs[name] = [x.clone() for x in calls[name]()]
                print(f'T = {frames}: {name} vs plain: rel_R, rel_P, max_abs '
                      f'{stats_errors(*outputs[name], *ref)}', flush=True)
        del ref
        for name in EXACT:
            same = all(torch.equal(a, b) for a, b in
                       zip(outputs[name], outputs['kernel']))
            print(f'T = {frames}: {name} bit-identical to the kernel: '
                  f'{same}', flush=True)
            if not same:
                sys.exit(f'diag_k2_card: {name} differs from the kernel')
        del outputs
        t = chip_smoke.in_turns(torch, {n: (c, 3) for n, c in calls.items()})
        for name, ms in t.items():
            rate = (f' ({flops / ms / 1e9:.2f} TFLOP/s issued)'
                    if name == 'kernel' and frames == T else '')
            print(f'T = {frames}: time {name}: {ms:.4f} ms{rate}', flush=True)
        if frames == T:
            ms = chip_smoke.graph_ms(torch, calls['kernel'], 3)
            print(f'kernel device time from a CUDA graph: {ms:.4f} ms',
                  flush=True)
        del calls


if __name__ == '__main__':
    main()
