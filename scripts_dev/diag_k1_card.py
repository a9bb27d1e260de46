"""K1 (``csrc/fused_em.cu``) on the card: variants of its source timed in
turns at one shape per instantiation, and its rounding on P06's real EM
state against float64.

    python scripts_dev/diag_k1_card.py [--parent OLD.cu]
        [--source NAME=OTHER.cu ...] [--p06]

* Build: the kernel as it is, and copies of its source with one phase
  switched off (E-step, softmax, M-step, the M-step's skip of zero
  coefficients) or one CTA per frequency, each built by its own nvcc (all
  started together); per source and instantiation (MAXD 8, 16, 24) the
  registers and spills that ``ptxas -v`` reports, and the CTAs an SM and
  the clusters on the card that the CUDA occupancy calculator gives (an
  entry appended to each copy, not to the kernel's source).
* Timing: every variant timed with CUDA events in turns on
  ``chip_smoke.py``'s random inputs, at the headline F=513, T=2504, D=24,
  K=5, and at D = 12 and D = 4 with the same F, T and K (one shape per
  instantiation); each phase's marginal time is the kernel's less the
  variant's without it.  A variant without a phase computes garbage; only
  its time is read.  ``--parent`` adds another
  source of the same C entry (e.g. an earlier version of the kernel) to
  the turns, ``--source`` any number more; each is checked against the
  plain version, and compared with the kernel bit for bit.
* ``--p06``: the inputs of the first masked E+M pass of ``chip_smoke.py``'s
  ~40 s utterance (default config); per (f, k) relative Frobenius errors
  of S of the kernel (and of ``--parent``), of the plain version and of
  the plain formula fed the float64 forms rounded once (``exact_q``), each
  against the plain version evaluated in float64 / complex128 on the same
  float32 inputs and against the plain version; the worst (f, k)
  described; every variant timed again on these inputs.

Needs one CUDA card; imports the port only, never JAX.
"""

import argparse
import ctypes
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from pb_chime5_tpu_torch.ops.kernels import _build, fused_em  # noqa: E402
from tests.test_torch_fused_em_cuda import (  # noqa: E402
    random_inputs, scatter_errors)

OUT = REPO / 'build' / 'diag_k1'

SHAPES = (chip_smoke.HEADLINE, (513, 2504, 12, 5), (513, 2504, 4, 5))

# appended to every copy built here: the occupancy of the instantiation
# that serves D, with the launch's dynamic shared memory
OCCUPANCY = r'''
namespace {
template <int MAXD>
int diag_occupancy(int D, int K, int F, int clusters) {
  cudaError_t err = opt_in<MAXD>();
  const size_t smem = sizeof(float) * (size_t)layout(D, K, MAXD).total;
  int n = 0;
  if (err == cudaSuccess && clusters) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(F * kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    err = cudaOccupancyMaxActiveClusters(&n, fused_em_kernel<MAXD>, &cfg);
  } else if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, fused_em_kernel<MAXD>, kThreads, smem);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
}  // namespace

extern "C" int diag_occupancy(int D, int K, int F, int clusters) {
  if (D <= 8) return diag_occupancy<8>(D, K, F, clusters);
  if (D <= 16) return diag_occupancy<16>(D, K, F, clusters);
  return diag_occupancy<24>(D, K, F, clusters);
}
'''

# phase switched off -> (text in csrc/fused_em.cu, replacement)
PATCHES = {
    'no_estep': ('if (kWarpRows * warp < K * D) {', 'if (false) {'),
    'no_softmax': ('if (warp == 0) {   // responsibilities',
                   'if (warp > 99) {'),
    'no_mstep': ('are finite)\n    if (mown) {', 'are finite)\n    if (false) {'),
    'cluster_1': ('constexpr int kCluster = 2;', 'constexpr int kCluster = 1;'),
    'm_noskip': ('if ((mask >> k) & 1u) {', 'if (true) {'),
}


def ptxas_summary(log):
    """'MAXD m: r regs, spill s/l B' per instantiation from ptxas -v."""
    rows, maxd = {}, None
    for line in log.splitlines():
        m = re.search(r"entry function '\S*fused_em_kernelILi(\d+)E", line)
        if m:
            maxd = int(m[1])
            rows[maxd] = {}
            continue
        if maxd is None:
            continue
        m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                      line)
        if m:
            rows[maxd]['spill'] = f'{m[1]}/{m[2]} B'
        m = re.search(r'Used (\d+) registers', line)
        if m:
            rows[maxd]['regs'] = int(m[1])
    return '; '.join(f'MAXD {k}: {v.get("regs")} regs, spill '
                     f'{v.get("spill")}' for k, v in sorted(rows.items()))


def build_variants(parent, extra):
    source = (_build.CSRC_DIR / 'fused_em.cu').read_text()
    sources = {'kernel': source}
    for name, (old, new) in PATCHES.items():
        if old not in source:
            raise RuntimeError(f'{name}: patch target not in the source')
        sources[name] = source.replace(old, new)
    if parent:
        sources['parent'] = Path(parent).read_text()
    for item in extra:
        name, path = item.split('=', 1)
        sources[name] = Path(path).read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        cu = OUT / f'{name}.cu'
        cu.write_text(text + OCCUPANCY)
        procs[name] = subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, '-o',
             str(OUT / f'lib{name}.so'), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f'nvcc failed for {name}:\n{log}')
        print(f'{name} ptxas: {ptxas_summary(log)}', flush=True)
        lib = ctypes.CDLL(str(OUT / f'lib{name}.so'))
        fn = lib.pb_fused_em_scatter
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fn.occupancy = lib.diag_occupancy
        fn.occupancy.argtypes = [ctypes.c_int] * 4
        fn.occupancy.restype = ctypes.c_int
        entries[name] = fn
    return entries


def occupancy(entries, shapes):
    """CTAs an SM, and clusters on the card, of each source at each
    shape (a negative number: the cudaError_t of the query)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name in entries:
        if name in PATCHES:
            continue
        for F, _, D, K in shapes:
            occ = entries[name].occupancy
            ctas, clusters = occ(D, K, F, 0), occ(D, K, F, 1)
            print(f'occupancy {name} D={D} K={K}: {ctas} CTAs an SM; '
                  f'{clusters} clusters of 2 on {sms} SMs', flush=True)


def caller(fn, inputs):
    z, (lw, prec, ld), act, fm = inputs
    F, T, D = z.shape
    K = act.shape[0]
    S = torch.empty((F, K, D, D), dtype=torch.complex64, device=z.device)
    den = torch.empty((F, K), dtype=torch.float32, device=z.device)

    def call():
        err = fn(z.data_ptr(), prec.data_ptr(), lw.data_ptr(), ld.data_ptr(),
                 act.data_ptr(), fm.data_ptr(), S.data_ptr(), den.data_ptr(),
                 F, T, D, K, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f'launch failed: {err}')
        return S, den
    return call


def timings(entries, shape):
    tag = 'F={} T={} D={} K={}'.format(*shape)
    inputs = random_inputs(*shape, seed=5, device='cuda')
    calls = {name: caller(fn, inputs) for name, fn in entries.items()}
    ref = fused_em.fused_em_scatter_reference(*inputs)
    S0, den0 = (x.clone() for x in calls['kernel']())
    for name in calls:
        if name in PATCHES:
            continue
        S, den = (x.clone() for x in calls[name]())
        same = torch.equal(S, S0) and torch.equal(den, den0)
        print(f'{tag} {name} vs plain: rel_S, rel_den, max_abs '
              f'{scatter_errors(S, den, *ref)}; equal to kernel: {same}',
              flush=True)
    del ref
    t = chip_smoke.in_turns(torch, {n: (c, 10) for n, c in calls.items()})
    for name, ms in t.items():
        print(f'{tag} time {name}: {ms:.4f} ms', flush=True)
    for name in PATCHES:
        if name in t and name != 'cluster_1':
            print(f'{tag} kernel - {name}: {t["kernel"] - t[name]:.4f} ms',
                  flush=True)
    t = chip_smoke.graph_ms(torch, calls['kernel'], 10)
    print(f'{tag} kernel device time from a CUDA graph: {t:.4f} ms',
          flush=True)


def scatter_given_q(inputs, q):
    """The plain version's float32 formula from given forms q (F, K, T)
    on: with q the float64 form rounded once, what an exact form gives."""
    z, (lw, _, ld), act, fm = inputs
    tiny = torch.finfo(torch.float32).tiny
    q = q.clamp_min(tiny)
    log_pdf = lw[..., None] - z.shape[-1] * torch.log(q) - ld[..., None]
    log_pdf = log_pdf - log_pdf.amax(dim=1, keepdim=True)
    gamma = torch.exp(log_pdf) * act
    gamma = gamma / gamma.sum(dim=1, keepdim=True).clamp_min(tiny) * fm
    weighted = z[:, None] * (gamma / q)[..., None]
    return weighted.transpose(-2, -1) @ z.conj()[:, None], gamma.sum(dim=-1)


def p06(entries):
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    with tempfile.TemporaryDirectory(dir=REPO / 'build') as work:
        db = chip_smoke.make_corpus(Path(work))
        enhancer = get_enhancer(multiarray=True, database_path=str(db),
                                device='cuda')
        inputs = chip_smoke.capture_k1_inputs(
            enhancer, max(enhancer.get_iterator('S02'),
                          key=chip_smoke.observation_seconds))
    z, (lw, prec, ld), act, fm = inputs
    wide = (z.to(torch.complex128), (lw.double(), prec.to(torch.complex128),
                                     ld.double()), act.double(), fm.double())
    S64, den64 = fused_em.fused_em_scatter_reference(*wide)
    results = {'plain': fused_em.fused_em_scatter_reference(*inputs),
               'exact_q': scatter_given_q(
                   inputs, fused_em.quadratic_form(
                       z.to(torch.complex128),
                       prec.to(torch.complex128)).float())}
    for name in ('kernel', 'parent'):
        if name in entries:
            S, den = caller(entries[name], inputs)()
            results[name] = (S.clone(), den.clone())
    torch.cuda.synchronize()
    for name, (S, den) in results.items():
        rel = (torch.linalg.matrix_norm(S.to(torch.complex128) - S64)
               / torch.linalg.matrix_norm(S64).clamp_min(1e-300))
        rel_den = ((den.double() - den64).abs()
                   / den64.abs().clamp_min(1e-300))
        f, k = divmod(int(rel.argmax()), rel.shape[1])
        print(f'{name} vs float64: rel_S max {float(rel.max()):.3e} at '
              f'(f={f}, k={k}), median {float(rel.median()):.3e}, '
              f'99th pct {float(rel.flatten().quantile(0.99)):.3e}; '
              f'rel_den max {float(rel_den.max()):.3e}', flush=True)
        if name == 'plain':
            worst = (f, k)
    t = chip_smoke.in_turns(torch, {n: (caller(fn, inputs), 10)
                                    for n, fn in entries.items()})
    for name, ms in t.items():
        print(f'P06 time {name}: {ms:.4f} ms', flush=True)
    for a, b in (('kernel', 'plain'), ('parent', 'plain'),
                 ('exact_q', 'plain')):
        if a in results:
            print(f'{a} vs {b}: rel_S, rel_den, max_abs '
                  f'{scatter_errors(*results[a], *results[b])}', flush=True)
    f, k = worst
    q64 = fused_em.quadratic_form(z[f:f + 1].to(torch.complex128),
                                  prec[f:f + 1].to(torch.complex128))[0, k]
    ew = torch.linalg.eigvalsh(prec[f, k].to(torch.complex128))
    print(f'plain worst (f={f}, k={k}): den {float(den64[f, k]):.4e}, '
          f'active frames {int(((act[k] > 0) & (fm > 0)).sum())}, '
          f'precision eigenvalues {float(ew[0]):.3e} .. {float(ew[-1]):.3e}, '
          f'q on valid frames min {float(q64[fm > 0].min()):.3e}, median '
          f'{float(q64[fm > 0].median()):.3e}', flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent')
    parser.add_argument('--source', action='append', default=[],
                        metavar='NAME=PATH')
    parser.add_argument('--p06', action='store_true')
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('diag_k1_card: needs a CUDA card')
    print(chip_smoke.subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout,
        flush=True)
    entries = build_variants(args.parent, args.source)
    occupancy(entries, SHAPES)
    for shape in SHAPES:
        timings(entries, shape)
    if args.p06:
        p06(entries)


if __name__ == '__main__':
    main()
