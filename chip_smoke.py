#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``pb_chime5_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases (the first failure ends the run with a non-zero exit code):

1. device: a CUDA card is required; the TF32 pins are asserted;
2. build: the four kernel libraries (``csrc/fused_em.cu``,
   ``csrc/wpe_stats.cu``, ``csrc/gj_inverse.cu``, ``csrc/chol_solve.cu``)
   are compiled by concurrent nvcc processes, beside the two host
   libraries (``csrc/wav_ops.cpp``, ``csrc/interval_ops.cpp``) by the host
   compiler; each kernel's registers and
   spills are printed, and K2's dynamic shared memory and CTAs per SM;
3. kernels vs plain, at the shapes of the headline utterance, each timed
   with CUDA events in turns (plain, kernel, library call, and back)
   beside its bound (the larger of its bytes over 3.35 TB/s and its
   operations over the 67 TFLOP/s fp32 rate, H100 SXM data sheet; K1's
   counts the forms of every class, the S update of the active ones):
   K1 the fused E+M kernel (F=513, T=2504, D=24, K=5), K2 the WPE
   statistics (F=513, dim=240, D=24, T=2504) and its device time from a
   CUDA graph, K3 / K4 the Gauss-Jordan
   kernel's inverse-only entries (K3's and K4's floors and the relative
   floor of the default EM inverse and the MVDR solve) on the EM's
   (513, 5, 24, 24) batch and its whole-finalize entry ``em_finalize`` in
   both floor modes on the EM's accumulated S and den, eager and from a
   CUDA graph, beside the plain finalize, K5 the
   blocked Cholesky solve on 513 WPE-sized systems (240 x 240 complex,
   24 right-hand sides): its complex instantiation
   ``hermitian_solve_chol`` (the WPE solve, from the raw system, with and
   without ``refine``, and its relative-floor pin) and its real one on
   the 512 x 512 real block (``hermitian_solve_pallas``,
   ``chol_solve_real_spd``, the FLT_MIN pin), timed in turns beside the
   plain version, ``cholesky_ex`` + ``cholesky_solve`` on the
   equilibrated system, the port's cuSOLVER ``hermitian_solve`` and the
   real-form wrapper, and their device times from CUDA graphs;
4. default path: a synthetic 6-array x 4-mic PCM16 CHiME-5 session -> DB
   JSON -> the port's CLI ``test_run`` (2 utterances, default
   ``GssConfig``, K = 5 with the garbage class, the session-audio cache
   on: both utterances must be served from its window, as its stats line
   shows) on the card; the fused
   kernel must carry every E+M pass and ``em_finalize`` every finalize
   (20 each per utterance), the Gauss-Jordan kernel the MVDR solve (1),
   ``hermitian_solve_chol`` every WPE solve (3), K2 every WPE iteration's
   statistics (3) ("20 / 20 / 1 / 3 / 3" below);
   the WAVs must be
   finite, non-silent and of the utterance's length; per-stage and
   per-utterance times; on a small two-speaker scene the card must agree
   with the CPU path and separate the speakers, and the pipeline's
   on-device output trim must equal the host slice;
5. all-Pallas path: the session ``Enhancer`` with ``GssConfig(
   bss_em_backend='pallas', bss_inverse='pallas_gj', wpe_stats_backend=
   'pallas')`` on the ~40 s utterance, warm: 20 K1, 20 ``em_finalize``
   (K3's floor), 3 K2 launches, 3 WPE solves and the MVDR solve's 1, a
   finite non-silent
   WAV of the utterance's length, its stage
   times beside the default path's; the small scene card vs CPU again;
6. P06's EM state and WPE systems: K1's inputs at the first masked E+M
   pass of the ~40 s utterance (default config), captured by a one-shot
   wrapper: the share of active (frame, class) pairs, S and den vs plain
   at the headline tolerances (both versions' S vs float64 printed) and
   their times; ``em_finalize`` in both floor modes on K1's S and den of
   that pass against the plain finalize (precision, logdet, log_weight,
   a float64 residual; empty classes bit for bit) and its times; the
   relative-mode inverse on the input that the MVDR solve of that
   utterance gives it (captured as K1's, 513 equilibrated, loaded noise
   covariances of 24 x 24) against its plain version (inverse, logdet and
   a float64 residual at the EM-like batch's gates) and its times; the
   first WPE iteration's R and P of the ~40 s utterance
   by K2 and by its plain version (R and P <= 1e-5 per frequency, both
   timed in turns), solved by both K5 instantiations, their plain
   versions and the port's ``hermitian_solve`` (cuSOLVER); per-frequency
   residuals of the loaded, equilibrated system in float64 and the
   pairwise differences of G; each instantiation's largest residual must
   be <= 2x its plain version's + 1e-6;
7. options path: the session ``Enhancer`` on P06, warm, once for each of
   ``bf='gev_ban'``, ``bf='lcmv'``, the WPE options (``psd_context=1,
   chunk_size=512, solve_refine=1``), ``bss_inverse='cholesky'`` and
   ``'eigh'``: 20 K1 launches, 3 WPE solves, 3 K2 launches where the
   option has no ``chunk_size``, 20 ``em_finalize`` where the
   option keeps
   the Gauss-Jordan EM inverse, the MVDR solve's 1 where it beamforms with
   MVDR, and no other kernel, a finite non-silent WAV
   of the utterance's length, wall and stage times; on the small scene
   at a 10-iteration EM each option (and ``ch2`` / ``sum``) card vs CPU,
   with the SIR gate for the separating beamformers, GEV without BAN and
   GEV + BAN with WPE printed beside them (not gated), and ``'schur'`` on
   the CPU alone;
8. session path: ``bench.py``'s session (S02, 420 s, 25 utterances a
   speaker, 6 arrays x 4 mics, PCM16, seed 3) through ``enhance_session``
   at the default config, a warm-up pass, then the session-audio cache on,
   off, off, on: each pass's wall, utterances a second, xRT over emitted
   and processed seconds, the chains' stage windows and the share of the
   wall outside them, the cache's stats line, the bytes read and uploaded
   each way, peak device memory; gated: 20 / 20 / 1 / 3 / 3 launches an
   utterance and nothing else, every cached WAV byte-identical to its
   direct twin, ``hits > 0``, ``refills >= 2``, ``prefetch_hits >= 1``,
   ``prefetch_wasted == 0``, ``direct == 0``; once more with a 60 s window
   (a refill every few utterances, dispatches of the old window still
   queued): byte-identical again; one refill's parts timed (host read,
   ``pin_memory``, the copy, the cache's upload);
9. quality: ``tests/test_realistic_scene.py``'s realistic scenes (seeds
   0-4, made in parallel processes) through ``gss_enhance`` on the card,
   postfilter None and 'mask_mul': at a 10-iteration EM gated on that
   test's pins as medians over seeds 0-2 (SIR gain bf > 1.5 dB, mask_mul
   > 10 dB; overlap STOI > 0.5; mask_mul - raw > 0.02; mask_mul - bf over
   the span > -0.05), the per-seed values and the 5-seed medians printed;
   the default 20 + 1 EM printed beside them;
10. the CHiME-6 entry points: a synthetic 120 s S02 session (6 arrays x 4
   mics, PCM16, 12 utterances) made into a CHiME-6 tree by the port's
   ``simulate_chime6_transcriptions``, its JSON by ``create_json
   --chime6``, an RTTM of its annotations (as ci.sh makes it).  Track 1:
   ``kaldi_run main with chime6=True multiarray`` (default config, D = 24)
   as one job with the session-audio cache on, then off, then as 3 jobs;
   gated: 20 / 20 / 1 / 3 / 3 launches an utterance and nothing else, 12
   finite, non-silent WAVs of their utterances' length, ``hits > 0`` and
   ``direct == 0``, the uncached and the 3 jobs' WAVs byte-identical to
   the single cached job's.  Track 2: ``kaldi_run_rttm main`` at the
   factory defaults (``outer_array_mics``: D = 12, float64 eager reads):
   the same launch and WAV gates (``_U06.-`` ids); K1's S and den at the
   first masked pass of its first utterance vs plain (phase 6's gates,
   both timed), ``em_finalize`` on them, the MVDR solve's input (513 x
   12 x 12) by the relative-mode inverse vs plain (phase 6's gates), the
   first WPE iteration's R and P (d = 120, E = 12) solved by K5 and its
   plain version (float64 residuals).  The first utterance of each track at a 2-iteration EM,
   card vs the port's CPU path (<= 1e-2 of the peak).  Printed: each
   pass's wall, utterances a second, xRT over emitted and processed
   seconds, bytes read and uploaded, peak device memory;
11. the per-frequency ('xla') EM, float64 and the debug twin: P06 through
   ``GssConfig(bss_em_backend='xla')`` (float32, default config; gated:
   K1 0, ``em_finalize`` 0, the relative inverse 21 (20 M-steps + the
   MVDR solve), K5 3, K2 3; wall and stages beside the default config's); on
   P06's WPE output the EMs alone, each timed with its peak memory and
   launches: K1's, the 'xla' one, the chunked one (``em_chunk_size=256``:
   the relative inverse 1, ``em_finalize`` 19), both 'xla' ones in
   float64 (no launch); the chunked posteriors against the unfused ones in
   float64 (<= 1e-6), the 'xla' masks against K1's at 2 + 0 (<= 3e-2,
   PARITY.md's stress leg); the complex128 WPE solve at d = 240 (K5's
   plain version, the floored panels) timed beside ``cholesky_ex`` +
   ``cholesky_solve`` and ``linalg.hermitian_solve``, residuals against
   cuSOLVER's; ``get_enhancer(compute_dtype=np.float64)`` on P06 (no
   kernel launch, wall, stages, float64 vs float32 printed) and the small
   scene card vs CPU in float64 at the default EM (<= 1e-6 of the peak);
   one ``enhance_session`` of phase 8's session in float64 with the cache
   on (wall, utterances a second, xRT, bytes, peak; no launch); phase 9's
   scenes in float64 at 10 and 20 + 1 iterations (finite; medians beside
   the float32 ones, not gated); ``Enhancer.debug_example`` on P06 (shapes
   (20, 513, 5), weights summing to 1 within 1e-5, condition >= 0.99,
   entropy in [0, log K], masks within 1e-6 of the 'xla' chain's); the
   energy masks (share of entries card != CPU <= 1e-3) and the from-mask
   beamformers and the two unsupervised MVDR wrappers card vs CPU on the
   small scene's STFT (<= 1e-4 of the peak in complex128, and for GEV and
   LCMV, which compute in float64, in complex64 too; complex64 MVDR
   <= 1e-2, the float32 chain gate);
12. the parallel session paths: phase 8's session (its first 60
   utterances, a depth cut) through
   ``enhance_session(mesh=make_mesh(1, 1), utterances_per_device=B)``,
   B = 1 and 4, in turns with the serial loop (serial, 1, 4, 4, 1,
   serial): each pass's wall, utterances a second, xRT, peak memory and
   launches a batch (gated: 20 / 20 / 1 / 3 / 3 a batch, nothing else); B = 1
   WAVs byte-identical to the serial ones, B = 4 within 1e-2 of the peak
   (the largest deviation printed); K1's batched entry on the first
   B = 4 batch's first masked pass against its plain version (the
   headline gates), timed beside its bound; 8 utterances' dispatches,
   their audio read beforehand, serial and at B = 4 under
   ``torch.profiler`` (device busy share, host waits, the device's idle
   time, the part of it before the first kernel, and the host ops that
   ran in it); 4
   utterances over ``make_mesh(1, 2, [cuda:0, cuda:0])`` against
   ``make_mesh(1, 1)`` (<= 1e-3 of the peak); on phase 4's corpus,
   ``testing/mp_worker.py`` (default config, cuda:0) as one serial
   worker, two ``PB_JOB_ID`` jobs and two gloo processes (unions
   byte-identical to the serial run, each job its
   ``length_balanced_shard`` share, the master's run id on both ranks);
   a fresh process's first utterance with and without
   ``Enhancer.warmup`` (no build and no library load after it, the kernel
   and host libraries all loaded by it); P06 with
   ``compile_mode='fast_start'`` bit-equal to the fused chain;
13. the alignment-refined activity, the session soak, the dry run and the
   tooling: (a) a fake Kaldi alignment of phase 8's worn utterances (sil
   over the first and last 10 % of each one's 10 ms frames) through
   ``activity_alignment.main`` on a stub ``KALDI_ROOT``
   (``testing/fake_kaldi.py``), then phase 8's first 20 utterances (a
   depth cut) through ``enhance_session`` at the default config with
   ``activity_type='path'`` on the annotation pickles, on the refined
   pickles, and ``'annotation'`` (gated: 20 / 20 / 1 / 3 / 3 launches an
   utterance, the annotation pickles' WAVs byte-identical to
   ``'annotation'``'s, every refined WAV finite, non-silent and other
   than its annotation twin, one refined utterance card vs CPU at a
   2-iteration EM and one WPE iteration within 1e-2 of the peak;
   printed: walls, utterances a
   second, xRT, the pickles' sizes and load and write times); (b)
   ``testing/soak.py``'s ``run_session_soak`` at its defaults (1 array x
   4 mics, no WPE, a 2 + 1 EM, a 45 s window), serial over 1,000
   utterances and on ``make_mesh(1, 1)`` over 400, with
   tests/test_session_soak.py's gates (windowed flatness, RSS growth after
   the first window, the cache's refills and hits, every WAV written),
   K1 2, ``em_finalize`` 2 and the MVDR inverse 1 an utterance, and the
   card's allocated memory after the first window grown by at most two
   of the cache's windows (printed: the windowed means, the RSS and
   device-memory curves); (c) ``dryrun.dryrun_multichip`` over 4 and 8
   slots of cuda:0 (its cached leg bit-equal to its direct leg; the
   launches of its legs, data groups and frequency shards, K2 once each
   for its one WPE iteration); (d) phase
   8's first 2 utterances under ``utils.profiling.trace`` (the trace file
   must name K1's kernel 20 times an utterance), and the FLOP model's
   achieved TFLOP/s and MFU against 67 TFLOP/s over P06's stage windows
   (whole chain, WPE, EM) and over phase 8's cached median wall and stage
   windows (printed, not gated);
14. the float32 WPE statistics at a production length: the stress scene
   of ``tests/test_torch_stress_headline.py`` (seed 0, 67 s, D = 24,
   T = 4191) through the STFT and the float32 WPE on the card, once by
   the tile route (``wpe_stats_backend='xla'``: 256-frame complex64 tiles
   added into complex128) and once by K2 (the default ``GssConfig()``,
   its 64-frame float32 spans added in float64), each counted from 0 (3
   ``hermitian_solve_chol`` launches, and 3 K2 launches on K2's run);
   gated on each: the output finite at all 513 frequencies, the second
   iteration's R and P within 1.2e-6 of float64 sums of the same inputs
   (relative Frobenius per frequency, R hermitized), its equilibrated
   smallest eigenvalue plus the 1e-4 load positive at every frequency,
   and K2 within 1e-5 of its plain version; printed: the WPE window and
   the statistics call at T = 4191, and P06's WPE windows of phase 5;
15. the native host readers: both host libraries compiled anew from the
   port's sources (seconds each); every utterance's observation span of
   phase 8's session (each array's files over the utterance with its
   context) read by the native reader and by the Python one (gated: the
   same dtype, shape and bytes), then timed in turns (native, Python,
   Python, native: ms an utterance, MB/s); the session's activity
   ``ArrayInterval``s (the annotations, and boolean spans with sil over
   each utterance's first and last tenth), each utterance's slices of
   them and their pickles, built with the native interval ops and with
   the Python ones (gated: equal), in turns, each op's calls and µs a
   call printed.

Before each path's run every kernel's launch count is set to 0, and it is
read right after.  It imports the port (``pb_chime5_tpu_torch``) and the
kernel tests' input makers, never JAX or the JAX package
``pb_chime5_tpu``, and checks that nothing it ran imported either.

The last three lines of standard output are the card's name and power
limit, the kernels' JSON record and ``{"ok": true, "device": {...}}``;
the line before them is phase 15's record of the host libraries
(``{"host_libraries": [...]}``: they are not TPU kernels).
The record has one row per TPU kernel, with its launches on each path
(``launches_per_path``: default, all-Pallas, CHiME-6 tracks 1 and 2, the
'xla' EM, float64, the mesh, the alignment-refined activity, the serial
soak, the dry runs, the stress scene's WPE by each route);
K3's and K4's rows list the
Gauss-Jordan kernel's other entries under ``entries``; K5's row is its
entry at the WPE solve (``hermitian_solve_chol``), with the TPU kernel's
own function (``chol_solve_real_spd``) and its real-form wrapper under
``entries``.
"""

import ast
import contextlib
import dataclasses
import io
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
HEADLINE = (513, 2504, 24, 5)          # F, T, D, K
WPE_TAPS = 10
S_RTOL = 1e-4        # K1: relative Frobenius error of S per (f, k)
DEN_RTOL = 1e-5      # K1: relative error of den per (f, k)
STATS_RTOL = 1e-5    # K2: relative Frobenius error of R and P per frequency
INV_RTOL = 1e-5      # K3/K4 on HPD input: relative Frobenius of the inverse
LOGDET_ATOL = 1e-4   # K3/K4 on HPD input: absolute logdet error
EM_INV_RTOL = 1e-5   # K3/K4 on the EM-like batch, against the plain version
EM_LOGDET_ATOL = 1e-3
LOG_WEIGHT_ATOL = 1e-6  # em_finalize's log-weights against the plain finalize
SOLVE_RTOL = 1e-5    # K5 vs its plain version: relative Frobenius per freq.
SOLVE_F64_RTOL = 1e-4  # K5 vs a float64 solve of the same loaded system
WPE_LOAD = 1e-4      # the WPE filter solve's relative diagonal load
STRESS_RTOL = 1.2e-6  # stress scene: R, P vs float64 sums of the same inputs
SCENE_ATOL = 1e-2    # card vs CPU waveform, fraction of the peak
EM_PASSES = 20       # fused E+M passes (and finalizes) per utterance at 20 + 1
MVDR_SOLVES = 1      # complex64 Gauss-Jordan solves per utterance (MVDR)
WPE_ITERATIONS = 3
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12       # H100 SXM data sheet, CUDA cores
LIBRARIES = ('fused_em', 'wpe_stats', 'gj_inverse', 'chol_solve')
HOST_LIBRARIES = ('wav_ops', 'interval_ops')


START = time.perf_counter()


def phase(title):
    print(f'== {title} [{time.perf_counter() - START:.1f} s]', flush=True)


def imported_jax():
    return any(name.split('.')[0] in ('jax', 'pb_chime5_tpu')
               for name in sys.modules)


def check(ok, message):
    if not ok:
        raise RuntimeError(f'chip_smoke: {message}')


def cuda_ms(torch, fn, reps):
    """ms per call of ``fn`` on the card: median over 5 windows of
    ``reps`` back-to-back calls, each window between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(torch, fn, reps):
    """Device ms per call of ``fn``, replayed from a CUDA graph of ``reps``
    calls: no host launch overhead."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                   # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay, 1) / reps


def in_turns(torch, fns, rounds=2):
    """{name: (fn, reps)} -> {name: ms}, timed in turns: the names in
    order and back again (plain, kernel, library, library, kernel, plain),
    ``rounds`` times; the median of each name's windows."""
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in list(fns) + list(fns)[::-1]:
            fn, reps = fns[name]
            times[name].append(cuda_ms(torch, fn, reps))
    return {name: statistics.median(v) for name, v in times.items()}


def bound(nbytes, flops):
    """(bound_ms, bound_by): the least time for ``nbytes`` moved once and
    ``flops`` fp32 operations on the H100."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def print_times(name, t, bound_ms, bound_by):
    lib = ('none' if t.get('library') is None
           else f'{t["library"]:.4f} ms')
    print(f'{name} time: kernel {t["kernel"]:.4f} ms, plain '
          f'{t["plain"]:.4f} ms, library {lib}, bound {bound_ms:.4f} ms '
          f'({bound_by})', flush=True)


def k1_vs_plain(torch, fused_em):
    """K1: correctness at the headline shape (random HPD precisions and
    the EM's identity first pass), then the times."""
    from tests.test_torch_fused_em_cuda import random_inputs, scatter_errors
    worst_abs = 0.0
    timed = None
    for identity in (False, True):
        inputs = random_inputs(*HEADLINE, seed=5, identity=identity,
                               device='cuda')
        before = fused_em.fused_em_scatter.launches
        S, den = fused_em.fused_em_scatter(*inputs)
        torch.cuda.synchronize()
        check(fused_em.fused_em_scatter.launches == before + 1,
              'the kernel wrapper did not count its launch')
        S_ref, den_ref = fused_em.fused_em_scatter_reference(*inputs)
        rel_S, rel_den, max_abs = scatter_errors(S, den, S_ref, den_ref)
        print(f'fused_em identity={identity}: rel_S {rel_S:.3e} '
              f'(<= {S_RTOL}), rel_den {rel_den:.3e} (<= {DEN_RTOL}), '
              f'max_abs {max_abs:.3e}', flush=True)
        check(bool(torch.isfinite(S).all() and torch.isfinite(den).all()),
              'kernel output is not finite')
        check(rel_S <= S_RTOL and rel_den <= DEN_RTOL,
              'kernel disagrees with its plain version')
        worst_abs = max(worst_abs, max_abs)
        if not identity:
            timed = inputs
        del S, den, S_ref, den_ref
    t = in_turns(torch, {
        'plain': (lambda: fused_em.fused_em_scatter_reference(*timed), 2),
        'kernel': (lambda: fused_em.fused_em_scatter(*timed), 10)})
    bound_ms, bound_by = k1_bound(*timed)
    print_times(f'fused_em at F,T,D,K={HEADLINE}', t, bound_ms, bound_by)
    return dict(max_abs_err=worst_abs, ms=t['kernel'], plain_ms=t['plain'],
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def k1_bound(z, params, act, fm):
    """K1's bound on these inputs, using the Hermitian structure: per
    valid frame the lower triangle of z z^H (3 D^2 flops) and the form
    Re tr(P_k z z^H) for EVERY class (2 D^2 each: the log-pdf is shifted
    by its max over all K before the activity gate, so no class's form can
    be skipped); the update of S_k's lower triangle (2 D^2) only for the
    active (frame, class) pairs.  Every input read once (P in full: both
    triangles enter), S and den written once.  A batch (act (B, K, T), fm
    (B, T)) counts each utterance's frames on its F / B rows."""
    F, T, D = z.shape
    K = act.shape[-2]
    valid = fm > 0
    rows = F // (act.shape[0] if act.dim() == 3 else 1)
    n_valid = int(valid.sum())
    pairs = int(((act > 0) & valid[..., None, :]).sum())
    flops = rows * (n_valid * (3 + 2 * K) * D * D + pairs * 2 * D * D)
    out_bytes = F * K * D * D * 8 + F * K * 4
    return bound(nbytes(z, *params, act, fm) + out_bytes, flops)


def k2_vs_plain(torch, wpe_stats):
    """K2 at the headline: WPE's first-iteration statistics of a seeded
    signal with a near-silent stretch and a masked tail."""
    from tests.test_torch_kernels_cuda import stats_errors, wpe_inputs
    F, T, D, _ = HEADLINE
    Yt, Y, w, valid = wpe_inputs(F, D, T, taps=WPE_TAPS, seed=11,
                                 device='cuda')
    before = wpe_stats.wpe_statistics.launches
    R, P = wpe_stats.wpe_statistics(Yt, Y, w)
    torch.cuda.synchronize()
    check(wpe_stats.wpe_statistics.launches == before + 1,
          'the statistics wrapper did not count its launch')
    R_ref, P_ref = wpe_stats.wpe_statistics_reference(Yt, Y, w)
    rel_R, rel_P, max_abs = stats_errors(R, P, R_ref, P_ref)
    print(f'wpe_statistics: rel_R {rel_R:.3e}, rel_P {rel_P:.3e} '
          f'(<= {STATS_RTOL}), max_abs {max_abs:.3e}', flush=True)
    check(bool(torch.isfinite(R).all() and torch.isfinite(P).all()),
          'statistics kernel output is not finite')
    check(rel_R <= STATS_RTOL and rel_P <= STATS_RTOL,
          'statistics kernel disagrees with its plain version')
    del R, P, R_ref, P_ref
    # the library call: the complex matmul pair on the weighted copy,
    # which is made once outside the timing
    weighted = Yt * w[:, None, :].to(Yt.dtype)
    t = in_turns(torch, {
        'plain': (lambda: wpe_stats.wpe_statistics_reference(Yt, Y, w), 2),
        'kernel': (lambda: wpe_stats.wpe_statistics(Yt, Y, w), 3),
        'library': (lambda: (weighted @ Yt.conj().transpose(-2, -1),
                             weighted @ Y.conj().transpose(-2, -1)), 3)})
    dim = Yt.shape[1]
    # the lower triangle of R and P over the valid frames
    flops = 8.0 * F * valid * (dim * (dim + 1) // 2 + dim * D)
    out_bytes = F * dim * (dim + D) * 8
    bound_ms, bound_by = bound(nbytes(Yt, Y, w) + out_bytes, flops)
    print_times(f'wpe_statistics at F,dim,D,T=({F}, {dim}, {D}, {T})', t,
                bound_ms, bound_by)
    device_ms = graph_ms(
        torch, lambda: wpe_stats.wpe_statistics(Yt, Y, w), 3)
    print(f'wpe_statistics device time from a CUDA graph: kernel '
          f'{device_ms:.4f} ms', flush=True)
    return dict(max_abs_err=max_abs, ms=t['kernel'], plain_ms=t['plain'],
                library_ms=t['library'], bound_ms=bound_ms,
                bound_by=bound_by)


def gj_vs_plain(torch, gj_inverse):
    """The Gauss-Jordan kernel's inverse-only entries (K3's floor, K4's
    and the relative floor) on the EM's batch: (a) well-conditioned HPD
    matrices, against the plain version; (b) EM-like rank-deficient
    covariances with the 1e-6 jitter, against the plain version, and a
    residual against float64 no worse than the plain version's (see
    tests/test_torch_kernels_cuda.py); then the times.  Then
    ``em_finalize`` (:func:`finalize_vs_plain`)."""
    from tests.test_torch_kernels_cuda import (
        GJ_MODES, against_float64, em_like_batch, inverse_errors,
        random_hpd)
    F, _, D, K = HEADLINE
    hpd = random_hpd((F, K), D, seed=12, device='cuda')
    em = em_like_batch(F, K, D, seed=13, device='cuda')
    out = {}
    for name, (kernel, reference) in GJ_MODES.items():
        before = kernel.launches
        inv, ld = kernel(hpd)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1,
              f'{kernel.__name__} did not count its launch')
        rel, dld, max_abs = inverse_errors(inv, ld, *reference(hpd))
        print(f'{kernel.__name__} (a) HPD: rel_inv {rel:.3e} '
              f'(<= {INV_RTOL}), logdet {dld:.3e} (<= {LOGDET_ATOL}), '
              f'max_abs {max_abs:.3e}', flush=True)
        check(bool(torch.isfinite(inv).all() and torch.isfinite(ld).all()),
              f'{kernel.__name__} output is not finite')
        check(rel <= INV_RTOL and dld <= LOGDET_ATOL,
              f'{kernel.__name__} disagrees with its plain version')
        inv, ld = kernel(em)
        inv_ref, ld_ref = reference(em)
        rel, dld, em_abs = inverse_errors(inv, ld, inv_ref, ld_ref)
        res, dld64 = against_float64(em, inv, ld)
        res_ref, dld64_ref = against_float64(em, inv_ref, ld_ref)
        print(f'{kernel.__name__} (b) EM-like vs plain: rel_inv {rel:.3e} '
              f'(<= {EM_INV_RTOL}), logdet {dld:.3e} (<= {EM_LOGDET_ATOL}); '
              f'vs float64: residual {res:.3e} (plain {res_ref:.3e}), '
              f'logdet {dld64:.3e} (plain {dld64_ref:.3e})', flush=True)
        check(bool(torch.isfinite(inv).all() and torch.isfinite(ld).all()),
              f'{kernel.__name__} output is not finite on the EM batch')
        check(rel <= EM_INV_RTOL and dld <= EM_LOGDET_ATOL,
              f'{kernel.__name__} disagrees with its plain version on the '
              f'EM batch')
        check(res <= 2 * res_ref + 1e-6,
              f'{kernel.__name__} has a larger residual than its plain '
              f'version on the EM batch')
        max_abs = max(max_abs, em_abs)
        out[kernel.__name__] = dict(
            max_abs_err=max_abs,
            **inverse_times(torch, kernel, reference, hpd, 'HPD'))
    out.update(finalize_vs_plain(torch, gj_inverse))
    return out


def inverse_times(torch, kernel, reference, B, label):
    """An inverse-only entry of the Gauss-Jordan kernel on ``B``: eager
    times in turns (plain, kernel, ``inv_ex``) beside the bound, and
    device times from CUDA graphs, printed."""
    t = in_turns(torch, {
        'plain': (lambda: reference(B), 5),
        'kernel': (lambda: kernel(B), 200),
        'library': (lambda: torch.linalg.inv_ex(B), 20)})
    # the input's lower triangle read, the inverse and logdet written; a
    # Hermitian inverse needs ~4 D^3 flops (Cholesky-based: D^3 / 2
    # complex multiply-adds; Gauss-Jordan issues 8 D^3)
    D = B.shape[-1]
    N = B.numel() // (D * D)
    bound_ms, bound_by = bound(
        N * D * (D + 1) // 2 * 8 + nbytes(B) + N * 4, 4.0 * N * D ** 3)
    print_times(f'{kernel.__name__} on {label} at {tuple(B.shape)}', t,
                bound_ms, bound_by)
    # the eager times above include the host's launches (the plain
    # version issues ~15 a pivot step); the device's share alone:
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(200):
        kernel(B)
    host_us = (time.perf_counter() - start) / 200 * 1e6
    torch.cuda.synchronize()
    print(f'{kernel.__name__} on {label}: device time from a CUDA graph: '
          f'kernel {graph_ms(torch, lambda: kernel(B), 200):.4f} ms, plain '
          f'{graph_ms(torch, lambda: reference(B), 5):.4f} ms; host time '
          f'per kernel call {host_us:.1f} us', flush=True)
    return dict(ms=t['kernel'], plain_ms=t['plain'], library_ms=t['library'],
                bound_ms=bound_ms, bound_by=bound_by)


def check_finalize(torch, gj_inverse, S, den, floor, label):
    """``em_finalize`` against the plain finalize on the same S and den:
    precision, logdet and log_weight at their gates, a float64 residual
    no worse than the plain version's, empty classes (den = 0, S = 0) bit
    for bit; returns the largest absolute error."""
    from tests.test_torch_kernels_cuda import (
        DIAGONAL_FLOOR, against_float64, finalize_errors,
        finalized_covariances)
    before = gj_inverse.em_finalize.launches
    out = gj_inverse.em_finalize(S, den, diagonal_floor=DIAGONAL_FLOOR,
                                 floor=floor)
    torch.cuda.synchronize()
    check(gj_inverse.em_finalize.launches == before + 1,
          'em_finalize did not count its launch')
    ref = gj_inverse.em_finalize_reference(
        S, den, diagonal_floor=DIAGONAL_FLOOR, floor=floor)
    rel, dld, dlw = finalize_errors(out, ref)
    B = finalized_covariances(S, den)
    res, _ = against_float64(B, out[1], out[2])
    res_ref, _ = against_float64(B, ref[1], ref[2])
    empty = (den == 0) & (S.abs().amax(dim=(-2, -1)) == 0)
    bit = all(torch.equal(a, b) for a, b in zip(out, ref))
    print(f'em_finalize {floor} on {label}: rel_precision {rel:.3e} '
          f'(<= {EM_INV_RTOL}), logdet {dld:.3e} (<= {EM_LOGDET_ATOL}), '
          f'log_weight {dlw:.3e} (<= {LOG_WEIGHT_ATOL}); vs float64: '
          f'residual {res:.3e} (plain {res_ref:.3e}); bit-equal to plain: '
          f'{bit}; {int(empty.sum())} empty classes', flush=True)
    check(all(bool(torch.isfinite(x).all()) for x in out),
          f'em_finalize output is not finite on {label}')
    check(rel <= EM_INV_RTOL and dld <= EM_LOGDET_ATOL
          and dlw <= LOG_WEIGHT_ATOL,
          f'em_finalize disagrees with the plain finalize on {label}')
    check(res <= 2 * res_ref + 1e-6,
          f'em_finalize has a larger residual than the plain finalize on '
          f'{label}')
    check(all(torch.equal(a[empty], b[empty]) for a, b in zip(out, ref)),
          f'em_finalize differs from the plain finalize on an empty class '
          f'({label})')
    return max(float((a - b).abs().max()) for a, b in zip(out, ref))


def finalize_times(torch, gj_inverse, S, den, floor, label):
    """Eager times in turns (plain finalize, kernel) and device times from
    CUDA graphs, printed; the bound: S read and the precision written
    once, den read and logdet and log_weight written once, and the
    inverse's 8 D^3 flops a matrix."""
    from tests.test_torch_kernels_cuda import DIAGONAL_FLOOR
    kw = dict(diagonal_floor=DIAGONAL_FLOOR, floor=floor)
    t = in_turns(torch, {
        'plain': (lambda: gj_inverse.em_finalize_reference(S, den, **kw), 5),
        'kernel': (lambda: gj_inverse.em_finalize(S, den, **kw), 200)})
    F, K, D, _ = S.shape
    bound_ms, bound_by = bound(2 * nbytes(S) + 3 * nbytes(den),
                               8.0 * F * K * D ** 3)
    device = graph_ms(torch, lambda: gj_inverse.em_finalize(S, den, **kw),
                      200)
    device_plain = graph_ms(
        torch, lambda: gj_inverse.em_finalize_reference(S, den, **kw), 5)
    print_times(f'em_finalize {floor} {label} at ({F}, {K}, {D}, {D})', t,
                bound_ms, bound_by)
    print(f'em_finalize {floor} {label}: device time from a CUDA graph: '
          f'kernel {device:.4f} ms, plain {device_plain:.4f} ms', flush=True)
    return dict(ms=t['kernel'], plain_ms=t['plain'], library_ms=None,
                bound_ms=bound_ms, bound_by=bound_by, device_ms=device,
                plain_device_ms=device_plain)


def finalize_vs_plain(torch, gj_inverse):
    """``em_finalize`` at the headline, both floor modes, on the EM's
    accumulated state (``em_state``: rank-deficient scatter, an empty
    class, a tiny den, a silent frequency): the gates of
    :func:`check_finalize`, then the times."""
    from tests.test_torch_kernels_cuda import em_state
    F, _, D, K = HEADLINE
    S, den = em_state(F, K, D, seed=15, device='cuda')
    out = {}
    for floor in ('relative', 'flt_min'):
        max_abs = check_finalize(torch, gj_inverse, S, den, floor,
                                 'the synthetic EM state')
        t = finalize_times(torch, gj_inverse, S, den, floor,
                           'on the synthetic EM state')
        out[f'em_finalize_{floor}'] = dict(max_abs_err=max_abs, **t)
    return out


def k5_vs_plain(torch, chol_solve):
    """K5 at the WPE headline: 513 well-conditioned HPD systems of
    240 x 240 with 24 right-hand sides.  The complex instantiation
    ``hermitian_solve_chol`` (the WPE solve of every path) against its
    plain version and a float64 solve of the same loaded system, with and
    without ``refine``, and its relative-floor pin; the real
    instantiation through ``hermitian_solve_pallas`` likewise, and its
    FLT_MIN pin.  Then the times in turns: the complex entry beside its
    plain version, cuSOLVER's ``cholesky_ex`` + ``cholesky_solve`` on the
    equilibrated system, the port's ``linalg.hermitian_solve`` and the
    real-form wrapper ``hermitian_solve_pallas`` (each from the raw
    system); ``chol_solve_real_spd`` on the real block form beside its
    plain version; device times from CUDA graphs."""
    from pb_chime5_tpu_torch.ops import linalg
    from tests.test_torch_kernels_cuda import (
        frobenius_errors, hpd_system, solve_error_f64)
    F, D, E = HEADLINE[0], WPE_TAPS * HEADLINE[2], HEADLINE[2]
    A, B = hpd_system(F, D, E, seed=14, device='cuda')
    max_abs = {}
    for name, reference, kw in (
            ('hermitian_solve_chol', 'hermitian_solve_chol_reference',
             dict(refine=0)),
            ('hermitian_solve_chol', 'hermitian_solve_chol_reference',
             dict(refine=1)),
            ('hermitian_solve_pallas', 'hermitian_solve_pallas_reference',
             {})):
        entry = getattr(chol_solve, name)
        before = entry.launches
        X = entry(A, B, relative_load=WPE_LOAD, **kw)
        torch.cuda.synchronize()
        check(entry.launches == before + 1, f'{name} did not count its launch')
        check(bool(torch.isfinite(X).all()), f'{name}: output is not finite')
        ref = getattr(chol_solve, reference)(A, B, relative_load=WPE_LOAD,
                                             **kw)
        rel = frobenius_errors(X, ref)
        X64 = linalg.hermitian_solve(
            A.to(torch.complex128), B.to(torch.complex128),
            relative_load=WPE_LOAD, **kw)
        rel64 = frobenius_errors(X.to(torch.complex128), X64)
        rel64_ref = frobenius_errors(ref.to(torch.complex128), X64)
        max_abs.setdefault(name, float((X - ref).abs().max()))
        print(f'{name} {kw}: vs plain {rel:.3e} (<= {SOLVE_RTOL}), vs '
              f'float64 {rel64:.3e} (<= {SOLVE_F64_RTOL}; plain '
              f'{rel64_ref:.3e}), max_abs {float((X - ref).abs().max()):.3e}'
              f', bit-equal to plain: {bool(torch.equal(X, ref))}',
              flush=True)
        check(rel <= SOLVE_RTOL, f'{name} disagrees with its plain version')
        check(rel64 <= SOLVE_F64_RTOL,
              f'{name} disagrees with a float64 solve')
        del X, ref, X64
    # the two floors on a zero pivot: FLT_MIN (real), eps^2 max(diag) with
    # the padding's ones counted (complex; row 3 scaled by 1 / sqrt(eps))
    pin = torch.eye(64, device='cuda')[None].contiguous()
    pin[0, 5, 5] = 0
    rhs = torch.zeros((1, 64, 3), device='cuda')
    rhs[0, 5, 0] = 1
    x_pin = float(chol_solve.chol_solve_real_spd(pin, rhs)[0, 5, 0])
    eps = torch.finfo(torch.float32).eps
    cpin = torch.eye(40, dtype=torch.complex64, device='cuda')[None]
    cpin[0, 3, 3] = 0
    crhs = torch.zeros((1, 40, 1), dtype=torch.complex64, device='cuda')
    crhs[0, 3, 0] = 1e-20
    c_pin = float(chol_solve.hermitian_solve_chol(
        cpin.contiguous(), crhs, relative_load=0)[0, 3, 0].real)
    print(f'zero pivot: real X[5, 0] = {x_pin:.7e} (1 / FLT_MIN = '
          f'{1 / torch.finfo(torch.float32).tiny:.7e}); complex X[3, 0] = '
          f'{c_pin:.7e} (1e-20 / eps^3 = {1e-20 / eps ** 3:.7e})', flush=True)
    check(x_pin == 1 / torch.finfo(torch.float32).tiny,
          'K5 does not floor a zero pivot at FLT_MIN')
    check(abs(c_pin / (1e-20 / eps ** 3) - 1) <= 1e-5,
          'hermitian_solve_chol does not floor a zero pivot at '
          'eps^2 max(diag)')
    _, As, Bs, _ = linalg.equilibrate(A, B, WPE_LOAD)

    def library():
        L, _ = torch.linalg.cholesky_ex(As)
        return torch.cholesky_solve(Bs, L)
    # the complex Hermitian Cholesky (4 D^3 / 3) and two substitutions
    # (8 D^2 E); R's lower triangle, P and G moved once
    flops = F * (4 * D ** 3 / 3 + 8 * D * D * E)
    t_bytes = F * (D * (D + 1) // 2 + 2 * D * E) * 8 / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = bound(F * (D * (D + 1) // 2 + 2 * D * E) * 8, flops)
    print(f'K5 bound at F, d, E = ({F}, {D}, {E}): {flops / 1e9:.2f} GFLOP '
          f'over 67 TFLOP/s = {flops / FP32_FLOP_PER_S * 1e3:.4f} ms; R\'s '
          f'lower triangle, P and G over 3.35 TB/s = {t_bytes:.4f} ms: '
          f'{bound_by} bind', flush=True)
    t = in_turns(torch, {
        'plain': (lambda: chol_solve.hermitian_solve_chol_reference(
            A, B, relative_load=WPE_LOAD), 1),
        'kernel': (lambda: chol_solve.hermitian_solve_chol(
            A, B, relative_load=WPE_LOAD), 5),
        'library': (library, 3),
        'hermitian_solve': (lambda: linalg.hermitian_solve(
            A, B, relative_load=WPE_LOAD), 3),
        'hermitian_solve_pallas': (lambda: chol_solve.hermitian_solve_pallas(
            A, B, relative_load=WPE_LOAD), 3)})
    print_times(f'hermitian_solve_chol at F,d,E=({F}, {D}, {E}), raw R, P '
                f'-> G (library: cholesky_ex + cholesky_solve on the '
                f'equilibrated system)', t, bound_ms, bound_by)
    print(f'WPE solve slot, A, B -> X: hermitian_solve_chol '
          f'{t["kernel"]:.4f} ms, hermitian_solve (cuSOLVER) '
          f'{t["hermitian_solve"]:.4f} ms, hermitian_solve_pallas (real '
          f'block form) {t["hermitian_solve_pallas"]:.4f} ms', flush=True)
    A2, B2 = chol_solve.real_block_form(As, Bs)
    t_real = in_turns(torch, {
        'plain': (lambda: chol_solve.chol_solve_real_spd_reference(A2, B2),
                  1),
        'kernel': (lambda: chol_solve.chol_solve_real_spd(A2, B2), 5),
        'library': (library, 3)})
    print_times(f'chol_solve_real_spd at F,S,E=({F}, {A2.shape[1]}, {E}) '
                f'(complex D={D})', t_real, bound_ms, bound_by)
    # device time alone (hermitian_solve syncs on its factorization's
    # status, so it has no graph)
    device = {name: graph_ms(torch, fn, 5) for name, fn in (
        ('hermitian_solve_chol', lambda: chol_solve.hermitian_solve_chol(
            A, B, relative_load=WPE_LOAD)),
        ('chol_solve_real_spd',
         lambda: chol_solve.chol_solve_real_spd(A2, B2)),
        ('hermitian_solve_pallas', lambda: chol_solve.hermitian_solve_pallas(
            A, B, relative_load=WPE_LOAD)))}
    print('K5 device time from a CUDA graph: ' + ', '.join(
        f'{name} {ms:.4f} ms' for name, ms in device.items()), flush=True)
    numbers = dict(bound_ms=bound_ms, bound_by=bound_by)
    return {
        'hermitian_solve_chol': dict(
            max_abs_err=max_abs['hermitian_solve_chol'], ms=t['kernel'],
            plain_ms=t['plain'], library_ms=t['library'],
            device_ms=device['hermitian_solve_chol'], **numbers),
        'chol_solve_real_spd': dict(
            max_abs_err=max_abs['hermitian_solve_pallas'],
            ms=t_real['kernel'], plain_ms=t_real['plain'],
            library_ms=t_real['library'],
            device_ms=device['chol_solve_real_spd'], **numbers),
        'hermitian_solve_pallas': dict(
            max_abs_err=max_abs['hermitian_solve_pallas'],
            ms=t['hermitian_solve_pallas'], plain_ms=None,
            library_ms=t['hermitian_solve'],
            device_ms=device['hermitian_solve_pallas'], **numbers)}


def make_corpus(root):
    """Synthetic S02 session: 6 arrays x 4 mics, 4 speakers, PCM16, 64 s
    (the second utterance's +-15 s context gives ~40 s of observation)."""
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    from pb_chime5_tpu_torch.testing import create_synthetic_chime5
    create_synthetic_chime5(
        root / 'CHiME5', session_ids=('S02',), duration_seconds=64.0,
        utterances_per_speaker=1, num_arrays=6, num_array_mics=4, seed=0,
        pcm16=True)
    dump_json(create_database(root / 'CHiME5'), root / 'chime5.json')
    return root / 'chime5.json'


def small_scene(seconds=3.0, D=4, seed=0):
    """Two modulated noise sources, random FIR mixing, sensor noise;
    activity (3, N): speaker 0 alone before b1, speaker 1 alone after b0,
    always-on noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    N = int(seconds * 16000)
    env = rng.uniform(0.3, 1.0, N // 800 + 1).repeat(800)[:N]
    s0 = np.convolve(rng.standard_normal(N) * env, [1.0, 0.8, 0.4], 'same')
    s1 = np.convolve(rng.standard_normal(N) * env[::-1], [1.0, -0.8, 0.4],
                     'same')
    b0, b1 = int(0.55 * N), int(0.45 * N)
    s0[b0:] = 0
    s1[:b1] = 0
    h0, h1 = rng.standard_normal((D, 5)), rng.standard_normal((D, 5))
    obs = np.stack([np.convolve(s0, h0[d], 'same')
                    + np.convolve(s1, h1[d], 'same') for d in range(D)])
    obs += 0.02 * rng.standard_normal((D, N))
    activity = np.zeros((3, N), bool)
    activity[0, :b0] = activity[1, b1:] = activity[2] = True
    return obs.astype(np.float32), activity, (b0, b1)


def card_vs_cpu(torch, cfg, label, separates=True, gated=True,
                dtype='float32', atol=SCENE_ATOL):
    """The whole chain on a small scene in ``dtype``, on the card and on
    the CPU path (the kernels' plain versions): waveforms within ``atol``
    of the peak, and, where the beamformer ``separates``, the target-only
    vs interferer-only energy ratio raised by > 30x (the bound
    tests/test_gss_pipeline.py holds the JAX chain to).  Not ``gated``:
    both printed, only a finite output required."""
    import numpy as np
    from pb_chime5_tpu_torch.models.gss import gss_enhance
    from pb_chime5_tpu_torch.utils import activity_time_to_frequency
    obs, activity, (b0, b1) = small_scene()
    obs = obs.astype(dtype)
    act = activity_time_to_frequency(activity, cfg.stft_size, cfg.stft_shift,
                                     stft_fading=True, stft_pad=True)
    outs = {}
    for dev in ('cuda', 'cpu'):
        x, _ = gss_enhance(torch.from_numpy(obs).to(dev),
                           torch.from_numpy(act).to(dev), 0, config=cfg)
        outs[dev] = x.cpu().numpy()
    err = float(np.abs(outs['cuda'] - outs['cpu']).max()
                / np.abs(outs['cpu']).max())
    x = outs['cuda']
    gain = sir_gain(obs, x, b0, b1)
    separates = separates and gated
    print(f'small scene, {label}: card vs CPU {err:.3e} of the peak '
          f'{f"(<= {atol})" if gated else "(not gated)"}; SIR gain '
          f'{gain:.1f}x{" (> 30)" if separates else " (not gated)"}',
          flush=True)
    check(np.isfinite(x).all() and (err <= atol or not gated),
          f'card and CPU paths disagree on the small scene ({label})')
    check(gain > 30 or not separates,
          f'the chain does not separate the small scene ({label})')
    return obs, act


def sir_gain(obs, x, b0, b1):
    """Target-only over interferer-only energy, output over input."""
    def energy(sig, lo, hi):
        return float((sig[..., lo:hi] ** 2).mean())
    return (energy(x, 0, b1) / max(energy(x, b0, x.shape[-1]), 1e-12)) / (
        energy(obs[0], 0, b1) / energy(obs[0], b0, obs.shape[-1]))


def pipeline_trim(torch, cfg, obs, act):
    """Asynchronous pipeline on the card: bucket padding, int16 upload,
    the trim sliced on the device equals the host slice bit for bit."""
    import numpy as np
    from pb_chime5_tpu_torch.models.gss import GssPipeline
    pcm = np.clip(obs / np.abs(obs).max() * 2 ** 14, -2 ** 15,
                  2 ** 15 - 1).astype(np.int16)
    trims = {}
    for device_trim in (True, False):
        pipe = GssPipeline(cfg, length_buckets=(64000,),
                           device_trim=device_trim, device='cuda')
        trims[device_trim] = pipe.gather(pipe.dispatch(
            pcm, act, 1, start_context_frames=5, end_context_frames=4,
            trim=(4000, 30000)))
    print(f'small scene pipeline: device trim == host slice: '
          f'{np.array_equal(trims[True], trims[False])}', flush=True)
    check(trims[True].shape == (30000,)
          and np.array_equal(trims[True], trims[False]),
          'the device trim differs from the host slice')


def check_wav(ex, x):
    import numpy as np
    expected = ex['num_samples_orig']['observation'][ex['reference_array']]
    print(f'{ex["example_id"]}: {len(x)} samples, peak '
          f'{np.abs(x).max():.3f}', flush=True)
    check(len(x) == expected,
          f'{ex["example_id"]}: {len(x)} samples, expected {expected}')
    check(np.isfinite(x).all() and np.abs(x).max() > 0,
          f'{ex["example_id"]} is not finite and non-silent')


def observation_seconds(ex):
    ra = ex['reference_array']
    return (ex['end']['observation'][ra]
            - ex['start']['observation'][ra]) / 16000


def stage_times(gss, enhancer, ex):
    with gss.record_stage_times() as times:
        enhancer.enhance_example(ex)
    (ms,) = times
    return {**{f'{k}_ms': round(v, 3) for k, v in ms.items()},
            'total_ms': round(sum(ms.values()), 3)}


def default_path(torch, counts, work):
    """Phase 4: the port's CLI on the synthetic session at the default
    config; returns the kernel launch counts of that run, the enhancer
    and its examples."""
    from pb_chime5_tpu_torch.io import load_audio
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.models.gss import GssConfig
    from pb_chime5_tpu_torch.scripts.run import make_experiment

    start = time.perf_counter()
    db = make_corpus(work)
    print(f'corpus + DB JSON: {time.perf_counter() - start:.2f} s',
          flush=True)
    exp = make_experiment(default_storage=work / 'runs')
    argv = ['test_run', 'with', 'multiarray', 'session_id=S02',
            f'database_path={db}', 'device=cuda']

    counts.reset()
    tee = Tee(sys.stdout)
    start = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        exp.run_commandline(argv)
    cli_s = time.perf_counter() - start
    launches = counts.read()
    print(f'default path launches: {launches}', flush=True)

    wavs = sorted((exp.run_dir / 'audio' / 'dev').glob('*.wav'))
    check(len(wavs) == 2, f'expected 2 WAVs, got {wavs}')
    stats = cache_stats_line(tee.text.getvalue())
    check(stats['hits'] + stats['refills'] == len(wavs)
          and stats['direct'] == 0 and stats['prefetch_wasted'] == 0,
          f'the CLI did not serve every utterance from the session-audio '
          f'cache: {stats}')
    expected = expected_launches(launches, len(wavs))
    check(launches == expected,
          f'default path launches {launches}, expected {expected} '
          f'({EM_PASSES} fused E+M passes and finalizes, {MVDR_SOLVES} '
          f'MVDR solve, {WPE_ITERATIONS} WPE statistics and solves per '
          f'utterance)')
    check(not imported_jax(), 'the port imported jax or the JAX package')

    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            device='cuda')
    it = enhancer.get_iterator('S02')
    examples = [it[wav.stem] for wav in wavs]
    emitted = 0.0
    for ex, wav in zip(examples, wavs):
        x = load_audio(wav)
        emitted += len(x) / 16000
        check_wav(ex, x)
    print(f'CLI test_run (cold, incl. DB load and WAV writes): '
          f'{cli_s:.3f} s for {emitted:.3f} s emitted, '
          f'xRT {emitted / cli_s:.3f}', flush=True)

    for ex in examples:                   # warm, one utterance at a time
        torch.cuda.synchronize()
        start = time.perf_counter()
        x = enhancer.enhance_example(ex)
        wall = time.perf_counter() - start
        obs_s = observation_seconds(ex)
        print(f'utterance {ex["example_id"]}: wall {wall:.4f} s, '
              f'observation {obs_s:.3f} s, emitted {len(x) / 16000:.3f} s, '
              f'xRT emitted {len(x) / 16000 / wall:.3f}, '
              f'xRT observation {obs_s / wall:.3f}', flush=True)
    for ex in examples:                   # the same calls, stage by stage
        print('stages', json.dumps({'utterance': ex['example_id'],
                                    **stage_times(gss, enhancer, ex)}),
              flush=True)
    print(f'peak device memory: '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB',
          flush=True)
    cfg = GssConfig(bss_iterations=10)
    pipeline_trim(torch, cfg, *card_vs_cpu(torch, cfg, 'default'))
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return launches, enhancer, examples


def all_pallas_path(torch, counts, enhancer, examples):
    """Phase 5: the all-Pallas configuration through the session
    ``Enhancer`` on the longest utterance, warm; returns its launch
    counts."""
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.gss import GssConfig
    all_pallas = dict(bss_em_backend='pallas', bss_inverse='pallas_gj',
                      wpe_stats_backend='pallas')
    pallas_enhancer = dataclasses.replace(
        enhancer, gss_config=GssConfig(**all_pallas))
    ex = max(examples, key=observation_seconds)
    pallas_enhancer.enhance_example(ex)   # warm-up
    torch.cuda.synchronize()

    counts.reset()
    start = time.perf_counter()
    x = pallas_enhancer.enhance_example(ex)
    wall = time.perf_counter() - start
    launches = counts.read()
    print(f'all-Pallas path launches: {launches}', flush=True)
    expected = {**dict.fromkeys(launches, 0),
                'fused_em_scatter': EM_PASSES,
                'em_finalize': EM_PASSES,
                'gauss_jordan_inverse_and_logdet': MVDR_SOLVES,
                'wpe_statistics': WPE_ITERATIONS,
                'hermitian_solve_chol': WPE_ITERATIONS}
    check(launches == expected,
          f'all-Pallas launches {launches}, expected {expected}')
    check_wav(ex, x)
    obs_s = observation_seconds(ex)
    print(f'all-Pallas utterance {ex["example_id"]}: wall {wall:.4f} s, '
          f'observation {obs_s:.3f} s, emitted {len(x) / 16000:.3f} s, '
          f'xRT emitted {len(x) / 16000 / wall:.3f}, '
          f'xRT observation {obs_s / wall:.3f}', flush=True)
    wpe_ms = {'default': [], 'all_pallas': []}
    for label, e in (('default', enhancer), ('all_pallas', pallas_enhancer),
                     ('default', enhancer), ('all_pallas', pallas_enhancer)):
        ms = stage_times(gss, e, ex)
        wpe_ms[label].append(ms['wpe_ms'])
        print('stages', json.dumps({'utterance': ex['example_id'],
                                    'config': label, **ms}), flush=True)
    card_vs_cpu(torch, GssConfig(bss_iterations=10, **all_pallas),
                'all-Pallas')
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return launches, wpe_ms


def capture_k1_inputs(enhancer, ex, n=1):
    """K1's inputs at E+M pass ``n`` (0: the first, unmasked) of
    ``enhancer.enhance_example(ex)``, captured by a one-shot wrapper of the
    entry that ``ops/cacgmm.py`` calls (as ``LaunchCounts`` wraps the
    entries); every pass still runs the kernel."""
    from pb_chime5_tpu_torch.ops import cacgmm
    real = cacgmm.fused_em_scatter
    passes = []

    def capture(z, params, act, fm):
        passes.append((z.clone(), tuple(p.clone() for p in params),
                       act.clone(), fm.clone()) if len(passes) == n
                      else None)
        return real(z, params, act, fm)
    cacgmm.fused_em_scatter = capture
    try:
        enhancer.enhance_example(ex)
    finally:
        cacgmm.fused_em_scatter = real
    check(len(passes) == EM_PASSES, f'{len(passes)} E+M passes, expected '
          f'{EM_PASSES}')
    return passes[n]


def capture_mvdr_input(enhancer, ex):
    """The loaded, equilibrated noise covariances that the MVDR solve of
    ``enhancer.enhance_example(ex)`` hands the relative-mode entry: the
    solve's (A, B), captured by a one-shot wrapper of the solve that
    ``ops/beamform.py`` calls (as ``capture_k1_inputs`` wraps K1's entry;
    the solve still runs the kernel), conditioned as the solve conditions
    them."""
    from pb_chime5_tpu_torch.ops import beamform, linalg
    real = beamform.hermitian_solve_gj
    systems = []

    def capture(A, B, **kw):
        systems.append((A.clone(), B.clone(), kw))
        return real(A, B, **kw)
    beamform.hermitian_solve_gj = capture
    try:
        enhancer.enhance_example(ex)
    finally:
        beamform.hermitian_solve_gj = real
    check(len(systems) == MVDR_SOLVES, f'{len(systems)} MVDR solves, '
          f'expected {MVDR_SOLVES}')
    A, B, kw = systems[0]
    return linalg.equilibrate(A, B, **kw)[1]


def mvdr_vs_plain(torch, gj_inverse, B, label):
    """The relative-mode inverse on ``B``, an MVDR solve's input, against
    its plain version, ``ops/linalg.py::gauss_jordan_inverse_and_logdet``
    (the inverse, the logdet and a float64 residual at the gates of the
    EM-like batch); returns the largest absolute difference."""
    from pb_chime5_tpu_torch.ops import linalg
    from tests.test_torch_kernels_cuda import against_float64, inverse_errors
    kernel = gj_inverse.gauss_jordan_inverse_and_logdet
    before = kernel.launches
    inv, ld = kernel(B)
    torch.cuda.synchronize()
    check(kernel.launches == before + 1,
          f'{kernel.__name__} did not count its launch')
    inv_ref, ld_ref = linalg.gauss_jordan_inverse_and_logdet(B)
    rel, dld, max_abs = inverse_errors(inv, ld, inv_ref, ld_ref)
    res, dld64 = against_float64(B, inv, ld)
    res_ref, dld64_ref = against_float64(B, inv_ref, ld_ref)
    bit = torch.equal(inv, inv_ref) and torch.equal(ld, ld_ref)
    print(f'{kernel.__name__} on {label} {tuple(B.shape)}: vs '
          f'plain rel_inv {rel:.3e} (<= {EM_INV_RTOL}), logdet {dld:.3e} '
          f'(<= {EM_LOGDET_ATOL}); vs float64: residual {res:.3e} (plain '
          f'{res_ref:.3e}), logdet {dld64:.3e} (plain {dld64_ref:.3e}); '
          f'bit-equal to plain: {bit}', flush=True)
    check(bool(torch.isfinite(inv).all() and torch.isfinite(ld).all()),
          f'{kernel.__name__} output is not finite on {label}')
    check(rel <= EM_INV_RTOL and dld <= EM_LOGDET_ATOL,
          f'{kernel.__name__} disagrees with its plain version on {label}')
    check(res <= 2 * res_ref + 1e-6,
          f'{kernel.__name__} has a larger residual than its plain version '
          f'on {label}')
    return max_abs


def mvdr_on_p06(torch, gj_inverse, enhancer, examples):
    """Phase 6: the relative-mode inverse on the input the MVDR solve
    gives it on the longest utterance at the default config (513
    equilibrated noise covariances of 24 x 24, loaded at 64 eps) against
    its plain version (:func:`mvdr_vs_plain`), then its times there."""
    from pb_chime5_tpu_torch.ops import linalg
    B = capture_mvdr_input(enhancer, max(examples, key=observation_seconds))
    label = "P06's MVDR input"
    max_abs = mvdr_vs_plain(torch, gj_inverse, B, label)
    return dict(max_abs_err=max_abs, **inverse_times(
        torch, gj_inverse.gauss_jordan_inverse_and_logdet,
        linalg.gauss_jordan_inverse_and_logdet, B, label))


def k1_on_p06(torch, fused_em, gj_inverse, enhancer, examples):
    """Phase 6, first part: K1 on P06's real EM state, its inputs at the
    first masked pass (the second of the 20) of the longest utterance at
    the default config; the share of active (frame, class) pairs, S and
    den against the plain version at the headline tolerances, both
    versions' S against the plain formula in float64 (printed), and the
    times beside the bound on these inputs.  Then ``em_finalize`` on K1's
    S and den of that pass, both floor modes, against the plain finalize
    (:func:`check_finalize`), and its times."""
    from tests.test_torch_fused_em_cuda import scatter_errors
    inputs = capture_k1_inputs(enhancer, max(examples,
                                             key=observation_seconds))
    z, _, act, fm = inputs
    F, T, D = z.shape
    K = act.shape[0]
    valid = fm > 0
    n_valid = int(valid.sum())
    active = int(((act > 0) & valid).sum())
    print(f'K1 on P06 (first masked pass): F={F}, T={T}, D={D}, K={K}, '
          f'{n_valid} valid frames; active (frame, class) pairs '
          f'{active} of {n_valid * K} = {active / (n_valid * K):.4f}, '
          f'{active / n_valid:.3f} classes per frame; per class '
          f'{[round(float(a), 4) for a in (act > 0)[:, valid].float().mean(1)]}',
          flush=True)
    S, den = fused_em.fused_em_scatter(*inputs)
    torch.cuda.synchronize()
    S_ref, den_ref = fused_em.fused_em_scatter_reference(*inputs)
    rel_S, rel_den, max_abs = scatter_errors(S, den, S_ref, den_ref)
    lw, prec, ld = inputs[1]
    S64, den64 = fused_em.fused_em_scatter_reference(
        z.to(torch.complex128), (lw.double(), prec.to(torch.complex128),
                                 ld.double()), act.double(), fm.double())
    rel64 = scatter_errors(S.to(torch.complex128), den.double(), S64,
                           den64)[0]
    rel64_ref = scatter_errors(S_ref.to(torch.complex128), den_ref.double(),
                               S64, den64)[0]
    del S64, den64
    print(f'K1 on P06: vs plain rel_S {rel_S:.3e} (<= {S_RTOL}), rel_den '
          f'{rel_den:.3e} (<= {DEN_RTOL}), max_abs {max_abs:.3e}; S vs '
          f'float64: kernel {rel64:.3e}, plain {rel64_ref:.3e}', flush=True)
    check(bool(torch.isfinite(S).all() and torch.isfinite(den).all()),
          'K1 output on P06 is not finite')
    check(rel_S <= S_RTOL and rel_den <= DEN_RTOL,
          'K1 disagrees with its plain version on P06')
    del S, den, S_ref, den_ref
    t = in_turns(torch, {
        'plain': (lambda: fused_em.fused_em_scatter_reference(*inputs), 2),
        'kernel': (lambda: fused_em.fused_em_scatter(*inputs), 10)})
    print_times(f'K1 on P06 at F,T,D,K=({F}, {T}, {D}, {K})', t,
                *k1_bound(*inputs))
    S, den = fused_em.fused_em_scatter(*inputs)
    for floor in ('relative', 'flt_min'):
        check_finalize(torch, gj_inverse, S, den, floor, "P06's EM state")
        finalize_times(torch, gj_inverse, S, den, floor, "on P06's EM state")


def wpe_systems(torch, chol_solve, wpe_stats, enhancer, examples):
    """Phase 6: the first WPE iteration's statistics of the longest
    utterance (R (513, 240, 240), P (513, 240, 24) of its STFT, as
    ``ops/wpe.py`` builds them) by K2 and by its plain version, held to
    each other and timed in turns; the plain version's R and P solved at
    the WPE load by both K5 instantiations (``hermitian_solve_chol``, the
    path's solve, and the real-form ``hermitian_solve_pallas``), each
    one's plain version and the port's cuSOLVER ``hermitian_solve``."""
    import numpy as np
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.gss import GssConfig
    from pb_chime5_tpu_torch.ops import linalg, wpe
    from tests.test_torch_kernels_cuda import stats_errors
    ex = max(examples, key=observation_seconds)
    _, obs = enhancer._prepare_example(ex)
    Y = gss._stft_and_mask(torch.from_numpy(obs).cuda(), None,
                           GssConfig())[0].contiguous()
    Y_tilde = wpe.build_y_tilde(Y, WPE_TAPS, 2)
    inv_power = wpe.get_power_inverse(Y)
    R, P = wpe_stats.wpe_statistics_reference(Y_tilde, Y, inv_power)
    R_k, P_k = wpe_stats.wpe_statistics(Y_tilde, Y, inv_power)
    torch.cuda.synchronize()
    rel_R, rel_P, max_abs = stats_errors(R_k, P_k, R, P)
    F, dim, T = Y_tilde.shape
    D = Y.shape[1]
    print(f'K2 on P06 (first WPE iteration): F={F}, dim={dim}, D={D}, '
          f'T={T}; inv_power {float(inv_power.min()):.3e} .. '
          f'{float(inv_power.max()):.3e}; rel_R {rel_R:.3e}, rel_P '
          f'{rel_P:.3e} (<= {STATS_RTOL}), max_abs {max_abs:.3e}',
          flush=True)
    check(bool(torch.isfinite(R_k).all() and torch.isfinite(P_k).all()),
          'K2 output on P06 is not finite')
    check(rel_R <= STATS_RTOL and rel_P <= STATS_RTOL,
          'K2 disagrees with its plain version on P06')
    del R_k, P_k
    t = in_turns(torch, {
        'plain': (lambda: wpe_stats.wpe_statistics_reference(
            Y_tilde, Y, inv_power), 2),
        'kernel': (lambda: wpe_stats.wpe_statistics(Y_tilde, Y, inv_power),
                   3)})
    # every frame of the utterance is valid (no bucket padding here)
    bound_ms, bound_by = bound(
        nbytes(Y_tilde, Y, inv_power) + F * dim * (dim + D) * 8,
        8.0 * F * T * (dim * (dim + 1) // 2 + dim * D))
    print_times(f'K2 on P06 at F,dim,D,T=({F}, {dim}, {D}, {T})', t,
                bound_ms, bound_by)
    del Y_tilde
    R = linalg.hermitize(R)
    solvers = {
        'chol': chol_solve.hermitian_solve_chol,
        'chol_plain': chol_solve.hermitian_solve_chol_reference,
        'k5': chol_solve.hermitian_solve_pallas,
        'plain': chol_solve.hermitian_solve_pallas_reference,
        'cusolver': linalg.hermitian_solve}
    G = {name: fn(R, P, relative_load=WPE_LOAD)
         for name, fn in solvers.items()}
    torch.cuda.synchronize()
    ew = torch.linalg.eigvalsh(
        linalg.equilibrate(R, P, WPE_LOAD)[1].to(torch.complex128))
    cond = (ew[:, -1] / ew[:, 0]).cpu().numpy()
    print(f'P06 WPE systems: F={R.shape[0]}, dim={R.shape[1]}, '
          f'D={P.shape[2]}, T={Y.shape[2]}; condition of the loaded, '
          f'equilibrated R: median {np.median(cond):.3e}, max '
          f'{cond.max():.3e}', flush=True)
    res = {}
    for name, r in solve_residuals(torch, linalg, R, P, G,
                                   WPE_LOAD).items():
        check(bool(torch.isfinite(G[name]).all()), f'{name}: G is not '
                                                    f'finite')
        res[name] = float(r.max())
        print(f'  {name}: residual ||R_s G - P_s|| / ||P_s|| median '
              f'{np.median(r):.3e}, max {r.max():.3e}', flush=True)
    print(f'  hermitian_solve_chol bit-equal to its plain version: '
          f'{bool(torch.equal(G["chol"], G["chol_plain"]))}', flush=True)
    for a, b in (('chol', 'chol_plain'), ('chol', 'cusolver'),
                 ('k5', 'plain'), ('k5', 'cusolver'), ('plain', 'cusolver')):
        d = (torch.linalg.matrix_norm(G[a] - G[b])
             / torch.linalg.matrix_norm(G[b])).cpu().numpy()
        print(f'  |G_{a} - G_{b}| / |G_{b}|: median {np.median(d):.3e}, '
              f'max {d.max():.3e}', flush=True)
    check(res['chol'] <= 2 * res['chol_plain'] + 1e-6,
          'hermitian_solve_chol has a larger residual than its plain version '
          'on P06')
    check(res['k5'] <= 2 * res['plain'] + 1e-6,
          'K5 has a larger residual than its plain version on P06')
    check(not imported_jax(), 'the run imported jax or the JAX package')


OPTIONS = {           # phase 7 on P06: GssConfig fields of each option
    'gev_ban': dict(bf='gev_ban'),
    'lcmv': dict(bf='lcmv'),
    'wpe_options': dict(wpe_psd_context=1, wpe_chunk_size=512,
                        wpe_solve_refine=1),
    'cholesky': dict(bss_inverse='cholesky'),
    'eigh': dict(bss_inverse='eigh'),
}
# their kernel launches per utterance beside K1's 20 and the WPE solve's 3
# (every option runs WPE): K2's 3 where WPE has no chunk_size (the
# chunked statistics are complex matmuls), em_finalize where the
# EM inverse stays Gauss-Jordan, the complex64 MVDR solve where the
# beamformer is MVDR (GEV and LCMV solve in float64, on the plain version)
OPTION_LAUNCHES = {
    'gev_ban': {'em_finalize': EM_PASSES, 'wpe_statistics': WPE_ITERATIONS},
    'lcmv': {'em_finalize': EM_PASSES, 'wpe_statistics': WPE_ITERATIONS},
    'wpe_options': {'em_finalize': EM_PASSES,
                    'gauss_jordan_inverse_and_logdet': MVDR_SOLVES},
    'cholesky': {'gauss_jordan_inverse_and_logdet': MVDR_SOLVES,
                 'wpe_statistics': WPE_ITERATIONS},
    'eigh': {'gauss_jordan_inverse_and_logdet': MVDR_SOLVES,
             'wpe_statistics': WPE_ITERATIONS},
}
# the small scene, card vs CPU, at the 10-iteration EM of the other
# phases: each option and ch2 / sum.  GEV + BAN runs without WPE, as
# tests/test_gss_pipeline.py runs it.  LCMV runs with WPE: without it, its
# SIR gain on this scene is 13x, under the 30x gate (the JAX test holds
# LCMV to 10x)
SCENE_OPTIONS = {
    'gev_ban': (dict(bf='gev_ban', wpe=False), True),
    'lcmv': (dict(bf='lcmv'), True),
    'lcmv_ban': (dict(bf='lcmv_ban'), True),
    'ch2': (dict(bf='ch2'), False),
    'sum': (dict(bf='sum'), False),
    **{name: (kw, True) for name, kw in OPTIONS.items()
       if name not in ('gev_ban', 'lcmv')},
}
# printed, not gated (PERF.md, PR 3 findings): GEV without BAN puts 2/3
# of this scene's output in one bin at a generalized eigenvalue of 5e4,
# where it reads the EM's posteriors below float32 resolution (an additive
# 1e-6 moves it by 1.8e-2 of the peak, MVDR + BAN by 5e-7); and GEV turns
# WPE's float32 rounding into a few 1e-2 of the peak (with WPE in float64
# it does not; scripts_dev/diag_torch_scene_precision.py)
SCENE_UNGATED = {
    'gev': dict(bf='gev', wpe=False),
    'gev_ban with WPE': dict(bf='gev_ban'),
}
SCENE_ITERATIONS = 10


def options_path(torch, counts, enhancer, examples):
    """Phase 7: the session ``Enhancer`` on the longest utterance, warm,
    once for each option of OPTIONS (20 K1 launches and those of
    OPTION_LAUNCHES, nothing else), then the small scene per option."""
    import numpy as np
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.gss import GssConfig, gss_enhance
    ex = max(examples, key=observation_seconds)
    obs_s = observation_seconds(ex)
    for name, fields in OPTIONS.items():
        e = dataclasses.replace(enhancer, gss_config=GssConfig(**fields))
        e.enhance_example(ex)                 # warm-up
        torch.cuda.synchronize()
        counts.reset()
        start = time.perf_counter()
        x = e.enhance_example(ex)
        wall = time.perf_counter() - start
        launches = counts.read()
        expected = {**dict.fromkeys(launches, 0),
                    'fused_em_scatter': EM_PASSES,
                    'hermitian_solve_chol': WPE_ITERATIONS,
                    **OPTION_LAUNCHES[name]}
        print(f'option {name} launches: {launches}', flush=True)
        check(launches == expected,
              f'option {name}: launches {launches}, expected {expected}')
        check_wav(ex, x)
        print(f'option {name} utterance {ex["example_id"]}: wall '
              f'{wall:.4f} s, xRT emitted {len(x) / 16000 / wall:.3f}, '
              f'xRT observation {obs_s / wall:.3f}', flush=True)
        print('stages', json.dumps({'utterance': ex['example_id'],
                                    'config': name,
                                    **stage_times(gss, e, ex)}), flush=True)
    for name, (fields, separates) in SCENE_OPTIONS.items():
        card_vs_cpu(torch, GssConfig(bss_iterations=SCENE_ITERATIONS,
                                     **fields), name, separates)
    for name, fields in SCENE_UNGATED.items():
        card_vs_cpu(torch, GssConfig(bss_iterations=SCENE_ITERATIONS,
                                     **fields), name, gated=False)
    from pb_chime5_tpu_torch.utils import activity_time_to_frequency
    obs, activity, (b0, b1) = small_scene()
    act = torch.from_numpy(activity_time_to_frequency(
        activity, 1024, 256, stft_fading=True, stft_pad=True))
    # 'schur' loses positive definiteness in float32 on converged EM
    # covariances (the JAX _invert's note): held on the CPU alone
    x = gss_enhance(torch.from_numpy(obs), act, 0, config=GssConfig(
        bss_iterations=SCENE_ITERATIONS, bss_inverse='schur'))[0].numpy()
    gain = sir_gain(obs, x, b0, b1)
    print(f'small scene, schur on the CPU: SIR gain {gain:.1f}x (> 30)',
          flush=True)
    check(np.isfinite(x).all() and gain > 30,
          'the schur EM does not separate the small scene on the CPU')
    check(not imported_jax(), 'the run imported jax or the JAX package')


# phase 8: bench.py's session (bench.py:202-205)
SESSION = dict(session_ids=('S02',), duration_seconds=420.0,
               utterances_per_speaker=25, num_arrays=6, num_array_mics=4,
               seed=3, pcm16=True)
RACE_WINDOW_SECONDS = 60.0    # a refill every few utterances
QUALITY_SEEDS = (0, 1, 2, 3, 4)
GATED_SEEDS = (0, 1, 2)       # tests/test_realistic_scene.py's pins
QUALITY_CONFIGS = (('10-iteration EM', dict(bss_iterations=10)),
                   ('default 20 + 1 EM', {}))


def expected_launches(launches, n):
    """The default config's launches for ``n`` utterances: K1 and
    ``em_finalize`` EM_PASSES times, the MVDR solve's inverse MVDR_SOLVES
    times, the WPE statistics (K2) and solve WPE_ITERATIONS times, nothing
    else."""
    return {**dict.fromkeys(launches, 0),
            'fused_em_scatter': EM_PASSES * n,
            'em_finalize': EM_PASSES * n,
            'gauss_jordan_inverse_and_logdet': MVDR_SOLVES * n,
            'wpe_statistics': WPE_ITERATIONS * n,
            'hermitian_solve_chol': WPE_ITERATIONS * n}


class Tee(io.TextIOBase):
    """Standard output that also keeps what was written."""

    def __init__(self, out):
        self.out, self.text = out, io.StringIO()

    def write(self, s):
        self.text.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def cache_stats_line(text):
    """The dict of the last ``session-audio cache: {...}`` line."""
    lines = [line for line in text.splitlines()
             if line.startswith('session-audio cache: ')]
    check(bool(lines), 'no session-audio cache line was printed')
    return ast.literal_eval(lines[-1].split(': ', 1)[1])


def make_session_corpus(root):
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    from pb_chime5_tpu_torch.testing import create_synthetic_chime5
    create_synthetic_chime5(root / 'CHiME5', **SESSION)
    dump_json(create_database(root / 'CHiME5'), root / 'chime5.json')
    return root / 'chime5.json'


def array_reads(enhancer, examples):
    """Per example, [(files, samples)] of the direct path's reads: each
    array read up to its files' end."""
    from pb_chime5_tpu_torch.io import audio_length
    lengths, out = {}, []
    for ex in examples:
        reads = []
        for paths, s, e, _sel in enhancer._cache_spans(
                ex, ex['reference_array']):
            key = tuple(paths)
            if key not in lengths:
                lengths[key] = min(audio_length(p) for p in paths)
            reads.append((paths, max(min(e, lengths[key]) - s, 0)))
        out.append(reads)
    return out


def observation_bytes(enhancer, examples):
    """(bytes read, bytes uploaded, valid seconds) of the direct path's
    observations: each array read up to its files' end, the min over the
    arrays zero-padded to its length bucket and uploaded."""
    read, upload, valid = 0, 0, 0
    for reads in array_reads(enhancer, examples):
        n = min(ns for _, ns in reads)
        read += sum(len(paths) * ns * 2 for paths, ns in reads)
        channels = sum(len(paths) for paths, _ in reads)
        upload += channels * enhancer._pipeline.bucket_length(n) * 2
        valid += n
    return read, upload, valid / 16000


def settled_stats(cache):
    """The cache's stats once a pending prefetch (the window past a
    session's last utterance) is discarded and charged."""
    cache.new_run()
    if cache._executor is not None:
        cache._executor.submit(lambda: None).result()
    return dict(cache.stats)


def session_pass(torch, counts, enhancer, n, out, expected=None,
                 dataset_slice=False):
    """One ``enhance_session`` of the whole session into ``out``: its
    wall, launches (gated), the cache's stats line of this call, the bytes
    it moved with the prefetched window that its end leaves (charged to
    the next call's line), the peak device memory, and the sum of the
    chains' stage windows (``record_stage_times``: from each
    ``gss_enhance``'s first event to its last on the stream) with the
    share of the wall outside them, where the card waits between
    utterances.  ``expected``: the launches (default: the default
    config's); ``dataset_slice``: the session's first utterances only."""
    from pb_chime5_tpu_torch.models import gss
    cache = enhancer._audio_cache
    before = settled_stats(cache) if cache is not None else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    tee = Tee(sys.stdout)
    with gss.record_stage_times() as times:
        start = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            enhancer.enhance_session(['S02'], out, audio_dir_exist_ok=True,
                                     dataset_slice=dataset_slice)
        wall = time.perf_counter() - start
    chain_s = sum(sum(t.values()) for t in times) / 1e3
    launches = counts.read()
    if expected is None:
        expected = expected_launches(launches, n)
    check(launches == expected,
          f'session pass launches {launches}, expected {expected}')
    wavs = sorted((out / 'dev').glob('*.wav'))
    check(len(wavs) == n, f'{len(wavs)} WAVs, expected {n}')
    numbers = dict(wall_s=wall, chain_s=chain_s,
                   outside_chains=1 - chain_s / wall,
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    if cache is None:
        return numbers
    after = settled_stats(cache)
    return dict(numbers, stats=cache_stats_line(tee.text.getvalue()),
                moved_mb=after['refill_mb'] - before['refill_mb'],
                tail_prefetch_wasted=(after['prefetch_wasted']
                                      - before['prefetch_wasted']))


def same_wavs(a, b):
    names = sorted(p.name for p in (a / 'dev').glob('*.wav'))
    return names == sorted(p.name for p in (b / 'dev').glob('*.wav')) and \
        all((a / 'dev' / n).read_bytes() == (b / 'dev' / n).read_bytes()
            for n in names)


def check_cache_stats(stats, n, label):
    check(stats['hits'] > 0 and stats['refills'] >= 2
          and stats['prefetch_hits'] >= 1 and stats['prefetch_wasted'] == 0
          and stats['direct'] == 0
          and stats['hits'] + stats['refills'] == n,
          f'{label}: cache stats {stats}: expected hits > 0, refills >= 2, '
          f'prefetch_hits >= 1, prefetch_wasted == 0, direct == 0 and '
          f'every utterance served from a window')


def refill_anatomy(torch, cache, spans):
    """One window refill in parts: the host read, ``pin_memory()`` three
    times (PyTorch's caching host allocator keeps a freed pinned block),
    the copy from pinned memory, and the cache's whole ``upload()`` three
    times."""
    from pb_chime5_tpu_torch.models.audio_cache import SessionAudioCache
    host_cache = SessionAudioCache(window_seconds=cache.window / 16000,
                                   coerce=cache.coerce, device='cpu')
    bases = [max(0, s - cache.margin) for _p, s, _e, _sel in spans]
    host, nbytes, read_s = host_cache._load_window(spans, bases)
    times = {'read_s': read_s, 'pin_s': [], 'upload_s': []}
    for _ in range(3):
        start = time.perf_counter()
        pinned = host.pin_memory()
        times['pin_s'].append(time.perf_counter() - start)
    start = time.perf_counter()
    pinned.to('cuda', non_blocking=True)
    torch.cuda.synchronize()
    times['copy_s'] = time.perf_counter() - start
    for _ in range(3):
        start = time.perf_counter()
        cache.upload(host.numpy())
        times['upload_s'].append(time.perf_counter() - start)
    print('refill anatomy', json.dumps({'window_mb': nbytes / 1e6,
                                        **times}), flush=True)


def session_path(torch, counts, work):
    """Phase 8: the session path as users run it (``enhance_session`` at
    the default config, 6 arrays x 4 mics) on bench.py's 420 s session,
    with the session-audio cache on and off in turns; returns (DB JSON,
    utterances, emitted and processed seconds, the cached passes' median
    wall and stage windows)."""
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    start = time.perf_counter()
    db = make_session_corpus(work / 'session')
    print(f'session corpus + DB JSON: {time.perf_counter() - start:.2f} s',
          flush=True)
    kw = dict(multiarray=True, database_path=str(db), device='cuda')
    enhancers = {'on': get_enhancer(**kw),
                 'off': get_enhancer(device_audio_cache=False, **kw)}
    examples = list(enhancers['on'].get_iterator('S02'))
    n = len(examples)
    read, upload, valid_s = observation_bytes(enhancers['off'], examples)
    emitted_s = sum(ex['num_samples_orig']['observation'][
        ex['reference_array']] for ex in examples) / 16000
    session_s = SESSION['duration_seconds']
    print(f'session S02: {session_s} s, {n} utterances ({n / session_s:.3f} '
          f'a second), {emitted_s:.3f} s emitted, {valid_s:.3f} s of '
          f'observation processed; direct path: {read / 1e6:.1f} MB read, '
          f'{upload / 1e6:.1f} MB uploaded', flush=True)

    out = work / 'session' / 'out'
    session_pass(torch, counts, enhancers['on'], n, out / 'warm')
    passes = []
    for i, mode in enumerate(('on', 'off', 'off', 'on')):
        p = session_pass(torch, counts, enhancers[mode], n, out / f'{i}')
        p['mode'] = mode
        if mode == 'on':
            check_cache_stats(p['stats'], n, f'pass {i} (cache on)')
            p['read_mb'] = p['upload_mb'] = p['moved_mb']
        else:
            p['read_mb'], p['upload_mb'] = read / 1e6, upload / 1e6
        p.update(utterances_per_s=n / p['wall_s'],
                 xrt_emitted=emitted_s / p['wall_s'],
                 xrt_processed=valid_s / p['wall_s'])
        passes.append(p)
        print('session pass', json.dumps({'pass': i, **p}), flush=True)
    for mode in ('on', 'off'):
        walls = [p['wall_s'] for p in passes if p['mode'] == mode]
        print(f'session walls, cache {mode}: {walls} s, median '
              f'{statistics.median(walls):.4f} s, spread '
              f'{max(walls) - min(walls):.4f} s', flush=True)
    identical = all(same_wavs(out / '1', out / f'{i}') for i in (0, 2, 3))
    print(f'cached WAVs byte-identical to the direct ones: {identical}',
          flush=True)
    check(identical, 'the cached session wrote other WAVs than the direct '
                     'one')

    race = get_enhancer(cache_window_seconds=RACE_WINDOW_SECONDS, **kw)
    p = session_pass(torch, counts, race, n, out / 'race')
    identical = same_wavs(out / '1', out / 'race')
    print('race check', json.dumps({
        'window_s': RACE_WINDOW_SECONDS, 'write_ahead': 'default (4)', **p,
        'byte_identical': identical}), flush=True)
    check(identical and p['stats']['direct'] == 0
          and p['stats']['refills'] >= 2
          and p['stats']['hits'] + p['stats']['refills'] == n,
          f'race check: byte-identical {identical}, stats {p["stats"]}')
    ex = examples[len(examples) // 2]
    refill_anatomy(torch, enhancers['on']._audio_cache,
                   enhancers['on']._cache_spans(ex, ex['reference_array']))
    check(not imported_jax(), 'the run imported jax or the JAX package')
    on = [p for p in passes if p['mode'] == 'on']
    return db, n, emitted_s, valid_s, dict(
        wall_s=statistics.median(p['wall_s'] for p in on),
        chain_s=statistics.median(p['chain_s'] for p in on))


def quality_path(torch):
    """Phase 9: tests/test_realistic_scene.py's quality gate on the card:
    the realistic scenes of QUALITY_SEEDS (made in parallel processes)
    through ``gss_enhance`` on CUDA at a 10-iteration EM, postfilter None
    and 'mask_mul', gated on the JAX test's pins as medians over
    GATED_SEEDS; the default 20 + 1 EM printed beside it.  Returns the
    scenes and {config: medians over GATED_SEEDS}."""
    import concurrent.futures
    import functools
    import multiprocessing
    import numpy as np
    from pb_chime5_tpu_torch.testing.rooms import make_reverberant_scene
    from tests.test_torch_realistic_scene import (
        PINS, SCENE, chain_quality, medians)
    start = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            len(QUALITY_SEEDS),
            mp_context=multiprocessing.get_context('spawn')) as pool:
        scenes = list(pool.map(
            functools.partial(make_reverberant_scene, **SCENE),
            [np.random.default_rng(seed) for seed in QUALITY_SEEDS]))
    print(f'{len(scenes)} realistic scenes: '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    gated, by_config = None, {}
    for label, config in QUALITY_CONFIGS:
        start = time.perf_counter()
        per_seed = {seed: chain_quality(scene, 'cuda', **config)
                    for seed, scene in zip(QUALITY_SEEDS, scenes)}
        for seed, q in per_seed.items():
            print('quality', json.dumps({'config': label, 'seed': seed, **q}),
                  flush=True)
        med3 = by_config[label] = medians({s: per_seed[s]
                                           for s in GATED_SEEDS})
        print('quality medians', json.dumps({
            'config': label, f'seeds {list(GATED_SEEDS)}': med3,
            f'seeds {list(QUALITY_SEEDS)}': medians(per_seed),
            'pins (median over seeds 0-2 >)': PINS,
            'gated': gated is None,
            'seconds': time.perf_counter() - start}), flush=True)
        if gated is None:
            gated = med3
    failed = {k: v for k, v in gated.items() if not v > PINS[k]}
    check(not failed, f'quality pins missed on the card: {failed}')
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return scenes, by_config



# phase 10: the CHiME-6 entry points.  The depth is cut to 120 s and 12
# utterances so that the phase keeps inside the script's time limit; the
# width (6 arrays x 4 mics, the default config) is not
CHIME6_SESSION = dict(session_ids=('S02',), duration_seconds=120.0,
                      utterances_per_speaker=3, num_arrays=6,
                      num_array_mics=4, seed=6, pcm16=True)
CHIME6_JOBS = 3
CARD_VS_CPU_EM = 2    # EM iterations of the card-vs-CPU runs


def make_chime6_corpus(root):
    """CHIME6_SESSION -> a CHiME-6 tree (the port's
    ``simulate_chime6_transcriptions``) -> its DB JSON (the port's
    ``create_json --chime6``), and ci.sh's RTTM of the annotations; returns
    (DB JSON, CHiME-6 dir, RTTM)."""
    from pb_chime5_tpu_torch.database.create_json import (
        main as create_json, to_samples)
    from pb_chime5_tpu_torch.io import load_json
    from pb_chime5_tpu_torch.scripts.simulate_chime6_transcriptions import (
        main as simulate)
    from pb_chime5_tpu_torch.testing import create_synthetic_chime5
    create_synthetic_chime5(root / 'CHiME5', **CHIME6_SESSION)
    with contextlib.redirect_stdout(io.StringIO()):
        simulate(root / 'CHiME5', root / 'CHiME6')
    create_json(['--database-path', str(root / 'CHiME6'),
                 '--json-path', str(root / 'chime6.json'), '--chime6'])
    lines = []
    for t in load_json(root / 'CHiME5' / 'transcriptions' / 'dev' /
                       'S02.json'):
        s = to_samples(t['start_time']['original'])
        e = to_samples(t['end_time']['original'])
        lines.append(f"SPEAKER S02_U06 1 {s / 16000:.7f} "
                     f"{(e - s) / 16000:.7f} <NA> <NA> {t['speaker']} <NA>")
    (root / 'dev.rttm').write_text('\n'.join(lines))
    return root / 'chime6.json', root / 'CHiME6', root / 'dev.rttm'


def cli_pass(torch, counts, make_experiment, argv, storage, n,
             n_wavs=None):
    """One CLI run (``main``, on the card: the CLIs' default device) of
    ``n`` utterances into ``storage``: its wall, launches (gated: 20 / 20 /
    1 / 3 / 3 an utterance, nothing else), the WAVs there (``n_wavs``, by
    default ``n``), printed output and peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    text = io.StringIO()            # the CLI's configuration listing
    start = time.perf_counter()
    with contextlib.redirect_stdout(text):
        make_experiment(default_storage=storage / 'runs').run_commandline(
            ['main', 'with', f'storage_dir={storage}', *argv])
    wall = time.perf_counter() - start
    text = text.getvalue()
    for line in text.splitlines():
        if line.startswith('session-audio cache: '):
            print(line, flush=True)
    launches = counts.read()
    check(launches == expected_launches(launches, n),
          f'{argv}: launches {launches}, expected '
          f'{expected_launches(launches, n)}')
    wavs = sorted((storage / 'audio' / 'dev').glob('*.wav'))
    n_wavs = n if n_wavs is None else n_wavs
    check(len(wavs) == n_wavs, f'{argv}: {len(wavs)} WAVs, expected '
                               f'{n_wavs}')
    return dict(wall_s=wall, launches=launches, wavs=wavs, text=text,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def check_wavs(wavs, num_samples, label):
    """Each WAV finite, non-silent and of its utterance's length."""
    import numpy as np
    from pb_chime5_tpu_torch.io import load_audio
    for wav in wavs:
        x = load_audio(wav)
        check(len(x) == num_samples[wav.stem],
              f'{label} {wav.stem}: {len(x)} samples, expected '
              f'{num_samples[wav.stem]}')
        check(np.isfinite(x).all() and np.abs(x).max() > 0,
              f'{label} {wav.stem} is not finite and non-silent')


def path_numbers(label, p, n, emitted_s, processed_s, **extra):
    """The printed (not gated) numbers of one path's pass."""
    print(label, json.dumps({
        'wall_s': p['wall_s'], 'utterances': n,
        'utterances_per_s': n / p['wall_s'], 'emitted_s': emitted_s,
        'processed_s': processed_s,
        'xrt_emitted': emitted_s / p['wall_s'],
        'xrt_processed': processed_s / p['wall_s'],
        'peak_gib': p['peak_gib'], **extra}), flush=True)


def card_vs_cpu_utterance(torch, factory, example_of, label):
    """The first utterance through ``factory`` at CARD_VS_CPU_EM EM
    iterations (all else default) on the card and on the port's CPU path:
    within SCENE_ATOL of the peak."""
    import numpy as np
    outs = {}
    for device in ('cuda', 'cpu'):
        enhancer = factory(bss_iterations=CARD_VS_CPU_EM, device=device)
        start = time.perf_counter()
        outs[device] = enhancer.enhance_example(example_of(enhancer))
        print(f'{label}, {CARD_VS_CPU_EM} EM iterations, {device}: '
              f'{time.perf_counter() - start:.3f} s', flush=True)
    err = float(np.abs(outs['cuda'] - outs['cpu']).max()
                / np.abs(outs['cpu']).max())
    print(f'{label}: card vs CPU {err:.3e} of the peak (<= {SCENE_ATOL})',
          flush=True)
    check(np.isfinite(outs['cuda']).all() and err <= SCENE_ATOL,
          f'card and CPU paths disagree on {label}')


def chime6_track1(torch, counts, db, work):
    """Phase 10, track 1: ``kaldi_run main with chime6=True multiarray``
    (default config, D = 24) as one job with the session-audio cache on
    (the process's first run at these shapes), off, and on again, then as
    CHIME6_JOBS jobs."""
    import functools
    from pb_chime5_tpu_torch.models.enhancer_chime6 import get_enhancer
    from pb_chime5_tpu_torch.scripts.kaldi_run import make_experiment
    argv = ['chime6=True', 'multiarray', 'session_id=S02',
            f'database_path={db}']
    kw = dict(multiarray=True, database_path=str(db))
    examples = list(get_enhancer(**kw).get_iterator('S02'))
    n = len(examples)
    num_samples = {ex['example_id']: ex['num_samples_orig']
                   for ex in examples}
    read, upload, processed_s = observation_bytes(
        get_enhancer(device_audio_cache=False, **kw), examples)
    emitted_s = sum(num_samples.values()) / 16000

    for label in ('on', 'off', 'on again'):
        p = cli_pass(torch, counts, make_experiment,
                     argv + (['device_audio_cache=False'] if label == 'off'
                             else []), work / label, n)
        if label == 'off':
            path_numbers('track 1, cache off', p, n, emitted_s, processed_s,
                         read_mb=read / 1e6, upload_mb=upload / 1e6)
            continue
        stats = cache_stats_line(p['text'])
        check(stats['hits'] > 0 and stats['direct'] == 0,
              f'track 1: cache stats {stats}: expected hits > 0, '
              f'direct == 0')
        path_numbers(f'track 1, cache {label}', p, n, emitted_s,
                     processed_s, read_mb=stats['refill_mb'],
                     upload_mb=stats['refill_mb'])
        if label == 'on':
            launches = p['launches']
            print(f'track 1 launches: {launches}', flush=True)
            check_wavs(p['wavs'], num_samples, 'track 1')
    identical = all(same_wavs(work / 'on' / 'audio', work / label / 'audio')
                    for label in ('off', 'on again'))
    print(f'track 1: cached WAVs byte-identical to the direct ones: '
          f'{identical}', flush=True)
    check(identical, 'track 1: the cached runs wrote other WAVs than the '
                     'direct one')
    done = 0
    for job_id in range(1, CHIME6_JOBS + 1):
        mine = len(examples[job_id - 1::CHIME6_JOBS])
        done += mine
        cli_pass(torch, counts, make_experiment,
                 argv + [f'job_id={job_id}',
                         f'number_of_jobs={CHIME6_JOBS}'],
                 work / 'jobs', mine, n_wavs=done)
    identical = same_wavs(work / 'on' / 'audio', work / 'jobs' / 'audio')
    print(f'track 1: jobs 1-{CHIME6_JOBS} of {CHIME6_JOBS} together: the '
          f'single job\'s WAVs byte for byte: {identical}', flush=True)
    check(identical, f'track 1: {CHIME6_JOBS} jobs wrote other WAVs than '
                     f'one job')
    card_vs_cpu_utterance(
        torch, functools.partial(get_enhancer, **kw),
        lambda e: e.get_iterator('S02')[examples[0]['example_id']],
        f'track 1 utterance {examples[0]["example_id"]}')
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return launches


def capture_solve_input(enhancer, ex):
    """The R and P of the first WPE iteration of
    ``enhancer.enhance_example(ex)``: the WPE solve's inputs, captured by
    a one-shot wrapper of the entry that ``ops/wpe.py`` calls (the solve
    still runs the kernel)."""
    from pb_chime5_tpu_torch.ops import wpe
    real = wpe.hermitian_solve_chol
    systems = []

    def capture(A, B, **kw):
        systems.append((A.clone(), B.clone(), kw))
        return real(A, B, **kw)
    wpe.hermitian_solve_chol = capture
    try:
        enhancer.enhance_example(ex)
    finally:
        wpe.hermitian_solve_chol = real
    check(len(systems) == WPE_ITERATIONS, f'{len(systems)} WPE solves, '
          f'expected {WPE_ITERATIONS}')
    return systems[0]


def solve_residuals(torch, linalg, R, P, G, load):
    """{name: per-frequency residual ||R_s G - P_s|| / ||P_s||} of the
    loaded, equilibrated system, in float64."""
    _, As, Bs, sinv = linalg.equilibrate(R, P, load)
    As, Bs = As.to(torch.complex128), Bs.to(torch.complex128)
    out = {}
    for name, g in G.items():
        Xs = g.to(torch.complex128) / sinv[..., None].to(torch.complex128)
        out[name] = (torch.linalg.matrix_norm(As @ Xs - Bs)
                     / torch.linalg.matrix_norm(Bs)).cpu().numpy()
    return out


def rttm_kernels(torch, fused_em, gj_inverse, chol_solve, enhancer, ex):
    """Phase 10, track 2's own inputs (D = 12): K1's at the first masked
    E+M pass (S and den vs plain at the headline tolerances, both timed),
    ``em_finalize`` on them (relative floor, vs the plain finalize), and
    the MVDR solve's input (513 x 12 x 12) by the relative-mode inverse
    (:func:`mvdr_vs_plain`), and the WPE solve's R and P of the first
    iteration (d = 120, E = 12), by K5 and its plain version (float64
    residuals: <= 2x plain + 1e-6)."""
    import numpy as np
    from pb_chime5_tpu_torch.ops import linalg
    from tests.test_torch_fused_em_cuda import scatter_errors
    inputs = capture_k1_inputs(enhancer, ex)
    z, _, act, fm = inputs
    F, T, D = z.shape
    K = act.shape[0]
    S, den = fused_em.fused_em_scatter(*inputs)
    torch.cuda.synchronize()
    S_ref, den_ref = fused_em.fused_em_scatter_reference(*inputs)
    rel_S, rel_den, max_abs = scatter_errors(S, den, S_ref, den_ref)
    print(f'K1 on track 2 (first masked pass): F={F}, T={T}, D={D}, K={K}: '
          f'vs plain rel_S {rel_S:.3e} (<= {S_RTOL}), rel_den '
          f'{rel_den:.3e} (<= {DEN_RTOL}), max_abs {max_abs:.3e}',
          flush=True)
    check(bool(torch.isfinite(S).all() and torch.isfinite(den).all()),
          'K1 output on track 2 is not finite')
    check(rel_S <= S_RTOL and rel_den <= DEN_RTOL,
          'K1 disagrees with its plain version on track 2')
    t = in_turns(torch, {
        'plain': (lambda: fused_em.fused_em_scatter_reference(*inputs), 2),
        'kernel': (lambda: fused_em.fused_em_scatter(*inputs), 10)})
    print_times(f'K1 on track 2 at F,T,D,K=({F}, {T}, {D}, {K})', t,
                *k1_bound(*inputs))
    check_finalize(torch, gj_inverse, S, den, 'relative',
                   "track 2's EM state")
    del S, den, S_ref, den_ref
    mvdr_vs_plain(torch, gj_inverse, capture_mvdr_input(enhancer, ex),
                  "track 2's MVDR input")

    R, P, kw = capture_solve_input(enhancer, ex)
    G = {'chol': chol_solve.hermitian_solve_chol(R, P, **kw),
         'chol_plain': chol_solve.hermitian_solve_chol_reference(R, P, **kw)}
    torch.cuda.synchronize()
    res = solve_residuals(torch, linalg, R, P, G, kw['relative_load'])
    d = (torch.linalg.matrix_norm(G['chol'] - G['chol_plain'])
         / torch.linalg.matrix_norm(G['chol_plain'])).cpu().numpy()
    print(f'K5 on track 2 (first WPE iteration): F={R.shape[0]}, '
          f'd={R.shape[1]}, E={P.shape[2]}; residual median / max: kernel '
          f'{np.median(res["chol"]):.3e} / {res["chol"].max():.3e}, plain '
          f'{np.median(res["chol_plain"]):.3e} / '
          f'{res["chol_plain"].max():.3e}; |G - G_plain| / |G_plain| max '
          f'{d.max():.3e}; bit-equal: '
          f'{bool(torch.equal(G["chol"], G["chol_plain"]))}', flush=True)
    check(bool(torch.isfinite(G['chol']).all()),
          'K5 output on track 2 is not finite')
    check(res['chol'].max() <= 2 * res['chol_plain'].max() + 1e-6,
          'hermitian_solve_chol has a larger residual than its plain '
          'version on track 2')


def chime6_track2(torch, counts, kernels, chime6_dir, rttm):
    """Phase 10, track 2: ``kaldi_run_rttm main`` at the factory defaults
    (``multiarray='outer_array_mics'``, D = 12, float64 eager reads);
    then K1, ``em_finalize``, the MVDR inverse and K5 on its own
    inputs."""
    import functools
    from pb_chime5_tpu_torch.models.enhancer_rttm import get_enhancer
    from pb_chime5_tpu_torch.scripts.kaldi_run_rttm import make_experiment
    kw = dict(database_rttm=str(rttm), activity_rttm=str(rttm),
              chime6_dir=str(chime6_dir))
    enhancer = get_enhancer(**kw)
    dataset = enhancer.get_dataset('S02')
    n = len(dataset)
    num_samples, channels = {}, set()
    read = upload = host = processed = 0
    for key in dataset.keys():      # the eager reads, as the pump makes them
        audio = dataset[key]['audio_data']
        num_samples[key] = dataset[key]['num_samples_orig']
        channels.add(audio.shape[0])
        host += audio.nbytes                        # float64 on the host
        read += audio.size * 2                      # from PCM16 files
        # uploaded as float32 (GssPipeline._normalize_obs), bucket-padded
        upload += 4 * audio.shape[0] * enhancer._pipeline.bucket_length(
            audio.shape[1])
        processed += audio.shape[1]
    check(all('_U06.-' in key for key in num_samples),
          f'track 2 example ids: {list(num_samples)[:3]}')
    work = chime6_dir.parent / 'rttm_out'
    p = cli_pass(torch, counts, make_experiment,
                 ['session_id=S02', f'chime6_dir={chime6_dir}',
                  f'database_rttm={rttm}'], work, n)
    print(f'track 2 launches: {p["launches"]}', flush=True)
    check_wavs(p['wavs'], num_samples, 'track 2')
    path_numbers('track 2', p, n, sum(num_samples.values()) / 16000,
                 processed / 16000, channels=sorted(channels),
                 read_mb=read / 1e6,
                 host_float64_mb=host / 1e6, upload_mb=upload / 1e6)
    ex = dataset[dataset.keys()[0]]
    rttm_kernels(torch, *kernels, enhancer, ex)
    card_vs_cpu_utterance(
        torch, functools.partial(get_enhancer, **kw),
        lambda e: e.get_dataset('S02')[ex['example_id']],
        f'track 2 utterance {ex["example_id"]}')
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return p['launches']


def chime6_paths(torch, counts, kernels, work):
    """Phase 10: the CHiME-6 entry points on the card; returns each
    track's launches."""
    start = time.perf_counter()
    db, chime6_dir, rttm = make_chime6_corpus(work / 'chime6')
    print(f'CHiME-6 corpus + DB JSON + RTTM: '
          f'{time.perf_counter() - start:.2f} s', flush=True)
    track1 = chime6_track1(torch, counts, db, work / 'chime6' / 'track1')
    torch.cuda.empty_cache()
    track2 = chime6_track2(torch, counts, kernels, chime6_dir, rttm)
    return track1, track2

# phase 11: the per-frequency ('xla') EM, float64 and the debug twin
XLA_CHUNK = 256               # em_chunk_size of the chunked EM
XLA_VS_K1_EM = dict(iterations=2, iterations_post=0)
XLA_VS_K1_ATOL = 3e-2         # PARITY.md's stress leg (2 + 0 EM)
CHUNK_F64_ATOL = 1e-6         # chunked vs unfused posteriors, float64
F64_SCENE_ATOL = 1e-6         # float64 small scene card vs CPU, of the peak
DEBUG_MASK_ATOL = 1e-6        # debug twin vs the 'xla' chain's masks
FRONT_END_ATOL = 1e-4         # from-mask beamformers card vs CPU, of the
#                               peak (complex128; GEV / LCMV in any dtype)
MASK_SHARE = 1e-3             # energy masks: share of entries card != CPU


def capture_em_input(enhancer, ex):
    """The (Y (F, T, D), activity (K, T), frame mask) that
    ``enhancer.enhance_example(ex)`` hands the EM (after WPE), captured by
    a one-shot wrapper of the call in ``models/gss.py``."""
    from pb_chime5_tpu_torch.models import gss
    real = gss.cacgmm_posteriors
    inputs = []

    def capture(Y, activity, **kw):
        inputs.append((Y.clone(), activity.clone(), kw['frame_mask']))
        return real(Y, activity, **kw)
    gss.cacgmm_posteriors = capture
    try:
        enhancer.enhance_example(ex)
    finally:
        gss.cacgmm_posteriors = real
    return inputs[0]


def em_run(torch, counts, Y, act, fm, **config):
    """One ``cacgmm_posteriors`` on the card: (posteriors, launches, ms,
    peak GiB above what was allocated before it)."""
    from pb_chime5_tpu_torch.ops.cacgmm import (
        CacgmmConfig, cacgmm_posteriors)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    start = time.perf_counter()
    out = cacgmm_posteriors(Y, act, config=CacgmmConfig(**config),
                            frame_mask=fm)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - start) * 1e3
    launches = {k: v for k, v in counts.read().items() if v}
    peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
    return out, launches, ms, peak


def xla_em_on_p06(torch, counts, enhancer, examples):
    """Phase 11.1-11.2: P06 through ``GssConfig(bss_em_backend='xla')``
    (float32, default config: launches, wall, stages), then the EMs on
    P06's WPE output: unfused and chunked, float32 and float64 (peaks,
    times, launches), the 'xla' masks against K1's at 2 + 0 and the
    chunked posteriors against the unfused ones in float64.  Returns the
    'xla' path's launches."""
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.gss import GssConfig
    ex = max(examples, key=observation_seconds)
    xla = dataclasses.replace(
        enhancer, gss_config=GssConfig(bss_em_backend='xla'))
    xla.enhance_example(ex)                   # warm-up
    torch.cuda.synchronize()
    counts.reset()
    start = time.perf_counter()
    x = xla.enhance_example(ex)
    wall = time.perf_counter() - start
    launches = counts.read()
    expected = {**dict.fromkeys(launches, 0),
                'gauss_jordan_inverse_and_logdet': EM_PASSES + MVDR_SOLVES,
                'wpe_statistics': WPE_ITERATIONS,
                'hermitian_solve_chol': WPE_ITERATIONS}
    print(f"'xla' EM path launches: {launches}", flush=True)
    check(launches == expected,
          f"'xla' EM path launches {launches}, expected {expected}")
    check_wav(ex, x)
    print(f"'xla' EM utterance {ex['example_id']}: wall {wall:.4f} s, "
          f"xRT observation {observation_seconds(ex) / wall:.3f}",
          flush=True)
    for label, e in [('default', enhancer), ('xla', xla)] * 2:
        print('stages', json.dumps({'utterance': ex['example_id'],
                                    'config': label,
                                    **stage_times(gss, e, ex)}), flush=True)

    Y, act, fm = capture_em_input(enhancer, ex)
    print(f'P06 EM input: Y {tuple(Y.shape)} {Y.dtype}, activity '
          f'{tuple(act.shape)}', flush=True)
    runs = {}
    for label, dtype, config in (
            ('K1 (fused)', torch.complex64, {}),
            ('xla', torch.complex64, dict(em_backend='xla')),
            ('xla chunked', torch.complex64,
             dict(em_backend='xla', em_chunk_size=XLA_CHUNK)),
            ('xla float64', torch.complex128, dict(em_backend='xla')),
            ('xla chunked float64', torch.complex128,
             dict(em_backend='xla', em_chunk_size=XLA_CHUNK))):
        em_run(torch, counts, Y.to(dtype), act, fm, **config)    # warm-up
        out, counted, ms, peak = em_run(torch, counts, Y.to(dtype), act, fm,
                                        **config)
        runs[label] = out
        print('EM run', json.dumps({'em': label, 'ms': ms, 'peak_gib': peak,
                                    'launches': counted}), flush=True)
        if label == 'xla':
            check(counted == {'gauss_jordan_inverse_and_logdet': EM_PASSES},
                  f"'xla' EM launches {counted}")
        if label == 'xla chunked':
            check(counted == {'gauss_jordan_inverse_and_logdet': 1,
                              'em_finalize': EM_PASSES - 1},
                  f'chunked EM launches {counted}')
        if dtype == torch.complex128:
            check(counted == {}, f'{label}: launches {counted}')
    err = float((runs['xla chunked float64'] - runs['xla float64']).abs()
                .max())
    print(f'chunked vs unfused EM, float64, P06: posteriors {err:.3e} '
          f'(<= {CHUNK_F64_ATOL})', flush=True)
    check(err <= CHUNK_F64_ATOL, 'the chunked EM disagrees with the '
                                 'unfused one in float64')
    short = {label: em_run(torch, counts, Y, act, fm, **XLA_VS_K1_EM,
                           **config)[0]
             for label, config in (('K1', {}),
                                   ('xla', dict(em_backend='xla')))}
    err = float((short['xla'] - short['K1']).abs().max())
    print(f"'xla' vs K1 EM masks at 2 + 0, P06: {err:.3e} "
          f'(<= {XLA_VS_K1_ATOL})', flush=True)
    check(err <= XLA_VS_K1_ATOL, "the 'xla' EM disagrees with K1's")
    f32_vs_f64 = float((runs['xla'].double() - runs['xla float64']).abs()
                       .max())
    print(f"'xla' EM float32 vs float64 at 20 + 1, P06: posteriors "
          f'{f32_vs_f64:.3e} (not gated)', flush=True)
    return launches, xla


def float64_solve_times(torch, linalg, chol_solve, enhancer, ex):
    """The complex128 WPE solve at d = 240 (P06's first WPE iteration's R
    and P, in complex128): the chosen route ``wpe.solve_floored``
    (``cholesky_ex`` + ``cholesky_solve``, the host reading which
    frequencies need JAX's floored panels), beside K5's plain version on
    every frequency (the floored panels, no host read), ``cholesky_ex`` +
    ``cholesky_solve`` alone and ``linalg.hermitian_solve``, in turns;
    residuals in float64 against cuSOLVER's."""
    from pb_chime5_tpu_torch.ops import wpe
    R, P, kw = capture_solve_input(enhancer, ex)
    R, P = R.to(torch.complex128), P.to(torch.complex128)
    load = kw['relative_load']
    _, As, Bs, _ = linalg.equilibrate(R, P, load)

    def library():
        return torch.cholesky_solve(Bs, torch.linalg.cholesky_ex(As)[0])
    fns = {'solve_floored (chosen)': (lambda: wpe.solve_floored(
               R, P, relative_load=load), 5),
           'panels': (lambda: chol_solve.hermitian_solve_chol_reference(
               R, P, relative_load=load), 2),
           'cholesky_ex + cholesky_solve': (library, 5),
           'linalg.hermitian_solve': (lambda: linalg.hermitian_solve(
               R, P, relative_load=load), 5)}
    times = in_turns(torch, fns, rounds=1)
    G = {name: fns[name][0]() for name in ('solve_floored (chosen)',
                                           'panels')}
    G['cuSOLVER'] = linalg.hermitian_solve(R, P, relative_load=load)
    res = {k: float(v.max()) for k, v in solve_residuals(
        torch, linalg, R, P, G, load).items()}
    print('complex128 WPE solve at d = 240', json.dumps({
        'shape': list(R.shape), 'E': P.shape[-1], 'ms': times,
        'max_residual': res}), flush=True)
    check(max(res['solve_floored (chosen)'], res['panels'])
          <= 2 * res['cuSOLVER'] + 1e-9,
          "the float64 WPE solve has a larger residual than cuSOLVER's")


def float64_enhancer(torch, counts, db, examples, enhancer32):
    """Phase 11.3: ``get_enhancer(compute_dtype=np.float64)`` on phase 4's
    corpus: P06's wall, stages, no kernel launch, float64 vs float32
    output; the small scene card vs CPU in float64 at the default EM."""
    import numpy as np
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.models.gss import GssConfig
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            compute_dtype=np.float64, device='cuda')
    ex = max(examples, key=observation_seconds)
    enhancer.enhance_example(ex)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    start = time.perf_counter()
    x = enhancer.enhance_example(ex)
    wall = time.perf_counter() - start
    launches = counts.read()
    print(f'float64 path launches: {launches}', flush=True)
    check(not any(launches.values()), f'float64 launched kernels: '
                                      f'{launches}')
    check_wav(ex, x)
    x32 = enhancer32.enhance_example(ex)
    err = np.abs(x - x32).max() / np.abs(x).max()
    print(f"float64 utterance {ex['example_id']}: wall {wall:.4f} s, xRT "
          f"observation {observation_seconds(ex) / wall:.3f}, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB; float64 "
          f"vs float32 output {err:.3e} of the peak (not gated)", flush=True)
    print('stages', json.dumps({'utterance': ex['example_id'],
                                'config': 'float64',
                                **stage_times(gss, enhancer, ex)}),
          flush=True)
    card_vs_cpu(torch, GssConfig(), 'float64, default EM', dtype='float64',
                atol=F64_SCENE_ATOL)
    return launches


def float64_session(torch, counts, db, n, emitted_s, valid_s, work):
    """Phase 11.4: one ``enhance_session`` of phase 8's session in
    float64 with the session-audio cache on, after one warm-up utterance:
    wall, utterances a second, xRT, bytes, peak."""
    import numpy as np
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            compute_dtype=np.float64, device='cuda')
    first = list(enhancer.get_iterator('S02'))[0]
    enhancer.enhance_example(first)           # warm-up, direct
    p = session_pass(torch, counts, enhancer, n, work / 'float64',
                     expected={name: 0 for name in counts.read()})
    read_mb = p['moved_mb']
    print('float64 session pass', json.dumps({
        **{k: v for k, v in p.items() if k != 'stats'}, 'stats': p['stats'],
        'utterances': n, 'utterances_per_s': n / p['wall_s'],
        'xrt_emitted': emitted_s / p['wall_s'],
        'xrt_processed': valid_s / p['wall_s'],
        'read_mb': read_mb, 'upload_mb': read_mb}), flush=True)
    check(p['stats']['direct'] == 0, f'float64 session: {p["stats"]}')


def float64_quality(torch, scenes, float32_medians):
    """Phase 11.5: phase 9's scenes in float64 at 10 and 20 + 1 EM
    iterations: finite output (gated), medians over GATED_SEEDS printed
    beside the float32 ones (not gated)."""
    import numpy as np
    from tests.test_torch_realistic_scene import chain_quality, medians
    for label, config in QUALITY_CONFIGS:
        start = time.perf_counter()
        per_seed = {seed: chain_quality(scene, 'cuda', dtype=np.float64,
                                        **config)
                    for seed, scene in zip(QUALITY_SEEDS, scenes)}
        for seed, q in per_seed.items():
            print('quality float64', json.dumps(
                {'config': label, 'seed': seed, **q}), flush=True)
        print('quality medians float64', json.dumps({
            'config': label,
            f'seeds {list(GATED_SEEDS)}': medians(
                {s: per_seed[s] for s in GATED_SEEDS}),
            f'float32 seeds {list(GATED_SEEDS)}': float32_medians[label],
            f'seeds {list(QUALITY_SEEDS)}': medians(per_seed),
            'gated': False, 'seconds': time.perf_counter() - start}),
              flush=True)


def debug_on_p06(torch, counts, enhancer, xla, examples):
    """Phase 11.6: ``Enhancer.debug_example`` on P06 (float32): the four
    statistics' shapes and ranges, and its masks against the 'xla'
    chain's (the same unfused EM) on the same observation."""
    import numpy as np
    ex = max(examples, key=observation_seconds)
    counts.reset()
    debug = enhancer.debug_example(ex)
    launches = {k: v for k, v in counts.read().items() if v}
    reference_array, obs = xla._prepare_example(ex)
    act, target, start_cf, end_cf = xla._device_args(
        xla._example_activity(ex, reference_array), ex['speaker_id'], ex)
    _, masks = xla._pipeline(obs, act, target,
                             start_context_frames=start_cf,
                             end_context_frames=end_cf, return_masks=True)
    K = debug['masks'].shape[0]
    shapes = {k: list(debug[k].shape) for k in (
        'weights', 'logdet', 'condition', 'posterior_entropy')}
    weight_err = float(np.abs(debug['weights'].sum(-1) - 1).max())
    cond_min = float(debug['condition'].min())
    ent = debug['posterior_entropy']
    mask_err = float(np.abs(debug['masks'] - masks).max())
    print('debug_example', json.dumps({
        'utterance': ex['example_id'], 'shapes': shapes,
        'launches': launches, 'weights_sum_err': weight_err,
        'condition_min': cond_min, 'entropy_range': [float(ent.min()),
                                                     float(ent.max())],
        'masks_vs_xla': mask_err}), flush=True)
    check(shapes['weights'] == [EM_PASSES, 513, K]
          and shapes['posterior_entropy'] == [EM_PASSES, 513],
          f'debug statistics shapes {shapes}')
    check(weight_err <= 1e-5 and cond_min >= 0.99 and ent.min() >= 0
          and ent.max() <= np.log(K) + 1e-5,
          'the debug statistics are out of range')
    check(mask_err <= DEBUG_MASK_ATOL,
          f"debug masks differ from the 'xla' chain's by {mask_err:.3e}")
    check(np.isfinite(debug['x_hat']).all(), 'debug x_hat is not finite')


def mask_front_ends(torch):
    """Phase 11.7: the energy masks and the from-mask beamformers on the
    small scene's STFT, card vs CPU: the masks' share of differing
    entries; the three beamformers (on the same masks) and the two
    unsupervised MVDR wrappers within FRONT_END_ATOL of the peak in
    complex128, and in complex64 (MVDR on the Gauss-Jordan kernel; GEV
    and LCMV in float64 either way) within SCENE_ATOL, the gate of every
    float32 chain here: without BAN, float32 MVDR on the quantile masks'
    noise PSD (its condition printed) moves with the summation order."""
    import numpy as np
    from pb_chime5_tpu_torch.ops import beamform as bf
    from pb_chime5_tpu_torch.ops import masks
    from pb_chime5_tpu_torch.ops.stft import stft
    obs, _, _ = small_scene()
    Y64 = stft(torch.from_numpy(obs.astype(np.float64)), 1024, 256)
    shares, errs = {}, {}
    for dtype, Y in (('complex128', Y64), ('complex64', Y64.to(
            torch.complex64))):
        for name, fn in (
                ('lorenz_mask', lambda y: masks.lorenz_mask(
                    y.transpose(-2, -1)).transpose(-2, -1)),
                ('quantile_mask', lambda y: torch.stack(masks.quantile_mask(
                    y, [0.1, -0.8], axis=-2)))):
            cpu, card = fn(Y), fn(Y.cuda()).cpu()
            shares[f'{name} {dtype}'] = float((cpu != card).double().mean())
        x_mask = masks.lorenz_mask(Y.transpose(-2, -1)).transpose(-2, -1)
        i_mask = masks.quantile_mask(Y, -0.5, sensor_axis=0, axis=-2)
        calls = {
            'beamform_mvdr_souden_from_masks': (x_mask, 1 - x_mask),
            'beamform_gev_from_masks': (x_mask, 1 - x_mask),
            'beamform_lcmv_from_masks': (x_mask, i_mask, 1 - x_mask),
            'beamform_mvdr_souden_with_lorenz_mask': (),
            'beamform_mvdr_souden_with_quantile_mask': ()}
        for name, args in calls.items():
            fn = getattr(bf, name)
            cpu = fn(Y, *args).numpy()
            card = fn(Y.cuda(), *(a.cuda() for a in args)).cpu().numpy()
            errs[f'{name} {dtype}'] = float(np.abs(card - cpu).max()
                                            / np.abs(cpu).max())
    _, n_mask = masks.quantile_mask(Y64, [0.1, -0.8], axis=-2)
    cov_n = bf.psd_matrix(bf._to_fdt(Y64), bf.condense_mask(n_mask))
    print('mask front-ends, card vs CPU', json.dumps({
        'mask_share_differing': shares, 'of_the_peak': errs,
        'quantile_noise_psd_condition_max': float(
            torch.linalg.cond(cov_n).max())}), flush=True)
    check(all(v <= MASK_SHARE for v in shares.values()),
          f'energy masks differ card vs CPU: {shares}')
    check(all(v <= (FRONT_END_ATOL if k.endswith('complex128')
                    or 'gev' in k or 'lcmv' in k else SCENE_ATOL)
              for k, v in errs.items()),
          f'from-mask beamformers differ card vs CPU: {errs}')


def xla_float64_paths(torch, counts, chol_solve, db, examples, session,
                      scenes, float32_medians, work):
    """Phase 11 on phase 4's corpus (``db``, ``examples``), phase 8's
    ``session`` and phase 9's ``scenes``; returns the launches of the
    'xla' path and the float64 path."""
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.ops import linalg
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            device='cuda')
    xla_launches, xla = xla_em_on_p06(torch, counts, enhancer, examples)
    torch.cuda.empty_cache()
    float64_solve_times(torch, linalg, chol_solve, enhancer,
                        max(examples, key=observation_seconds))
    torch.cuda.empty_cache()
    f64_launches = float64_enhancer(torch, counts, db, examples, enhancer)
    torch.cuda.empty_cache()
    float64_session(torch, counts, *session[:4], work)
    torch.cuda.empty_cache()
    float64_quality(torch, scenes, float32_medians)
    debug_on_p06(torch, counts, enhancer, xla, examples)
    mask_front_ends(torch)
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return xla_launches, f64_launches



# phase 12: the parallel session paths
MESH_ROWS = (1, 4)            # utterances_per_device of the batched passes
# the depth of phase 12's session: its first 60 utterances (of 100, in the
# iterator's speaker order, so they span the whole 420 s), to keep the
# phase near 90 s; the width (6 x 4 channels, the default config) is not cut
MESH_SESSION_UTTERANCES = 60
MESH_DEVIATION = 1e-2         # B = 4 vs serial, share of the peak (chain gate)
FREQ_DEVIATION = 1e-3         # tests/test_parallel.py's pin for freq sharding
FREQ_UTTERANCES = 4
WORKER_TIMEOUT = 300
WARMUP_PROBE = r'''
import json, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from pb_chime5_tpu_torch.models.enhancer import get_enhancer
from pb_chime5_tpu_torch.ops.kernels import _build
enhancer = get_enhancer(multiarray=True, database_path=sys.argv[2],
                        device='cuda')
list(enhancer.get_iterator('S02'))      # the DB and the activity, untimed
enhancer.activity['S02']
start = time.perf_counter()
if sys.argv[4] == 'warm':
    enhancer.warmup('S02')
torch.cuda.synchronize()
warmup_s = time.perf_counter() - start
before = dict(_build.stats)
libraries = sorted(_build._libraries)
start = time.perf_counter()
enhancer.enhance_session(['S02'], sys.argv[3], dataset_slice=1,
                         audio_dir_exist_ok=True)
first_s = time.perf_counter() - start
loaded = {name.split('.')[0] for name in sys.modules}
print('WARMUP_PROBE', json.dumps({
    'warmup_s': warmup_s, 'first_utterance_s': first_s,
    'builds_loads_before': before, 'builds_loads_after': dict(_build.stats),
    'libraries_before': libraries,
    'imported_jax': bool(loaded & {'jax', 'pb_chime5_tpu'})}), flush=True)
'''


def wav_deviation(a, b):
    """The largest |x - y| / max|x| over the WAVs of output dirs ``a`` and
    ``b`` (the same names in both)."""
    import numpy as np
    from pb_chime5_tpu_torch.io import load_audio
    names = sorted(p.name for p in (a / 'dev').glob('*.wav'))
    check(names and names == sorted(p.name for p in (b / 'dev').glob('*.wav')),
          f'{a} and {b} hold other WAVs')
    worst = 0.0
    for name in names:
        x, y = load_audio(a / 'dev' / name), load_audio(b / 'dev' / name)
        check(x.shape == y.shape and np.isfinite(y).all(),
              f'{name}: {y.shape} against {x.shape}, or not finite')
        worst = max(worst, float(np.abs(x - y).max() / np.abs(x).max()))
    return worst


@contextlib.contextmanager
def counted_batches():
    """Counts the batches the mesh session loop dispatches (calls of the
    batch driver's two entries into ``parallel/mesh.py``)."""
    from pb_chime5_tpu_torch.parallel import batch_driver
    names = ('sharded_gss_enhance', 'sharded_gss_enhance_cached')
    real = {name: getattr(batch_driver, name) for name in names}
    count = [0]

    def counted(fn):
        def wrapper(*args, **kw):
            count[0] += 1
            return fn(*args, **kw)
        return wrapper
    for name in names:
        setattr(batch_driver, name, counted(real[name]))
    try:
        yield count
    finally:
        for name in names:
            setattr(batch_driver, name, real[name])


def mesh_pass(torch, counts, enhancer, n, out, mesh, rows, numbers):
    """One ``enhance_session(mesh=..., utterances_per_device=rows)`` of the
    whole session: wall, batches, launches (gated: 20 / 20 / 1 / 3 / 3 a
    batch, nothing else), peak memory; ``numbers`` (emitted and processed
    seconds) for the rates."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    with counted_batches() as batches:
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            enhancer.enhance_session(['S02'], out, audio_dir_exist_ok=True,
                                     dataset_slice=n, mesh=mesh,
                                     utterances_per_device=rows)
        wall = time.perf_counter() - start
    launches = counts.read()
    nb = batches[0]
    expected = expected_launches(launches, nb)
    check(launches == expected,
          f'mesh pass (B = {rows}): launches {launches} for {nb} batches, '
          f'expected {expected}')
    check(len(list((out / 'dev').glob('*.wav'))) == n,
          f'mesh pass (B = {rows}) wrote other than {n} WAVs')
    emitted_s, valid_s = numbers
    return dict(wall_s=wall, batches=nb, utterances_per_s=n / wall,
                xrt_emitted=emitted_s / wall, xrt_processed=valid_s / wall,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches_per_batch={k: v / nb for k, v in launches.items()
                                    if v}), launches


def capture_batched_k1(enhancer, mesh, rows, out, pass_index=1):
    """K1's inputs at E+M pass ``pass_index`` (1: the first masked one) of
    the first batch of ``rows`` utterances that the mesh loop dispatches
    (a one-shot wrapper of the entry ``ops/cacgmm.py`` calls)."""
    from pb_chime5_tpu_torch.ops import cacgmm
    real = cacgmm.fused_em_scatter
    seen = []

    def capture(z, params, act, fm):
        if act.dim() == 3 and act.shape[0] == rows:
            seen.append((z.clone(), tuple(p.clone() for p in params),
                         act.clone(), fm.clone())
                        if len(seen) == pass_index else None)
        return real(z, params, act, fm)
    cacgmm.fused_em_scatter = capture
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            enhancer.enhance_session(['S02'], out, audio_dir_exist_ok=True,
                                     dataset_slice=rows, mesh=mesh,
                                     utterances_per_device=rows)
    finally:
        cacgmm.fused_em_scatter = real
    check(len(seen) == EM_PASSES, f'{len(seen)} batched E+M passes, '
          f'expected {EM_PASSES}')
    return seen[pass_index]


def batched_k1(torch, fused_em, inputs):
    """K1's batched entry on a batch's real inputs against its plain
    version (the headline gates), timed in turns beside its bound."""
    from tests.test_torch_fused_em_cuda import scatter_errors
    z, params, act, fm = inputs
    before = fused_em.fused_em_scatter.launches
    S, den = fused_em.fused_em_scatter(z, params, act, fm)
    torch.cuda.synchronize()
    check(fused_em.fused_em_scatter.launches == before + 1,
          'the batched entry did not count its one launch')
    S_ref, den_ref = fused_em.fused_em_scatter_reference(z, params, act, fm)
    rel_S, rel_den, max_abs = scatter_errors(S, den, S_ref, den_ref)
    B = act.shape[0]
    print(f'fused_em batched (B = {B}, {z.shape[0]} rows, T = {z.shape[1]}'
          f'): rel_S {rel_S:.3e} (<= {S_RTOL}), rel_den {rel_den:.3e} '
          f'(<= {DEN_RTOL}), max_abs {max_abs:.3e}', flush=True)
    check(bool(torch.isfinite(S).all() and torch.isfinite(den).all())
          and rel_S <= S_RTOL and rel_den <= DEN_RTOL,
          'the batched entry disagrees with its plain version')
    del S, den, S_ref, den_ref
    t = in_turns(torch, {
        'plain': (lambda: fused_em.fused_em_scatter_reference(*inputs), 1),
        'kernel': (lambda: fused_em.fused_em_scatter(*inputs), 5)})
    bound_ms, bound_by = k1_bound(*inputs)
    print_times(f'fused_em batched B = {B}', t, bound_ms, bound_by)
    return dict(max_abs_err=max_abs, ms=t['kernel'], plain_ms=t['plain'],
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by)


def union_of(spans):
    """Disjoint sorted [lo, hi] intervals covering ``spans``."""
    union = []
    for lo, hi in sorted(spans):
        if union and lo <= union[-1][1]:
            union[-1][1] = max(union[-1][1], hi)
        else:
            union.append([lo, hi])
    return union


def idle_attribution(device_spans, host_ops, span):
    """The device's idle time inside the trace's ``span`` (start, end), and
    who had the host meanwhile: ``device_spans`` [(start, end)] of the
    device events, ``host_ops`` [(name, start, end)] of host ops (us) ->
    (idle ms, of which ms before the first device event, {op: idle ms
    while it ran, the largest first, and under 'no host op' the idle time
    in which no op ran: Python and NumPy})."""
    import bisect
    union = union_of(device_spans)
    starts = [lo for lo, _ in union]

    def idle_in(lo, hi):
        covered = 0.0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(union) and union[i][0] < hi:
            covered += max(0.0, min(hi, union[i][1]) - max(lo, union[i][0]))
            i += 1
        return (hi - lo) - covered
    idle_us = idle_in(*span)
    lead_us = (union[0][0] - span[0]) if union else idle_us
    by_op = {}
    for name, lo, hi in host_ops:
        by_op[name] = by_op.get(name, 0.0) + idle_in(lo, hi) / 1e3
    held = sum(idle_in(lo, hi)
               for lo, hi in union_of((lo, hi) for _, lo, hi in host_ops))
    by_op['no host op'] = (idle_us - held) / 1e3
    return idle_us / 1e3, lead_us / 1e3, dict(sorted(
        ((k, v) for k, v in by_op.items() if v > 0), key=lambda kv: -kv[1]))


def profiled_window(torch, fn):
    """``fn`` under ``torch.profiler``: the device busy share of its wall
    (the union of the intervals of its CUDA kernels, copies and sets over
    the wall; None where the trace shows no device event), {runtime call:
    count} of the calls that make the host wait for the card, the wall and
    the trace's span, and :func:`idle_attribution` of the trace at two
    levels: by top-level host op (``fn``'s ``record_function`` labels) and
    by the ops those call."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        pass                                  # the profiler's first start
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    events = prof.events()
    device = torch.autograd.DeviceType.CUDA
    spans = [(e.time_range.start, e.time_range.end)
             for e in events if e.device_type == device]
    host = [e for e in events if e.device_type != device]
    level = {1: [], 2: []}
    for e in host:
        depth = 1 if e.cpu_parent is None else (
            2 if e.cpu_parent.cpu_parent is None else 0)
        if depth:
            level[depth].append((e.name, e.time_range.start,
                                 e.time_range.end))
    busy_us = sum(hi - lo for lo, hi in union_of(spans))
    first = min((e.time_range.start for e in events), default=0)
    last = max((e.time_range.end for e in events), default=0)
    idle_ms, lead_ms, by_call = idle_attribution(spans, level[1],
                                                 (first, last))
    _, _, by_op = idle_attribution(spans, level[2], (first, last))

    def top(d):
        return {name: round(ms, 3) for name, ms in list(d.items())[:6]}
    return dict(
        busy=None if not spans else round(busy_us / wall_us, 4),
        host_waits={e.key: e.count for e in prof.key_averages()
                    if e.key in ('cudaStreamSynchronize',
                                 'cudaDeviceSynchronize',
                                 'cudaEventSynchronize')},
        wall_ms=round(wall_us / 1e3, 3),
        device_idle_of_wall_ms=round((wall_us - busy_us) / 1e3, 3),
        trace_span_ms=round((last - first) / 1e3, 3),
        device_idle_in_span_ms=round(idle_ms, 3),
        before_first_device_event_ms=round(lead_ms, 3),
        idle_by_call_ms=top(by_call), idle_by_op_ms=top(by_op))


def dispatch_windows(torch, enhancer, mesh, examples):
    """The device's busy share while the host enqueues ``examples``, their
    audio read beforehand: one ``GssPipeline.dispatch`` each (serial), and
    their batches of 4 (``BatchDispatcher`` on ``mesh``), each window warm
    and profiled: the host waits in it by runtime call, and the device's
    idle time by the host call and op that held the host meanwhile."""
    from pb_chime5_tpu_torch.parallel.batch_driver import BatchDispatcher
    pipeline = enhancer._pipeline
    label = torch.profiler.record_function
    rows = []
    for ex in examples:
        reference_array, obs = enhancer._prepare_example(ex)
        act, target, start_cf, end_cf = enhancer._device_args(
            enhancer._example_activity(ex, reference_array),
            ex['speaker_id'], ex)
        rows.append((obs, act, target, dict(start_context_frames=start_cf,
                                            end_context_frames=end_cf)))

    def serial():
        handles = []
        for o, a, t, kw in rows:
            with label('GssPipeline.dispatch'):
                handles.append(pipeline.dispatch(o, a, t, **kw))
        for handle in handles:
            with label('GssPipeline.gather'):
                pipeline.gather(handle)

    def batched():
        dispatcher = BatchDispatcher(mesh, pipeline, utterances_per_device=4)
        batches = []
        for o, a, t, kw in rows:
            with label('BatchDispatcher.add'):
                batches.append(dispatcher.add(o, a, t, **kw))
        with label('BatchDispatcher.flush'):
            batches += dispatcher.flush()
        for batch in [b for b in batches if b is not None]:
            with label('DispatchedBatch.gather'):
                list(batch.gather())
    for name, fn in (('serial', serial), ('mesh (1, 1), B = 4', batched)):
        fn()                                                  # warm
        reading = profiled_window(torch, fn)
        print(f'dispatch window, {len(rows)} utterances, {name} '
              f'{json.dumps(reading)}', flush=True)


def parallel_sessions(torch, counts, fused_em, session, work):
    """Phase 12.1-12.2: phase 8's session (its first
    MESH_SESSION_UTTERANCES) through the mesh loop on one card (B = 1 and
    B = 4 rows a batch, in turns with the serial loop), K1's batched entry
    on the first B = 4 batch, a profiled window, and frequency sharding
    over two slots of the card; returns the B = 4 pass's launches and
    K1's batched numbers."""
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.parallel import make_mesh
    db = session[0]
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            device='cuda')
    examples = list(enhancer.get_iterator('S02'))[:MESH_SESSION_UTTERANCES]
    n = len(examples)
    emitted_s = sum(ex['num_samples_orig']['observation'][
        ex['reference_array']] for ex in examples) / 16000
    valid_s = observation_bytes(get_enhancer(
        multiarray=True, database_path=str(db), device='cuda',
        device_audio_cache=False), examples)[2]
    print(f'phase 12 session: the first {n} utterances of S02, '
          f'{emitted_s:.3f} s emitted, {valid_s:.3f} s processed',
          flush=True)
    mesh = make_mesh(1, 1)
    out = work / 'mesh'
    passes = []
    for i, mode in enumerate(('serial', 1, 4, 4, 1, 'serial')):
        if mode == 'serial':
            p = session_pass(torch, counts, enhancer, n, out / f'{i}',
                             dataset_slice=n)
            p = dict(wall_s=p['wall_s'], utterances_per_s=n / p['wall_s'],
                     xrt_emitted=emitted_s / p['wall_s'],
                     xrt_processed=valid_s / p['wall_s'],
                     peak_gib=p['peak_gib'], outside_chains=p[
                         'outside_chains'])
        else:
            p, launches = mesh_pass(torch, counts, enhancer, n,
                                    out / f'{i}', mesh, mode,
                                    (emitted_s, valid_s))
            if mode == 4:
                mesh_launches = launches
        p['mode'] = mode if mode == 'serial' else f'mesh (1, 1), B = {mode}'
        passes.append(p)
        print('mesh session pass', json.dumps({'pass': i, **p}), flush=True)
    for mode in ('serial', 1, 4):
        label = mode if mode == 'serial' else f'mesh (1, 1), B = {mode}'
        walls = [p['wall_s'] for p in passes if p['mode'] == label]
        print(f'session walls, {label}: {walls} s, median '
              f'{statistics.median(walls):.4f} s', flush=True)
    identical = same_wavs(out / '0', out / '1') and \
        same_wavs(out / '0', out / '4')
    deviation = max(wav_deviation(out / '0', out / '2'),
                    wav_deviation(out / '5', out / '3'))
    print(f'B = 1 WAVs byte-identical to the serial ones: {identical}; '
          f'B = 4 largest deviation from serial: {deviation:.3e} of the '
          f'peak (gate {MESH_DEVIATION})', flush=True)
    check(identical, 'the B = 1 mesh session wrote other WAVs than serial')
    check(deviation <= MESH_DEVIATION,
          f'B = 4 deviates from serial by {deviation:.3e} of the peak')

    k1 = batched_k1(torch, fused_em, capture_batched_k1(
        enhancer, mesh, 4, work / 'mesh_k1'))
    torch.cuda.empty_cache()
    dispatch_windows(torch, enhancer, mesh, examples[:8])
    torch.cuda.empty_cache()

    names = [torch.cuda.get_device_name(d) for d in (0, 0)]
    sharded = make_mesh(1, 2, devices=[torch.device('cuda', 0)] * 2)
    print(f'freq sharding: slots {sharded.devices[0]}, both {names[0]} '
          f'(one card: no multi-card speed is measured)', flush=True)
    for name, m in (('freq1', mesh), ('freq2', sharded)):
        torch.cuda.synchronize()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            enhancer.enhance_session(['S02'], out / name,
                                     audio_dir_exist_ok=True,
                                     dataset_slice=FREQ_UTTERANCES, mesh=m)
        print(f'{name}: {FREQ_UTTERANCES} utterances in '
              f'{time.perf_counter() - start:.4f} s', flush=True)
    deviation = wav_deviation(out / 'freq1', out / 'freq2')
    print(f'freq = 2 against freq = 1: {deviation:.3e} of the peak (gate '
          f'{FREQ_DEVIATION})', flush=True)
    check(deviation <= FREQ_DEVIATION,
          f'freq sharding deviates by {deviation:.3e} of the peak')
    return mesh_launches, k1


def run_workers(commands, label):
    """Start every (argv, env) at once, wait for all (killing them past
    WORKER_TIMEOUT); returns their standard outputs."""
    import os
    procs = [subprocess.Popen(argv, env={**os.environ, **env}, cwd=REPO,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in commands]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WORKER_TIMEOUT)
            check(p.returncode == 0 and 'WORKER_OK' in out,
                  f'{label}: a worker failed ({p.returncode}):\n'
                  f'{out[-2000:]}\n{err[-3000:]}')
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def wav_hashes(audio_dir):
    import hashlib
    return {p.relative_to(audio_dir).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in Path(audio_dir).rglob('*.wav')}


def parallel_processes(torch, work, examples):
    """Phase 12.3-12.4: two ``PB_JOB_ID`` jobs and two gloo processes
    (``testing/mp_worker.py`` on cuda:0, default config, phase 4's
    corpus) against one serial worker; the first utterance of a fresh
    process with and without ``Enhancer.warmup``; ``fast_start`` on P06."""
    import dataclasses as dc
    import socket

    import numpy as np
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.models.gss import GssConfig
    from pb_chime5_tpu_torch.parallel.scheduler import length_balanced_shard
    db = work / 'chime5.json'
    root = work / 'workers'

    def worker(mode, audio, **options):
        argv = [sys.executable, '-m', 'pb_chime5_tpu_torch.testing.mp_worker',
                '--json-path', str(db), '--audio-dir', str(audio), '--mode',
                mode, '--device', 'cuda', '--config', 'default']
        for key, value in options.items():
            argv += ['--' + key.replace('_', '-'), str(value)]
        return argv

    env = {'PYTHONPATH': str(REPO)}
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            device='cuda')
    it = list(enhancer.get_iterator('S02'))

    def length(ex):
        ns = ex['num_samples']
        return ns['original'] if isinstance(ns, dict) else ns
    shares = [{ex['example_id'] for ex in length_balanced_shard(
        it, length, k, 2)} for k in range(2)]

    start = time.perf_counter()        # the serial worker beside the jobs
    outs = run_workers(
        [(worker('serial', root / 'serial'), env)]
        + [(worker('jobs', root / 'jobs'),
            {**env, 'PB_JOB_ID': str(job), 'PB_NUM_JOBS': '2'})
           for job in (1, 2)], 'serial worker and PB_JOB_ID jobs')[1:]
    serial = wav_hashes(root / 'serial')
    check(len(serial) == len(it), f'the serial worker wrote {len(serial)} '
                                  f'of {len(it)} WAVs')
    written = [{line.split()[1] for line in o.splitlines()
                if line.startswith('FINISHED')} for o in outs]
    jobs_ok = wav_hashes(root / 'jobs') == serial and written == shares
    print(f'two PB_JOB_ID jobs: {[len(w) for w in written]} utterances '
          f'(shares {[len(s) for s in shares]}) in '
          f'{time.perf_counter() - start:.2f} s; union byte-identical to '
          f'the serial run and each job its share: {jobs_ok}', flush=True)
    check(jobs_ok, 'the two jobs did not write the serial run, each its '
                   'length-balanced share once')

    with socket.socket() as s:
        s.bind(('localhost', 0))
        port = s.getsockname()[1]
    start = time.perf_counter()
    outs = run_workers(
        [(worker('distributed', root / 'gloo' / 'audio', rank=r, world=2,
                 coordinator=f'localhost:{port}', run_id=12), env)
         for r in range(2)], 'gloo processes')
    ids = [(root / 'gloo' / f'broadcast_{r}.txt').read_text()
           for r in range(2)]
    gloo_ok = wav_hashes(root / 'gloo' / 'audio') == serial \
        and ids == ['12', '12'] \
        and [o.count('FINISHED') for o in outs] == [len(s) for s in shares]
    print(f'two gloo processes: run ids {ids}, union byte-identical to the '
          f'serial run: {gloo_ok} ({time.perf_counter() - start:.2f} s)',
          flush=True)
    check(gloo_ok, 'the two gloo processes did not write the serial run')

    probes = {}
    for mode in ('cold', 'warm'):
        proc = subprocess.run(
            [sys.executable, '-c', WARMUP_PROBE, str(REPO), str(db),
             str(root / f'first_{mode}'), mode], cwd=REPO,
            capture_output=True, text=True, timeout=WORKER_TIMEOUT)
        lines = [line for line in proc.stdout.splitlines()
                 if line.startswith('WARMUP_PROBE ')]
        check(proc.returncode == 0 and lines,
              f'warmup probe ({mode}) failed:\n{proc.stderr[-3000:]}')
        probes[mode] = json.loads(lines[-1].split(' ', 1)[1])
        print(f'fresh process, {mode}', json.dumps(probes[mode]), flush=True)
    warm = probes['warm']
    check(warm['builds_loads_after'] == warm['builds_loads_before']
          and not warm['imported_jax'],
          f'a build or library load after warmup: {warm}')
    check(set(LIBRARIES + HOST_LIBRARIES) <= set(warm['libraries_before']),
          f'warmup left a kernel or host library unloaded: {warm}')
    check(same_wavs(root / 'first_cold', root / 'first_warm'),
          'the warmed first utterance differs from the cold one')
    print(f'first utterance of a fresh process: '
          f'{probes["cold"]["first_utterance_s"]:.4f} s cold, '
          f'{warm["first_utterance_s"]:.4f} s after a '
          f'{warm["warmup_s"]:.4f} s warmup', flush=True)

    ex = max(examples, key=observation_seconds)
    split = dc.replace(enhancer, gss_config=GssConfig(
        compile_mode='fast_start'))
    x_fused = enhancer.enhance_example(ex)
    x_split = split.enhance_example(ex)
    check(np.array_equal(x_fused, x_split),
          'fast_start differs from the fused chain on P06')
    print(f'fast_start on {ex["example_id"]}: bit-equal to the fused chain',
          flush=True)


def parallel_paths(torch, counts, fused_em, session, work, examples):
    """Phase 12: the parallel session paths on the card; returns the
    launches of the B = 4 mesh pass and K1's batched numbers."""
    mesh_launches, k1 = parallel_sessions(torch, counts, fused_em, session,
                                          work)
    torch.cuda.empty_cache()
    parallel_processes(torch, work, examples)
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return mesh_launches, k1


# phase 13: the alignment-refined activity, the session soak, the dry run
# and the tooling.  The refined path's depth is cut to phase 8's first 20
# utterances (of 100) to keep the phase near 100 s; the width (6 x 4
# channels, the default config) is not
REFINED_UTTERANCES = 20
# the refined utterance's card-vs-CPU run at one WPE iteration (and phase
# 10's 2-iteration EM): at three, its CPU leg took 71 s of the phase
CARD_VS_CPU_WPE = 1
SOAK_UTTERANCES = {'serial': 1000, 'mesh (1, 1)': 400}
SOAK_WINDOW = 100             # utterances a window of the flatness gate
DRYRUN_SLOTS = (4, 8)
TRACE_UTTERANCES = 2


def expected_soak_launches(launches, n, bss_iterations=2):
    """The soak's launches for ``n`` utterances (``wpe=False``, a
    ``bss_iterations`` + 1 EM): K1 and ``em_finalize`` each EM pass, the
    MVDR inverse once, no WPE solve."""
    return {**dict.fromkeys(launches, 0),
            'fused_em_scatter': bss_iterations * n,
            'em_finalize': bss_iterations * n,
            'gauss_jordan_inverse_and_logdet': n}


def pickle_times(path):
    """(MB, load s, write s) of one activity pickle."""
    import pickle
    start = time.perf_counter()
    with open(path, 'rb') as fd:
        data = pickle.load(fd)
    load_s = time.perf_counter() - start
    start = time.perf_counter()
    with open(path.with_suffix('.again'), 'wb') as fd:
        pickle.dump(data, fd)
    return path.stat().st_size / 1e6, load_s, time.perf_counter() - start


def refined_activity(torch, counts, session, work):
    """Phase 13a: a fake Kaldi alignment of phase 8's worn utterances
    through the port's ``activity_alignment.main`` (a stub ``KALDI_ROOT``
    of ``testing/fake_kaldi.py``), then ``enhance_session`` over the first
    REFINED_UTTERANCES utterances with ``activity_type='path'`` on the
    annotation pickles, on the refined ones, and with
    ``activity_type='annotation'``; returns the refined pass's launches."""
    import functools
    import os
    import numpy as np
    from pb_chime5_tpu_torch import activity_alignment
    from pb_chime5_tpu_torch.database.chime5 import Chime5
    from pb_chime5_tpu_torch.io import load_audio
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.testing.fake_kaldi import (
        make_fake_kaldi_root, write_fake_alignment)
    db, n_session = session[0], session[1]
    raw = list(Chime5(db).get_datasets('S02'))
    phones = write_fake_alignment(work / 'ali', raw)
    before = os.environ.get('KALDI_ROOT')
    os.environ['KALDI_ROOT'] = str(make_fake_kaldi_root(work / 'kaldi'))
    try:
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            activity_alignment.main(db, work / 'activity', sessions=['S02'],
                                    worn_ali_path=work / 'ali')
        cli_s = time.perf_counter() - start
    finally:
        if before is None:
            del os.environ['KALDI_ROOT']
        else:
            os.environ['KALDI_ROOT'] = before
    kinds = ('annotation', 'word_non_sil_alignment')
    sizes = {kind: pickle_times(work / 'activity' / kind / 'S02.pkl')
             for kind in kinds}
    print('activity_alignment.main', json.dumps({
        'utterances': len(raw), 'aligned': len(phones), 'wall_s': cli_s,
        **{f'{kind}_pickle': dict(zip(('mb', 'load_s', 'write_s'), v))
           for kind, v in sizes.items()}}), flush=True)

    n = REFINED_UTTERANCES
    kw = dict(multiarray=True, database_path=str(db), device='cuda')
    factories = {
        'path, annotation pickles': functools.partial(
            get_enhancer, activity_type='path',
            activity_path=str(work / 'activity' / kinds[0]), **kw),
        'path, refined pickles': functools.partial(
            get_enhancer, activity_type='path',
            activity_path=str(work / 'activity' / kinds[1]), **kw),
        'annotation': functools.partial(get_enhancer, **kw)}
    examples = list(factories['annotation']().get_iterator('S02'))[:n]
    emitted_s = sum(ex['num_samples_orig']['observation'][
        ex['reference_array']] for ex in examples) / 16000
    valid_s = observation_bytes(factories['annotation'](
        device_audio_cache=False), examples)[2]
    out = work / 'refined'
    for label, factory in factories.items():
        p = session_pass(torch, counts, factory(), n, out / label,
                         dataset_slice=n)
        if label == 'path, refined pickles':
            launches = counts.read()
        print('refined activity pass', json.dumps({
            'activity': label, 'utterances': n, 'wall_s': p['wall_s'],
            'utterances_per_s': n / p['wall_s'],
            'xrt_emitted': emitted_s / p['wall_s'],
            'xrt_processed': valid_s / p['wall_s'],
            'outside_chains': p['outside_chains'], 'peak_gib': p['peak_gib'],
            'stats': p['stats']}), flush=True)
    identical = same_wavs(out / 'annotation', out / 'path, annotation pickles')
    names = sorted(w.name for w in (out / 'annotation' / 'dev').glob('*.wav'))
    deviation, changed = 0.0, 0
    for name in names:
        x = load_audio(out / 'path, refined pickles' / 'dev' / name)
        y = load_audio(out / 'annotation' / 'dev' / name)
        check(x.shape == y.shape and np.isfinite(x).all()
              and np.abs(x).max() > 0,
              f'refined {name}: not finite and non-silent, or not of the '
              f"annotation WAV's length")
        changed += not np.array_equal(x, y)
        deviation = max(deviation,
                        float(np.abs(x - y).max() / np.abs(y).max()))
    print(f"refined activity: annotation pickles byte-identical to "
          f"'annotation': {identical}; refined WAVs other than the "
          f'annotation ones: {changed} of {len(names)}, largest deviation '
          f'{deviation:.3e} of the peak; {n_session} utterances in the '
          f'session', flush=True)
    check(identical, "activity_type='path' on the annotation pickles wrote "
                     "other WAVs than activity_type='annotation'")
    check(changed == len(names) == n,
          f'{n - changed} refined WAVs equal the annotation ones')
    first = examples[0]['example_id']
    card_vs_cpu_utterance(
        torch, functools.partial(factories['path, refined pickles'],
                                 wpe_iterations=CARD_VS_CPU_WPE),
        lambda e: e.get_iterator('S02')[first],
        f'refined utterance {first}, {CARD_VS_CPU_WPE} WPE iteration')
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return launches


def session_soaks(torch, counts, work):
    """Phase 13b: ``testing/soak.py``'s ``run_session_soak`` on the card,
    serial over 1,000 utterances and on ``make_mesh(1, 1)`` over 400, at
    its defaults (1 array x 4 mics, no WPE, a 2 + 1 EM, a 45 s window):
    tests/test_session_soak.py's gates on the windowed wall, RSS and the
    cache, the launches, and the card's allocated memory after the first
    window within two of the cache's windows; returns the serial soak's
    launches."""
    import numpy as np
    from pb_chime5_tpu_torch.parallel import make_mesh
    from pb_chime5_tpu_torch.testing.soak import (
        run_session_soak, windowed_means)
    for label, n in SOAK_UTTERANCES.items():
        mesh = None if label == 'serial' else make_mesh(1, 1)
        counts.reset()
        start = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            r = run_session_soak(work / 'soak' / label, num_utterances=n,
                                 mesh=mesh, device='cuda')
        total_s = time.perf_counter() - start
        launches = counts.read()
        if label == 'serial':
            serial_launches = launches
        wm = windowed_means(r['deltas_s'], SOAK_WINDOW)
        steady = wm[1:]
        rss = [m for i, m in r['rss_mb'] if i >= SOAK_WINDOW]
        card = [m for i, m in r['device_mb'] if i >= SOAK_WINDOW]
        window_mb = r['cache']['refill_mb'] / max(r['cache']['refills'], 1)
        print(f'soak {label}', json.dumps({
            'utterances': n, 'wall_s': r['wall_s'],
            'with_corpus_s': total_s, 'span_s': r['span_s'],
            'utterances_per_s': n / r['wall_s'],
            'xrt_span': r['span_s'] / r['wall_s'],
            'windowed_ms': [round(1e3 * v, 3) for v in wm],
            'rss_mb': r['rss_mb'], 'device_mb': r['device_mb'],
            'cache': r['cache'], 'launches': launches}), flush=True)
        check(r['num_examples'] == r['num_wavs'] == n,
              f'soak {label}: {r["num_wavs"]} WAVs of {n}')
        check(launches == expected_soak_launches(launches, n),
              f'soak {label}: launches {launches}, expected '
              f'{expected_soak_launches(launches, n)}')
        flat = steady.max() / steady.min()
        if label == 'serial':
            check(steady[-1] / steady[0] < 1.6 and flat < 2.0,
                  f'soak {label}: windowed means {wm} not flat')
            check(rss[-1] - rss[0] < 120.0 and r['cache']['refills'] >= 5,
                  f'soak {label}: RSS {r["rss_mb"]}, cache {r["cache"]}')
        else:
            check(flat < 3.0 and rss[-1] - rss[0] < 450.0,
                  f'soak {label}: windowed means {wm}, RSS {r["rss_mb"]}')
        check(r['cache']['hits'] > 0.9 * n,
              f'soak {label}: cache {r["cache"]}')
        check(np.isfinite(card).all() and card[-1] - card[0]
              <= 2 * window_mb,
              f'soak {label}: allocated device memory {r["device_mb"]} '
              f'grew by more than two {window_mb:.3f} MB windows')
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return serial_launches


def dry_runs(torch, counts):
    """Phase 13c: ``dryrun.dryrun_multichip`` over DRYRUN_SLOTS slots of
    cuda:0 (its own gates: every utterance back, finite, cached bit-equal
    to direct); the launches: K1 and ``em_finalize`` twice (a 2 + 1 EM),
    the MVDR inverse and K2 (one WPE iteration) once per leg, data group
    and frequency shard, no WPE solve kernel (d = 8)."""
    from pb_chime5_tpu_torch.dryrun import dryrun_multichip
    counts.reset()
    expected = dict.fromkeys(counts.read(), 0)
    for slots in DRYRUN_SLOTS:
        start = time.perf_counter()
        dryrun_multichip(slots)
        torch.cuda.synchronize()
        print(f'dry run, {slots} slots of cuda:0 (data {slots // 2} x freq '
              f'2): cached bit-equal to direct, '
              f'{time.perf_counter() - start:.3f} s', flush=True)
        runs = 2 * (slots // 2) * 2           # legs x data groups x shards
        expected['fused_em_scatter'] += 2 * runs
        expected['em_finalize'] += 2 * runs
        expected['gauss_jordan_inverse_and_logdet'] += runs
        expected['wpe_statistics'] += runs
    launches = counts.read()
    check(launches == expected,
          f'dry runs: launches {launches}, expected {expected}')
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return launches


def tooling(torch, counts, session, db4, examples4, work):
    """Phase 13d: the first TRACE_UTTERANCES of phase 8's session through
    ``utils.profiling.trace`` (the trace file must name K1's kernel),
    ``StageTimer(sync=True)`` waiting for the card; the
    FLOP model's achieved TFLOP/s and MFU (fp32 peak) over P06's stage
    windows and over phase 8's cached median wall and stage windows."""
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.utils import flops, profiling
    db, n, _emitted_s, _valid_s, walls = session
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            device='cuda')
    with contextlib.redirect_stdout(io.StringIO()):
        with profiling.trace(work / 'trace') as prof:
            enhancer.enhance_session(['S02'], work / 'traced',
                                     dataset_slice=TRACE_UTTERANCES)
    trace_file = work / 'trace' / 'trace.json'
    events = json.loads(trace_file.read_text())['traceEvents']
    k1 = [e for e in events if 'fused_em_kernel' in e.get('name', '')
          and e.get('cat') == 'kernel']
    device_ms = sum(e.get('dur', 0) for e in k1) / 1e3
    print(f'profiling.trace of {TRACE_UTTERANCES} utterances: '
          f'{trace_file.stat().st_size / 1e6:.3f} MB, {len(events)} events, '
          f"{len(k1)} of K1's kernel ({device_ms:.3f} ms on the card), "
          f'{len(prof.key_averages())} ops and kernels', flush=True)
    check(len(k1) == EM_PASSES * TRACE_UTTERANCES,
          f'the trace names K1 {len(k1)} times, expected '
          f'{EM_PASSES * TRACE_UTTERANCES}')
    timer = profiling.StageTimer(sync=True)
    x = torch.ones(1 << 24, device='cuda')
    with timer('device_sync', result={'x': [x]}):
        x = x * 2
    check(torch.cuda.current_stream().query() and 'device_sync' in
          timer.totals(), 'StageTimer(sync=True) returned before the card')

    def dispatched_flops(enhancer, examples):
        """{stage: FLOPs} of each example's dispatch: its length bucket
        and channels, K = 5 (four speakers and the noise class)."""
        return [flops.gss_stage_flops(
            num_samples=enhancer._pipeline.bucket_length(
                min(ns for _, ns in reads)),
            D=sum(len(paths) for paths, _ in reads), K=5)
            for reads in array_reads(enhancer, examples)]

    p06_enhancer = get_enhancer(multiarray=True, database_path=str(db4),
                                device='cuda')
    p06 = max(examples4, key=observation_seconds)
    p06_enhancer.enhance_example(p06)                    # warm
    windows = stage_times(gss, p06_enhancer, p06)
    (stages,) = dispatched_flops(p06_enhancer, [p06])
    f_p06 = sum(stages.values())
    rate, share = flops.mfu(f_p06, windows['total_ms'] / 1e3)
    wpe = sum(v for k, v in stages.items() if k.startswith('wpe'))
    print('MFU P06', json.dumps({
        'utterance': p06['example_id'], 'tflop': f_p06 / 1e12,
        'stage_tflop': {k: v / 1e12 for k, v in stages.items()},
        'stage_windows_ms': windows, 'achieved_tflop_s': rate,
        'mfu': share, 'mfu_wpe': flops.mfu(wpe, windows['wpe_ms'] / 1e3)[1],
        'mfu_em': flops.mfu(stages['em'], windows['em_ms'] / 1e3)[1],
        'peak_tflop_s': flops.H100_FP32_PEAK_TFLOPS}), flush=True)
    total = sum(sum(f.values()) for f in dispatched_flops(
        enhancer, list(enhancer.get_iterator('S02'))))
    for label, seconds in (('median cached wall', walls['wall_s']),
                           ('median stage windows', walls['chain_s'])):
        rate, share = flops.mfu(total, seconds)
        print('MFU phase 8 session', json.dumps({
            'over': label, 'seconds': seconds, 'utterances': n,
            'tflop': total / 1e12, 'achieved_tflop_s': rate, 'mfu': share}),
            flush=True)
    check(not imported_jax(), 'the run imported jax or the JAX package')


def slice13_paths(torch, counts, session, db4, examples4, work):
    """Phase 13; returns the launches of the refined path, the serial soak
    and the dry runs."""
    refined = refined_activity(torch, counts, session, work / 'aa')
    torch.cuda.empty_cache()
    soak = session_soaks(torch, counts, work)
    torch.cuda.empty_cache()
    dry = dry_runs(torch, counts)
    torch.cuda.empty_cache()
    tooling(torch, counts, session, db4, examples4, work)
    return refined, soak, dry


# phase 14: the float32 WPE statistics at a production length (the stress
# scene, where one float32 sum over all T left R indefinite past the load)

def float64_statistics(torch, Y_tilde, Y, w, block=64):
    """R, P in complex128 from the same inputs, 64 frequencies at a time."""
    Rs, Ps = [], []
    for f0 in range(0, Y_tilde.shape[0], block):
        a = Y_tilde[f0:f0 + block].to(torch.complex128)
        aw = a * w[f0:f0 + block, None, :].double()
        Rs.append(aw @ a.conj().transpose(-2, -1))
        Ps.append(aw @ Y[f0:f0 + block].to(torch.complex128)
                  .conj().transpose(-2, -1))
    return torch.cat(Rs), torch.cat(Ps)


def stress_statistics(torch, captured, label):
    """The gates on the second WPE iteration's statistics of one route."""
    from pb_chime5_tpu_torch.ops.linalg import equilibrate
    (Y_tilde, Y, w), (R, P) = captured
    R64, P64 = float64_statistics(torch, Y_tilde, Y, w)
    Rh = R.to(torch.complex128)
    Rh = (Rh + Rh.conj().transpose(-2, -1)) / 2
    err_R = (torch.linalg.matrix_norm(Rh - R64)
             / torch.linalg.matrix_norm(R64))
    err_P = (torch.linalg.matrix_norm(P.to(torch.complex128) - P64)
             / torch.linalg.matrix_norm(P64))
    eig = torch.linalg.eigvalsh(equilibrate(Rh, Rh[..., :1])[0]).amin(-1)
    margin = eig + WPE_LOAD
    reading = dict(route=label, err_R_max=float(err_R.max()),
                   err_R_at_12_68_93=[float(err_R[f]) for f in (12, 68, 93)],
                   err_P_max=float(err_P.max()),
                   eig_plus_load_min=float(margin.min()),
                   eig_at_12_68_93=[float(eig[f]) for f in (12, 68, 93)])
    print('stress statistics', json.dumps(reading), flush=True)
    check(float(err_R.max()) <= STRESS_RTOL
          and float(err_P.max()) <= STRESS_RTOL,
          f'{label}: the stress scene\'s statistics lie past {STRESS_RTOL} '
          f'of float64 sums: {reading}')
    check(bool((margin > 0).all()),
          f'{label}: the equilibrated R falls past the load at '
          f'{int((margin <= 0).sum())} frequencies: {reading}')
    return reading


def stress_wpe_path(torch, counts, wpe_stats, p06_wpe_ms):
    """Phase 14; returns the launches of each route's run."""
    import numpy as np
    from pb_chime5_tpu_torch.models.gss import (
        GssConfig, _stft_and_mask, _wpe_stage)
    from pb_chime5_tpu_torch.ops import wpe
    from tests.test_torch_kernels_cuda import stats_errors
    from tests.test_torch_stress_headline import make_production_scene
    obs, _, _ = make_production_scene(np.random.default_rng(0))
    obs = torch.from_numpy(obs.astype(np.float32)).cuda()
    launches = {}
    for label, name, config in (
            ('xla', 'wpe_statistics_reference',
             GssConfig(wpe_stats_backend='xla')),
            ('K2', 'wpe_statistics', GssConfig())):
        O, fm, _ = _stft_and_mask(obs, None, config)
        real = getattr(wpe, name)
        captured = []

        def stats(Y_tilde, Y, w):
            out = real(Y_tilde, Y, w)
            if len(captured) == 1:       # the second iteration
                captured.append(((Y_tilde, Y, w.clone()), out))
            else:
                captured.append(None)
            return out
        setattr(wpe, name, stats)
        try:
            counts.reset()
            X = _wpe_stage(O, config, fm)
            torch.cuda.synchronize()
            launches[label] = counts.read()
        finally:
            setattr(wpe, name, real)
        print(f'stress WPE ({label}) launches: {launches[label]}',
              flush=True)
        expected = {**dict.fromkeys(launches[label], 0),
                    'hermitian_solve_chol': WPE_ITERATIONS}
        if label == 'K2':
            expected['wpe_statistics'] = WPE_ITERATIONS
        check(launches[label] == expected,
              f'stress WPE ({label}) launches {launches[label]}, expected '
              f'{expected}')
        finite = torch.isfinite(X.reshape(X.shape[0], -1)).all(dim=1)
        check(bool(finite.all()),
              f'stress WPE ({label}): not finite at frequencies '
              f'{torch.nonzero(~finite).flatten().tolist()[:20]}')
        stress_statistics(torch, captured[1], label)
        (Y_tilde, Y, w), _ = captured[1]
        if label == 'K2':
            rel_R, rel_P, max_abs = stats_errors(
                *wpe_stats.wpe_statistics(Y_tilde, Y, w),
                *wpe_stats.wpe_statistics_reference(Y_tilde, Y, w))
            print(f'stress K2 vs plain: rel_R {rel_R:.3e}, rel_P '
                  f'{rel_P:.3e} (<= {STATS_RTOL}), max_abs {max_abs:.3e}',
                  flush=True)
            check(rel_R <= STATS_RTOL and rel_P <= STATS_RTOL,
                  'K2 disagrees with its plain version on the stress scene')
        window_ms = cuda_ms(torch, lambda: _wpe_stage(O, config, fm), 1)
        call_ms = cuda_ms(torch, lambda: real(Y_tilde, Y, w), 2)
        print(f'stress WPE ({label}) at D = 24, T = {O.shape[-1]}: window '
              f'{window_ms:.3f} ms, statistics call {call_ms:.3f} ms',
              flush=True)
        del O, fm, X, captured, Y_tilde, Y, w
        torch.cuda.empty_cache()
    print(f'P06 WPE windows (phase 5, ms): {json.dumps(p06_wpe_ms)}',
          flush=True)
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return launches


# phase 15: the native host readers
HOST_TURNS = ('native', 'Python', 'Python', 'native')
INTERVAL_OPS = ('_intersection', '_non_intersection', '_normalize',
                '_str_to_intervals')


def host_builds(_build, out):
    """Each host library compiled anew from the port's source into
    ``out``, one after the other -> {name: seconds}."""
    import ctypes
    out.mkdir(parents=True)
    seconds = {}
    for name in HOST_LIBRARIES:
        lib = out / f'lib{name}.so'
        start = time.perf_counter()
        proc = subprocess.run(_build.compile_command(name, lib),
                              capture_output=True, text=True, timeout=300)
        seconds[name] = time.perf_counter() - start
        check(proc.returncode == 0,
              f'{name}: the host build failed:\n{proc.stdout}{proc.stderr}')
        ctypes.CDLL(str(lib))
        print(f'host build of csrc/{name}.cpp: {seconds[name]:.3f} s',
              flush=True)
    return seconds


def read_turns(audio, reads):
    """Both read routes over every utterance's span: gated byte for byte,
    then timed in turns -> {route: [seconds of each pass]}, bytes a
    pass."""
    routes = {'native': audio._read, 'Python': audio._py_read}
    nbytes = 0
    for spans in reads:
        for path, s, e in spans:
            (a, rate_a), (b, rate_b) = (routes[r](path, s, e)
                                        for r in ('native', 'Python'))
            check(a.dtype == b.dtype and a.shape == b.shape
                  and a.tobytes() == b.tobytes() and rate_a == rate_b,
                  f'{path} [{s}, {e}): the native read differs from the '
                  f'Python read')
            nbytes += a.nbytes
    seconds = {route: [] for route in routes}
    for route in HOST_TURNS:
        start = time.perf_counter()
        for spans in reads:
            for path, s, e in spans:
                routes[route](path, s, e)
        seconds[route].append(time.perf_counter() - start)
    return seconds, nbytes


def activity_by_route(ai_module, db, examples, route):
    """The session's activity as the enhancer builds it (annotations, and
    alignment-style boolean spans: sil over each utterance's first and
    last tenth), each utterance's slices and the tracks' pickles, with
    ``utils/array_interval.py``'s ops on ``route`` -> (results, {op:
    [calls, seconds]}, wall)."""
    import pickle
    import numpy as np
    from pb_chime5_tpu_torch.activity import get_activity
    from pb_chime5_tpu_torch.database.chime5 import Chime5

    def aligned(ex, mic):
        n = ex['end']['observation'][mic] - ex['start']['observation'][mic]
        mask = np.ones(n, bool)
        mask[:n // 10] = mask[n - n // 10:] = False
        return mask
    spent = {op: [0, 0.0] for op in INTERVAL_OPS}

    def timed(op, fn):
        def call(*args):
            start = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[op][0] += 1
                spent[op][1] += time.perf_counter() - start
        return call
    saved = {op: getattr(ai_module, op) for op in INTERVAL_OPS}
    results = {}
    try:
        for op in INTERVAL_OPS:
            setattr(ai_module, op, timed(op, saved[op] if route == 'native'
                                         else getattr(ai_module, f'_py{op}')))
        start = time.perf_counter()
        for label, fn in (('annotation', None), ('aligned', aligned)):
            activity = get_activity(
                Chime5(db).get_datasets('S02'), perspective='array',
                garbage_class=True, non_sil_alignment_fn=fn)['S02']
            tracks = {(a, k): t for a, per in activity.items()
                      for k, t in per.items()}
            slices = []
            for ex in examples:
                ref = ex['reference_array']
                s, e = ex['start']['observation'][ref], \
                    ex['end']['observation'][ref]
                slices += [t[s:min(e, len(t))]
                           for t in activity[ref].values()]
            reloaded = {key: pickle.loads(pickle.dumps(t))
                        for key, t in tracks.items()}
            results[label] = (
                {key: t.intervals for key, t in tracks.items()}, slices,
                {key: t.intervals for key, t in reloaded.items()})
        wall = time.perf_counter() - start
    finally:
        for op, fn in saved.items():
            setattr(ai_module, op, fn)
    return results, spent, wall


def same_activity(a, b):
    """Two routes' ``activity_by_route`` results hold the same tracks,
    slices and reloaded pickles."""
    import numpy as np
    return a.keys() == b.keys() and all(
        a[k][0] == b[k][0] == a[k][2] == b[k][2]
        and len(a[k][1]) == len(b[k][1])
        and all(np.array_equal(x, y) for x, y in zip(a[k][1], b[k][1]))
        for k in a)


def host_readers_path(db, work):
    """Phase 15; returns the host libraries' JSON record."""
    from pb_chime5_tpu_torch.io import audio
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.ops.kernels import _build
    from pb_chime5_tpu_torch.utils import array_interval
    build_s = host_builds(_build, work / 'host_build')
    _build.load_libraries(HOST_LIBRARIES)    # loaded in phase 2 already
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            device='cuda')
    examples = list(enhancer.get_iterator('S02'))
    # every utterance's observation span as the session reads it
    reads = [[(path, s, e) for paths, s, e, _sel in enhancer._cache_spans(
        ex, ex['reference_array']) for path in paths] for ex in examples]
    seconds, nbytes = read_turns(audio, reads)
    n, files = len(reads), sum(len(spans) for spans in reads)
    read = {}
    for route, passes in seconds.items():
        read[route] = {'pass_s': passes,
                       'ms_per_utterance': statistics.mean(passes) / n * 1e3,
                       'mb_per_s': nbytes / statistics.mean(passes) / 1e6}
        print(f'observation reads ({route}): {n} utterances, {files} file '
              f'spans, {nbytes / 1e6:.2f} MB a pass; '
              f'{json.dumps(read[route])}', flush=True)
    ratio = statistics.mean(seconds['native']) / statistics.mean(
        seconds['Python'])
    print(f'native / Python read time: {ratio:.4f}', flush=True)

    runs = {route: [] for route in ('native', 'Python')}
    for route in HOST_TURNS:
        runs[route].append(activity_by_route(array_interval, db, examples,
                                             route))
    check(same_activity(runs['native'][0][0], runs['Python'][0][0]),
          'the native interval ops built another activity than the Python '
          'ones')
    ops = {}
    for route, passes in runs.items():
        ops[route] = {op: {
            'calls': passes[0][1][op][0],
            'us_per_call': statistics.mean(
                p[1][op][1] / max(p[1][op][0], 1) for p in passes) * 1e6}
            for op in INTERVAL_OPS}
        print(f'interval ops ({route}): walls {[p[2] for p in passes]} s; '
              f'{json.dumps(ops[route])}', flush=True)
    check(not imported_jax(), 'the run imported jax or the JAX package')
    return [
        {'name': 'wav_ops', 'source': 'pb_chime5_tpu_torch/csrc/wav_ops.cpp',
         'replaces': 'cpp/wav_ops.cpp', 'build_s': build_s['wav_ops'],
         'reads': read, 'bytes_per_pass': nbytes},
        {'name': 'interval_ops',
         'source': 'pb_chime5_tpu_torch/csrc/interval_ops.cpp',
         'replaces': 'cpp/interval_ops.cpp',
         'build_s': build_s['interval_ops'], 'ops': ops,
         'activity_wall_s': {route: [p[2] for p in passes]
                             for route, passes in runs.items()}}]


class LaunchCounts:
    """The launch counters of every kernel entry of the port."""

    def __init__(self, fused_em, wpe_stats, gj_inverse, chol_solve):
        self.entries = (fused_em.fused_em_scatter,
                        wpe_stats.wpe_statistics,
                        gj_inverse.em_finalize,
                        gj_inverse.gauss_jordan_inverse_and_logdet,
                        gj_inverse.hermitian_inverse_and_logdet_2d,
                        gj_inverse.hermitian_inverse_and_logdet,
                        chol_solve.hermitian_solve_chol,
                        chol_solve.chol_solve_real_spd,
                        chol_solve.hermitian_solve_pallas)

    def reset(self):
        for entry in self.entries:
            entry.launches = 0

    def read(self):
        return {entry.__name__: entry.launches for entry in self.entries}


def build(_build):
    """Phase 2: one nvcc per source, all started together."""
    import ctypes
    start = time.perf_counter()
    _build.load_libraries(LIBRARIES + HOST_LIBRARIES)
    print(f'build + load of {", ".join(LIBRARIES + HOST_LIBRARIES)}: '
          f'{time.perf_counter() - start:.3f} s', flush=True)
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    resources = _build.kernel_entry('wpe_stats', 'pb_wpe_statistics_resources',
                                    (ctypes.c_void_p, ctypes.c_void_p))
    _build.check_launch(resources(ctypes.addressof(smem),
                                  ctypes.addressof(ctas)), 'wpe_stats')
    print(f'wpe_stats: wpe_stats_kernel: {smem.value} bytes of dynamic '
          f'shared memory a CTA, {ctas.value} CTAs per SM', flush=True)
    for name in LIBRARIES:
        kernel = None          # ptxas resources per kernel instantiation
        for line in _build.build_log(name).splitlines():
            if 'Compiling entry' in line:
                m = re.search(r'\d([a-z][a-z_]*_kernel)(I(?:L[bi]\d+E)+E)?',
                              line)
                kernel = m[1] if m else line
                if m and m[2]:
                    kernel += '<' + ', '.join(
                        ('true' if v == '1' else 'false') if t == 'b' else v
                        for t, v in re.findall(r'L([bi])(\d+)E', m[2])) + '>'
            elif kernel and ('registers' in line or 'spill' in line):
                print(f'{name}: {kernel}: {line.split(":", 1)[-1].strip()}',
                      flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('chip_smoke: torch.cuda.is_available() is False; this '
                 'smoke run needs one CUDA card')
    from pb_chime5_tpu_torch import _device
    from pb_chime5_tpu_torch.ops.kernels import (
        _build, chol_solve, fused_em, gj_inverse, wpe_stats)

    phase('1 device')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.get_device_name(0)}', flush=True)
    _device.assert_precision()

    phase('2 build')
    build(_build)

    phase('3 kernels vs plain')
    results = {'fused_em_scatter': k1_vs_plain(torch, fused_em),
               'wpe_statistics': k2_vs_plain(torch, wpe_stats),
               **gj_vs_plain(torch, gj_inverse),
               **k5_vs_plain(torch, chol_solve)}
    torch.cuda.empty_cache()

    counts = LaunchCounts(fused_em, wpe_stats, gj_inverse, chol_solve)
    (REPO / 'build').mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix='chip_smoke_', dir=REPO / 'build'))
    try:
        phase('4 default path')
        default_launches, enhancer, examples = default_path(
            torch, counts, work)
        phase('5 all-Pallas path')
        pallas_launches, p06_wpe_ms = all_pallas_path(
            torch, counts, enhancer, examples)
        torch.cuda.empty_cache()
        phase('6 K1, em_finalize and the MVDR inverse on the EM state, and '
              'the WPE systems, of P06')
        k1_on_p06(torch, fused_em, gj_inverse, enhancer, examples)
        results['gauss_jordan_inverse_and_logdet'] = mvdr_on_p06(
            torch, gj_inverse, enhancer, examples)
        torch.cuda.empty_cache()
        wpe_systems(torch, chol_solve, wpe_stats, enhancer, examples)
        torch.cuda.empty_cache()
        phase('7 options path')
        options_path(torch, counts, enhancer, examples)
        del enhancer
        torch.cuda.empty_cache()
        phase('8 session path, session-audio cache on and off')
        session = session_path(torch, counts, work)
        torch.cuda.empty_cache()
        phase('9 quality gate on the realistic scenes')
        scenes, float32_medians = quality_path(torch)
        torch.cuda.empty_cache()
        phase('10 the CHiME-6 paths: track 1 (kaldi_run chime6=True) and '
              'track 2 (kaldi_run_rttm)')
        track1_launches, track2_launches = chime6_paths(
            torch, counts, (fused_em, gj_inverse, chol_solve), work)
        torch.cuda.empty_cache()
        phase("11 the per-frequency ('xla') EM, float64 and the debug twin")
        xla_launches, f64_launches = xla_float64_paths(
            torch, counts, chol_solve, work / 'chime5.json', examples,
            session, scenes, float32_medians, work)
        torch.cuda.empty_cache()
        phase('12 the parallel session paths: the batched session, '
              'frequency sharding, two jobs and two processes, warmup')
        mesh_launches, k1_batched = parallel_paths(
            torch, counts, fused_em, session, work, examples)
        torch.cuda.empty_cache()
        phase('13 the alignment-refined activity, the session soak, the dry '
              'run and the tooling')
        refined_launches, soak_launches, dry_launches = slice13_paths(
            torch, counts, session, work / 'chime5.json', examples,
            work / 'slice13')
        torch.cuda.empty_cache()
        phase('14 the float32 WPE statistics on the stress scene (D = 24, '
              'T = 4191): the xla tiles and K2 (the default)')
        stress_launches = stress_wpe_path(torch, counts, wpe_stats,
                                          p06_wpe_ms)
        phase('15 the native host readers: segmented WAV reads and the '
              'interval algebra, native and Python')
        host_libraries = host_readers_path(session[0], work)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    def row(name, source, replaces, launches, numbers, on_main_path=True,
            **extra):
        entry = name.split(' ')[0]
        per_path = {'default': default_launches,
                    'all-Pallas': pallas_launches,
                    'CHiME-6 track 1': track1_launches,
                    'CHiME-6 track 2 (RTTM)': track2_launches,
                    "'xla' EM": xla_launches, 'float64': f64_launches,
                    'mesh': mesh_launches,
                    'alignment activity': refined_launches,
                    'soak': soak_launches, 'dry run': dry_launches,
                    'stress WPE, xla tiles': stress_launches['xla'],
                    'stress WPE, K2 (default)': stress_launches['K2']}
        return {'name': name, 'route': 'cuda',
                'source': f'pb_chime5_tpu_torch/csrc/{source}',
                'replaces': f'pb_chime5_tpu/ops/pallas/{replaces}',
                'launches': launches, **numbers,
                'on_main_path': on_main_path,
                'launches_per_path': {path: counted[entry] for path, counted
                                      in per_path.items()}, **extra}

    def entry(name, launches, path):
        return {**results[name], 'launches': launches, 'path': path}
    # K3 and K4 are one kernel (csrc/gj_inverse.cu) with floor modes.  Each
    # row's top-level numbers are its TPU kernel's own floor: K3's at its
    # call site, the EM finalize of bss_inverse='pallas_gj' (em_finalize,
    # floor 'flt_min'), K4's by its inverse-only entry.  `entries` holds the
    # kernel's other entries: K3's floor inverse only (the function of the
    # earlier rows), and the relative floor of the default path, the
    # finalize (K3's row) and the MVDR solve's inverse (K4's row)
    kernels = [
        # K1's row: the unbatched entry at the headline; under `entries`
        # the batched entry on the mesh path's first B = 4 batch
        row('fused_em_scatter', 'fused_em.cu', 'fused_em.py:59',
            default_launches['fused_em_scatter'],
            results['fused_em_scatter'],
            entries={'fused_em_scatter (batched, B = 4)': {
                **k1_batched, 'launches': mesh_launches['fused_em_scatter'],
                'path': 'mesh'}}),
        row('wpe_statistics', 'wpe_stats.cu', 'wpe_stats.py:54',
            default_launches['wpe_statistics'], results['wpe_statistics'],
            path='default'),
        row("em_finalize (floor='flt_min')", 'gj_inverse.cu',
            'gj_inverse2d.py:67', pallas_launches['em_finalize'],
            results['em_finalize_flt_min'], path='all-Pallas',
            entries={
                'hermitian_inverse_and_logdet_2d': entry(
                    'hermitian_inverse_and_logdet_2d',
                    pallas_launches['hermitian_inverse_and_logdet_2d'],
                    'all-Pallas'),
                "em_finalize (floor='relative')": entry(
                    'em_finalize_relative', default_launches['em_finalize'],
                    'default')}),
        # no GssConfig reaches K4's floor
        row('hermitian_inverse_and_logdet', 'gj_inverse.cu',
            'hermitian_inverse.py:34',
            default_launches['hermitian_inverse_and_logdet'],
            results['hermitian_inverse_and_logdet'], on_main_path=False,
            entries={'gauss_jordan_inverse_and_logdet': entry(
                'gauss_jordan_inverse_and_logdet',
                default_launches['gauss_jordan_inverse_and_logdet'],
                'default')}),
        # K5's row at its call site, the WPE solve: the complex
        # instantiation; the TPU kernel's own function (the real
        # instantiation) and its real-form wrapper under `entries`
        row('hermitian_solve_chol', 'chol_solve.cu', 'chol_solve.py:50',
            default_launches['hermitian_solve_chol'],
            results['hermitian_solve_chol'], path='default',
            entries={
                'chol_solve_real_spd': entry(
                    'chol_solve_real_spd',
                    default_launches['chol_solve_real_spd'], 'none'),
                'hermitian_solve_pallas': entry(
                    'hermitian_solve_pallas',
                    default_launches['hermitian_solve_pallas'], 'none')}),
    ]
    phase('done')
    print(json.dumps({'host_libraries': host_libraries}), flush=True)
    print(card, flush=True)
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
