"""Weighted prediction error (WPE) dereverberation — port of
``pb_chime5_tpu/ops/wpe.py``.

Iterative offline WPE batched over frequency:

* power ``lambda_t = mean_d |X_dt|^2``, optionally averaged over a
  +-``psd_context`` frame window (a zero-padded box sum divided by the
  number of frames the window holds, so the edge frames average fewer),
  then frame-masked and floored at ``1e-10 * max_t lambda``,
* stacked delayed observations ``Ytilde`` (F, taps * D, T),
* statistics ``R = hermitize((Ytilde w) Ytilde^H)``,
  ``P = (Ytilde w) Y^H``, summed over T in two levels: float32 sums over
  short spans of frames, added across spans in float64, rounded to
  complex64 once.  By default (``stats_backend='auto'`` or ``'xla'``)
  as complex ``torch.matmul`` over 256-frame tiles added into complex128
  (:func:`~pb_chime5_tpu_torch.ops.kernels.wpe_stats.wpe_statistics_reference`;
  cuBLAS, IEEE float32 — TF32 is pinned off, see ``_device.py`` — the JAX
  Pallas kernel's time tiles, with the cross-tile sum in float64); with
  ``stats_backend='pallas'`` in one launch of the statistics kernel
  (:func:`~pb_chime5_tpu_torch.ops.kernels.wpe_stats.wpe_statistics`:
  64-frame float32 spans into float64 registers), then hermitized, as
  the JAX ``'pallas'`` backend does.  One float32 sum over all T drifted
  4.75-5.97e-6 from the float64 sums on the stress scene (D = 24,
  T = 4191), and its second iteration's R fell past the 1e-4 load at 3
  frequencies, where the solve returned NaN; the tiles lie within
  8.6e-7 of them and the kernel's spans within 2.9e-7 (H100 80GB HBM3,
  ``chip_smoke.py`` phase 14),
* filter ``G = R^{-1} P`` by the equilibrated, diagonally loaded
  Hermitian solve with ``solve_refine`` iterative-refinement steps
  against the unloaded R: for complex64 with ``32 < taps * D <= 256``
  (the WPE headline, 240) in one launch of the blocked-Cholesky kernel
  (:func:`~pb_chime5_tpu_torch.ops.kernels.chol_solve.hermitian_solve_chol`,
  the JAX default ``method='chol'`` with its relative pivot floor; its
  plain version on the CPU); for complex128 with ``taps * D > 32``, and
  for complex64 with ``taps * D > 256``, by :func:`solve_floored`:
  ``cholesky_ex`` + ``cholesky_solve`` on the equilibrated, loaded
  system, and the frequencies where a pivot falls below JAX's floor
  ``eps^2 * max(diag)`` of the system's precision (a failed factorization
  included) solved again by K5's plain version (JAX's panels with the
  floor): never a raise; else (d <= 32)
  :func:`~pb_chime5_tpu_torch.ops.linalg.hermitian_solve` (Gauss-Jordan),
* output ``X = Y - G^H Ytilde``.

The rows are independent: a batch of B utterances runs as B * F rows,
with its frame mask given per row, (B * F, T).

``chunk_size`` accumulates R and P over T-chunks of that many frames
(into complex128, each chunk in the default route's tiles) and
applies the filter chunk by chunk, so the (F, taps * D, T) stack is never
materialized.  The chunked statistics are the complex matmuls for every
``stats_backend``: with 'pallas' the statistics kernel is not launched,
as the JAX package runs its XLA chunked statistics there; with 'auto'
the JAX package uses its real-form chunked staircase, the same sums in
another order.

The JAX main path computes the statistics in a real-form tap-group
staircase (``_real_form_stats``, ``stats_backend='real'``), a TPU
lane-padding layout that is not carried over: ``'real'`` raises.  The
JAX ``precision`` argument (bf16 passes of the TPU's MXU) has no
counterpart: the port computes in IEEE float32, and ``GssConfig``
rejects ``wpe_precision`` other than 'highest'.
"""

import torch

from pb_chime5_tpu_torch.ops.kernels import chol_solve
from pb_chime5_tpu_torch.ops.kernels.chol_solve import (
    BLOCK, hermitian_solve_chol, supports)
from pb_chime5_tpu_torch.ops.kernels.wpe_stats import (
    accumulate_statistics, wpe_statistics, wpe_statistics_reference)
from pb_chime5_tpu_torch.ops.linalg import (
    equilibrate, hermitize, hermitian_solve, stable_solve)

__all__ = ['wpe', 'build_y_tilde', 'get_power_inverse']


def build_y_tilde(Y, taps: int, delay: int):
    """Y (..., D, T) -> Ytilde (..., taps * D, T); row block ``tau`` holds
    ``Y_{t - delay - tau}``, zero before the start."""
    T = Y.shape[-1]
    parts = []
    for tau in range(taps):
        shift = delay + tau
        part = torch.zeros_like(Y)
        if shift < T:
            part[..., shift:] = Y[..., :T - shift]
        parts.append(part)
    return torch.cat(parts, dim=-2)


def get_power_inverse(X, psd_context: int = 0, frame_mask=None):
    """``1 / max(lambda, 1e-10 * max(lambda))`` with lambda averaged over
    +-``psd_context`` frames.  X (..., D, T) -> (..., T)."""
    power = (X.abs() ** 2).mean(dim=-2)
    if psd_context > 0:
        T = power.shape[-1]
        width = 2 * psd_context + 1
        padded = torch.nn.functional.pad(power, (psd_context, psd_context))
        t = torch.arange(T, device=power.device)
        counts = (torch.clamp_max(t + psd_context, T - 1)
                  - torch.clamp_min(t - psd_context, 0) + 1)
        power = padded.unfold(-1, width, 1).sum(dim=-1) / counts.to(
            power.dtype)
    if frame_mask is not None:
        power = power * frame_mask.to(power.dtype)
    floor = torch.clamp_min(1e-10 * power.amax(dim=-1, keepdim=True),
                            torch.finfo(power.dtype).tiny)
    return 1.0 / torch.maximum(power, floor)


def _frames(frame_mask):
    """A frame mask (T,) or per row (F, T) for a (F, d, T) tensor."""
    return frame_mask if frame_mask.dim() == 1 else frame_mask[:, None, :]


def solve_floored(A, B, *, relative_load, refine=0):
    """JAX's ``hermitian_solve(A, B, relative_load=..., method='chol',
    refine=...)`` for (F, d, d), (F, d, E) (complex128, or complex64 that
    K5 does not take), with the floor of A's precision: LAPACK / cuSOLVER's
    Cholesky where every pivot clears JAX's floor ``eps^2 * max(diag)``
    of the loaded, equilibrated matrix, else (for those frequencies only:
    the host reads which) the floored panels of
    ``chol_solve.hermitian_solve_chol_reference``."""
    As0, As, Bs, sinv = equilibrate(A, B, relative_load)
    L, info = torch.linalg.cholesky_ex(As)
    X = torch.cholesky_solve(Bs, L)
    for _ in range(refine):
        X = X + torch.cholesky_solve(Bs - As0 @ X, L)
    X = sinv[..., :, None] * X
    # the panels' floor: the largest diagonal entry of the matrix padded
    # to a multiple of BLOCK by an identity block
    maxdiag = torch.diagonal(As, dim1=-2, dim2=-1).real.amax(dim=-1)
    if A.shape[-1] % BLOCK:
        maxdiag = torch.clamp_min(maxdiag, 1.0)
    finfo = torch.finfo(maxdiag.dtype)
    floor = torch.clamp_min(maxdiag * finfo.eps ** 2, finfo.tiny)
    pivots = torch.diagonal(L, dim1=-2, dim2=-1).real ** 2
    bad = torch.nonzero((info != 0) | (pivots < floor[:, None]).any(dim=-1))
    if len(bad):
        f = bad[:, 0]
        X[f] = chol_solve.hermitian_solve_chol_reference(
            A[f], B[f], relative_load=relative_load, refine=refine)
    return X


def _solve_G(R, P, regularization, refine=0):
    if not regularization:
        return stable_solve(R, P)
    if R.dtype == torch.complex64 and supports(R.shape[-1], P.shape[-1]):
        return hermitian_solve_chol(R.contiguous(), P.contiguous(),
                                    relative_load=regularization,
                                    refine=refine)
    if R.shape[-1] > BLOCK:
        return solve_floored(R, P, relative_load=regularization,
                             refine=refine)
    return hermitian_solve(R, P, relative_load=regularization, refine=refine)


def _wpe_iteration(Y, Y_tilde, inv_power, regularization, stats_backend,
                   solve_refine=0):
    """One filter update.  Y (F, D, T), Y_tilde (F, taps*D, T),
    inv_power (F, T) -> X (F, D, T)."""
    stats = (wpe_statistics if stats_backend == 'pallas'
             else wpe_statistics_reference)
    R, P = stats(Y_tilde, Y, inv_power)
    G = _solve_G(hermitize(R), P, regularization, solve_refine)
    return Y - G.conj().transpose(-2, -1) @ Y_tilde


def _chunked_wpe_iteration(Y, inv_power, taps, delay, regularization,
                           chunk_size, frame_mask, solve_refine=0):
    """One filter update with R, P accumulated over T-chunks and the
    filter applied per chunk; the peak scratch is one (F, taps*D, chunk)
    block."""
    F, D, T = Y.shape
    hist = delay + taps - 1
    num_chunks = -(-T // chunk_size)
    pad = num_chunks * chunk_size - T
    Yp = torch.nn.functional.pad(Y, (hist, pad))
    wp = torch.nn.functional.pad(inv_power, (0, pad))
    fmp = (None if frame_mask is None else torch.nn.functional.pad(
        _frames(frame_mask).to(inv_power.dtype), (0, pad)))

    def chunk_tilde(start):
        """(F, taps*D, chunk) stacked delayed block from frame ``start``."""
        yt = torch.cat([Yp[..., start + hist - delay - tau:
                           start + hist - delay - tau + chunk_size]
                        for tau in range(taps)], dim=-2)
        if fmp is not None:
            yt = yt * fmp[..., start:start + chunk_size].to(yt.dtype)
        return yt

    dim = taps * D
    R = torch.zeros((F, dim, dim), dtype=torch.complex128, device=Y.device)
    P = torch.zeros((F, dim, D), dtype=torch.complex128, device=Y.device)
    for start in range(0, T + pad, chunk_size):
        accumulate_statistics(
            R, P, chunk_tilde(start),
            Yp[..., start + hist:start + hist + chunk_size],
            wp[:, start:start + chunk_size])
    G = _solve_G(hermitize(R.to(Y.dtype)), P.to(Y.dtype), regularization,
                 solve_refine)
    Gh = G.conj().transpose(-2, -1)
    tail = torch.cat([Gh @ chunk_tilde(start)
                      for start in range(0, T + pad, chunk_size)], dim=-1)
    return Y - tail[..., :T]


def wpe(Y, *, taps: int = 10, delay: int = 2, iterations: int = 3,
        psd_context: int = 0, regularization: float = 1e-4,
        chunk_size: int = None, frame_mask=None,
        stats_backend: str = 'auto', solve_refine: int = 0):
    """Batched offline WPE.  Y (F, D, T) complex -> dereverberated
    (F, D, T); ``regularization=0`` solves with :func:`stable_solve`
    (reference-exact in float64); ``frame_mask`` (T,) bool, or per row
    (F, T), excludes padded frames from the statistics and zeroes them in
    the output.
    ``stats_backend``: 'auto' / 'xla' (complex matmuls) or 'pallas' (the
    statistics kernel; complex64 only; not with ``chunk_size``); 'real'
    is not ported.  ``solve_refine`` iterative-refinement steps on the
    filter solve (see ``linalg.hermitian_solve``)."""
    if stats_backend == 'real':
        raise NotImplementedError(
            "stats_backend='real' (the TPU tap-group staircase) is not "
            "ported; 'auto' computes the same statistics")
    if stats_backend not in ('auto', 'xla', 'pallas'):
        raise ValueError(f'unknown stats_backend {stats_backend!r}')
    if chunk_size is not None:
        X = Y
        for _ in range(iterations):
            X = _chunked_wpe_iteration(
                Y, get_power_inverse(X, psd_context, frame_mask), taps,
                delay, regularization, chunk_size, frame_mask, solve_refine)
    else:
        if stats_backend == 'pallas':
            Y = Y.contiguous()          # the kernel reads (F, D, T) rows
        Y_tilde = build_y_tilde(Y, taps, delay)
        if frame_mask is not None:
            Y_tilde = Y_tilde * _frames(frame_mask).to(Y_tilde.dtype)
        X = Y
        for _ in range(iterations):
            X = _wpe_iteration(Y, Y_tilde,
                               get_power_inverse(X, psd_context, frame_mask),
                               regularization, stats_backend, solve_refine)
    if frame_mask is not None:
        X = X * _frames(frame_mask).to(X.dtype)
    return X
