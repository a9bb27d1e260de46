"""Weighted prediction error (WPE) dereverberation — port of the main
path of ``pb_chime5_tpu/ops/wpe.py``.

Iterative offline WPE batched over frequency:

* power ``lambda_t = mean_d |X_dt|^2`` (frame-masked), floored at
  ``1e-10 * max_t lambda``,
* stacked delayed observations ``Ytilde`` (F, taps * D, T),
* statistics ``R = hermitize((Ytilde w) Ytilde^H)``,
  ``P = (Ytilde w) Y^H``: by default (``stats_backend='auto'`` or
  ``'xla'``, the JAX ``'xla'`` formulation) as complex ``torch.matmul``
  (:func:`~pb_chime5_tpu_torch.ops.kernels.wpe_stats.wpe_statistics_reference`;
  cuBLAS, IEEE float32 — TF32 is pinned off, see ``_device.py``); with
  ``stats_backend='pallas'`` in one launch of the statistics kernel
  (:func:`~pb_chime5_tpu_torch.ops.kernels.wpe_stats.wpe_statistics`),
  then hermitized, as the JAX ``'pallas'`` backend does,
* filter ``G = R^{-1} P`` by the equilibrated, diagonally loaded
  :func:`~pb_chime5_tpu_torch.ops.linalg.hermitian_solve`,
* output ``X = Y - G^H Ytilde``.

The JAX main path computes the same statistics in a real-form tap-group
staircase (``_real_form_stats``, ``stats_backend='real'``), a TPU
lane-padding layout that is not carried over: ``'real'`` raises.  Other
options outside the main path (``psd_context > 0``, ``chunk_size``,
reduced precision, iterative refinement) are not ported yet (ROADMAP.md,
Queue 1): ``GssConfig`` rejects them.
"""

import torch

from pb_chime5_tpu_torch.ops.kernels.wpe_stats import (
    wpe_statistics, wpe_statistics_reference)
from pb_chime5_tpu_torch.ops.linalg import (
    hermitize, hermitian_solve, stable_solve)

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


def get_power_inverse(X, frame_mask=None):
    """``1 / max(lambda, 1e-10 * max(lambda))``.  X (..., D, T) -> (..., T)."""
    power = (X.abs() ** 2).mean(dim=-2)
    if frame_mask is not None:
        power = power * frame_mask.to(power.dtype)
    floor = torch.clamp_min(1e-10 * power.amax(dim=-1, keepdim=True),
                            torch.finfo(power.dtype).tiny)
    return 1.0 / torch.maximum(power, floor)


def _solve_G(R, P, regularization):
    if regularization:
        return hermitian_solve(R, P, relative_load=regularization)
    return stable_solve(R, P)


def _wpe_iteration(Y, Y_tilde, inv_power, regularization, stats_backend):
    """One filter update.  Y (F, D, T), Y_tilde (F, taps*D, T),
    inv_power (F, T) -> X (F, D, T)."""
    stats = (wpe_statistics if stats_backend == 'pallas'
             else wpe_statistics_reference)
    R, P = stats(Y_tilde, Y, inv_power)
    G = _solve_G(hermitize(R), P, regularization)
    return Y - G.conj().transpose(-2, -1) @ Y_tilde


def wpe(Y, *, taps: int = 10, delay: int = 2, iterations: int = 3,
        regularization: float = 1e-4, frame_mask=None,
        stats_backend: str = 'auto'):
    """Batched offline WPE.  Y (F, D, T) complex -> dereverberated
    (F, D, T); ``regularization=0`` solves with :func:`stable_solve`
    (reference-exact in float64); ``frame_mask`` (T,) bool excludes padded
    frames from the statistics and zeroes them in the output.
    ``stats_backend``: 'auto' / 'xla' (complex matmuls) or 'pallas' (the
    statistics kernel; complex64 only); 'real' is not ported."""
    if stats_backend == 'real':
        raise NotImplementedError(
            "stats_backend='real' (the TPU tap-group staircase) is not "
            "ported; 'auto' computes the same statistics")
    if stats_backend not in ('auto', 'xla', 'pallas'):
        raise ValueError(f'unknown stats_backend {stats_backend!r}')
    if stats_backend == 'pallas':
        Y = Y.contiguous()          # the kernel reads (F, D, T) rows
    Y_tilde = build_y_tilde(Y, taps, delay)
    if frame_mask is not None:
        Y_tilde = Y_tilde * frame_mask.to(Y_tilde.dtype)
    X = Y
    for _ in range(iterations):
        inv_power = get_power_inverse(X, frame_mask)
        X = _wpe_iteration(Y, Y_tilde, inv_power, regularization,
                           stats_backend)
    if frame_mask is not None:
        X = X * frame_mask.to(X.dtype)
    return X
