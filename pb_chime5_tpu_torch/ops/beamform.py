"""Mask-based beamforming — port of the beamformers of
``pb_chime5_tpu/ops/beamform.py``.

Masked PSD matrices, MVDR in the Souden formulation with the SNR-optimal
global reference channel, GEV (the dominant generalized eigenvector of
(Phi_X, Phi_N), by repeated squaring of Phi_N^{-1} Phi_X), LCMV with a
target and an interference constraint, blind analytic normalization
(BAN) and the beamformer apply.  Shapes: Y (F, D, T), masks (F, T),
vectors (F, D), output (F, T).  The reference channel is picked with
``torch.argmax`` and plain indexing; the JAX one-hot reductions were a
TPU-runtime workaround.  The from-masks entry points and the mask
estimators (``ops/masks.py``) are not ported yet (ROADMAP.md, Queue 1).
"""

import torch

from pb_chime5_tpu_torch.ops.kernels.gj_inverse import (
    MAX_D, hermitian_solve_gj)
from pb_chime5_tpu_torch.ops.linalg import (
    dominant_eigenvector, hermitian_solve, hermitize)

__all__ = ['psd_matrix', 'mvdr_souden_vector', 'gev_vector', 'lcmv_vector',
           'blind_analytic_normalization', 'apply_beamforming_vector']


def psd_matrix(Y, mask):
    """``Phi_f = sum_t m_ft y_ft y_ft^H / sum_t m_ft``.
    Y (F, D, T), mask (F, T) real -> (F, D, D)."""
    mask = mask.to(Y.real.dtype)
    weighted = Y * mask[:, None, :].to(Y.dtype)
    psd = weighted @ Y.conj().transpose(-2, -1)
    norm = torch.clamp_min(mask.sum(dim=-1), torch.finfo(mask.dtype).tiny)
    return psd / norm[:, None, None].to(Y.dtype)


def _snr_optimal_reference_channel(w_mat, cov_x, cov_n, eps):
    """Index of the reference channel maximizing the frequency-summed
    output SNR (pb_bss ``get_optimal_reference_channel``): a 0-d tensor,
    so the choice stays on the device."""
    num = torch.einsum('fdr,fde,fer->r', w_mat.conj(), cov_x, w_mat).real
    den = torch.einsum('fdr,fde,fer->r', w_mat.conj(), cov_n, w_mat).real
    return torch.argmax(num / torch.clamp_min(den, eps))


def mvdr_souden_vector(cov_x, cov_n, *, eps=1e-10, return_ref_channel=False):
    """``w = (Phi_N^{-1} Phi_X / tr(Phi_N^{-1} Phi_X)) e_ref`` with the
    SNR-optimal global reference channel.  cov_x, cov_n (F, D, D) ->
    w (F, D) (and the channel, a 0-d tensor, when
    ``return_ref_channel``).  A complex64 solve of d <= 32 channels runs
    on the Gauss-Jordan kernel (``ops/kernels/gj_inverse.py``), others on
    the plain ``linalg.hermitian_solve``."""
    solve = (hermitian_solve_gj if cov_n.dtype == torch.complex64
             and cov_n.shape[-1] <= MAX_D else hermitian_solve)
    phi = solve(cov_n, cov_x)
    lam = torch.diagonal(phi, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
    mat = phi / torch.clamp_min(lam, eps).to(phi.dtype)
    ref_channel = _snr_optimal_reference_channel(mat, cov_x, cov_n, eps)
    w = mat.index_select(-1, ref_channel.reshape(1))[..., 0]
    if return_ref_channel:
        return w, ref_channel
    return w


def gev_vector(cov_x, cov_n, *, eps_scale=1e-10):
    """GEV / max-SNR beamformer: the dominant eigenvector of
    ``Phi_N^{-1} Phi_X``, normalized to ``w^H Phi_N w = 1`` (the
    generalized-eig convention), first channel's phase real-positive.
    cov_x, cov_n (F, D, D) -> w (F, D)."""
    phi = hermitian_solve(hermitize(cov_n), cov_x, relative_load=eps_scale)
    w = dominant_eigenvector(phi)
    nquad = torch.einsum('fd,fde,fe->f', w.conj(), cov_n, w).real
    scale = 1.0 / torch.sqrt(torch.clamp_min(nquad,
                                             torch.finfo(nquad.dtype).tiny))
    return w * scale[..., None].to(w.dtype)


def lcmv_vector(cov_x, cov_i, cov_n, *, eps=1e-10):
    """LCMV: ``w = Phi_N^{-1} C (C^H Phi_N^{-1} C)^{-1} g``, g = [1, 0],
    the columns of C the dominant eigenvectors of Phi_X and Phi_I (unit
    response to the target, a null toward the interference).
    cov_x, cov_i, cov_n (F, D, D) -> w (F, D)."""
    C = torch.stack([dominant_eigenvector(hermitize(cov_x)),
                     dominant_eigenvector(hermitize(cov_i))], dim=-1)
    ninv_c = hermitian_solve(hermitize(cov_n), C, relative_load=eps)
    gram = C.conj().transpose(-2, -1) @ ninv_c                  # (F, 2, 2)
    g = torch.zeros(gram.shape[:-2] + (2, 1), dtype=gram.dtype,
                    device=gram.device)
    g[..., 0, 0] = 1.0
    return (ninv_c @ hermitian_solve(hermitize(gram), g))[..., 0]


def blind_analytic_normalization(w, cov_n):
    """BAN postgain: ``w *= sqrt(w^H Phi_N^2 w / D) / (w^H Phi_N w)``."""
    d = w.shape[-1]
    nw = torch.einsum('fde,fe->fd', cov_n, w)
    numerator = torch.sqrt(torch.abs(
        torch.einsum('fd,fd->f', w.conj(),
                     torch.einsum('fde,fe->fd', cov_n, nw)) / d))
    denominator = torch.abs(torch.einsum('fd,fd->f', w.conj(), nw))
    gain = numerator / torch.clamp_min(denominator,
                                       torch.finfo(numerator.dtype).tiny)
    return w * gain[..., None].to(w.dtype)


def apply_beamforming_vector(w, Y):
    """``x_hat_ft = sum_d conj(w_fd) y_fdt``.  w (F, D), Y (F, D, T) ->
    (F, T)."""
    return torch.einsum('fd,fdt->ft', w.conj(), Y)
