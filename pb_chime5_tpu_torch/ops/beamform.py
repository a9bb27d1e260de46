"""Mask-based beamforming — port of the beamformers of
``pb_chime5_tpu/ops/beamform.py``.

Masked PSD matrices, MVDR in the Souden formulation with the SNR-optimal
global reference channel, GEV (the dominant generalized eigenvector of
(Phi_X, Phi_N), by repeated squaring of Phi_N^{-1} Phi_X), LCMV with a
target and an interference constraint, blind analytic normalization
(BAN), the beamformer apply, the mask condensation over channels (the
median, reference wrapper:27-34) and the wrapper-level from-masks entry
points (reference wrapper:108-251), with the unsupervised Lorenz /
quantile mask front-ends of ``ops/masks.py``.  Shapes: Y (F, D, T), masks
(F, T), vectors (F, D), output (F, T); the from-masks entry points take
the wrapper's Y (D, T, F) and masks (D, T, F) / (T, F) and return (T, F).
The reference channel is picked with ``torch.argmax`` and a gather, one
per utterance of a batch; the JAX one-hot reductions were a TPU-runtime
workaround.  The
from-masks GEV and LCMV compute their PSDs and vectors in float64, as the
chain does (``models/gss.py::_beamform``).
"""

import torch

from pb_chime5_tpu_torch.ops import masks as _masks

from pb_chime5_tpu_torch.ops.kernels.gj_inverse import (
    MAX_D, hermitian_solve_gj)
from pb_chime5_tpu_torch.ops.linalg import (
    dominant_eigenvector, hermitian_solve, hermitize)

__all__ = ['condense_mask', 'psd_matrix', 'mvdr_souden_vector',
           'mvdr_souden_matrix', 'snr_statistics', 'reference_channel',
           'select_channel',
           'gev_vector', 'lcmv_vector', 'blind_analytic_normalization',
           'apply_beamforming_vector', 'beamform_mvdr_souden_from_masks',
           'beamform_gev_from_masks', 'beamform_lcmv_from_masks',
           'beamform_mvdr_souden_with_lorenz_mask',
           'beamform_mvdr_souden_with_quantile_mask']


def condense_mask(mask):
    """Mask (T, F), (D, T, F) or (1, D, T, F) -> (F, T), the channel axis
    reduced by its median as ``jnp.median`` takes it: ``(low + high) *
    0.5`` of the two middle values for an even D (``torch.median`` takes
    the lower one)."""
    if mask.dim() == 4:
        mask = mask[0]
    if mask.dim() == 3:
        s = torch.sort(mask, dim=0).values
        D = mask.shape[0]
        mask = (s[(D - 1) // 2] + s[D // 2]) * 0.5
    elif mask.dim() != 2:
        raise NotImplementedError(tuple(mask.shape))
    return mask.T


def _to_fdt(Y):
    """Y (D, T, F) or (1, D, T, F) -> (F, D, T) (wrapper:21-24)."""
    if Y.dim() == 4:
        Y = Y[0]
    return Y.permute(2, 0, 1)


def psd_matrix(Y, mask=None):
    """``Phi_f = sum_t m_ft y_ft y_ft^H / sum_t m_ft`` (all ones without a
    mask).  Y (F, D, T), mask (F, T) real -> (F, D, D)."""
    if mask is None:
        mask = torch.ones((Y.shape[0], Y.shape[2]), device=Y.device)
    mask = mask.to(Y.real.dtype)
    weighted = Y * mask[:, None, :].to(Y.dtype)
    psd = weighted @ Y.conj().transpose(-2, -1)
    norm = torch.clamp_min(mask.sum(dim=-1), torch.finfo(mask.dtype).tiny)
    return psd / norm[:, None, None].to(Y.dtype)


def mvdr_souden_matrix(cov_x, cov_n, *, eps=1e-10):
    """``Phi_N^{-1} Phi_X / tr(Phi_N^{-1} Phi_X)``: cov_x, cov_n
    (..., D, D) -> (..., D, D), every matrix of the leading axes in one
    solve.  A complex64 solve of d <= 32 channels runs on the Gauss-Jordan
    kernel (``ops/kernels/gj_inverse.py``), others on the plain
    ``linalg.hermitian_solve``."""
    D = cov_n.shape[-1]
    solve = (hermitian_solve_gj if cov_n.dtype == torch.complex64
             and D <= MAX_D else hermitian_solve)
    phi = solve(cov_n.reshape(-1, D, D),
                cov_x.reshape(-1, D, D)).reshape(cov_n.shape)
    lam = torch.diagonal(phi, dim1=-2, dim2=-1).sum(-1).real[..., None, None]
    return phi / torch.clamp_min(lam, eps).to(phi.dtype)


def snr_statistics(w_mat, cov_x, cov_n):
    """The SNR-optimal reference channel's statistics (pb_bss
    ``get_optimal_reference_channel``): numerator and denominator, each
    summed over frequency and channels.  w_mat, cov_x, cov_n
    (..., F, D, D) -> (num, den) (..., R), one candidate R a channel."""
    num = torch.einsum('...fdr,...fde,...fer->...r', w_mat.conj(), cov_x,
                       w_mat).real
    den = torch.einsum('...fdr,...fde,...fer->...r', w_mat.conj(), cov_n,
                       w_mat).real
    return num, den


def reference_channel(num, den, eps):
    """The channel maximizing ``num / max(den, eps)``: (..., R) -> (...),
    one per utterance, on the device."""
    return torch.argmax(num / torch.clamp_min(den, eps), dim=-1)


def _snr_optimal_reference_channel(w_mat, cov_x, cov_n, eps,
                                   snr_reduce=None):
    """Index of the reference channel maximizing the frequency-summed
    output SNR: w_mat (..., F, D, R) -> (...) tensor, so the choice stays
    on the device.  ``snr_reduce`` sums the (..., R) statistics across a
    sharded frequency axis (``parallel/mesh.py``), so every shard selects
    the same channel."""
    num, den = snr_statistics(w_mat, cov_x, cov_n)
    if snr_reduce is not None:
        num, den = snr_reduce(num), snr_reduce(den)
    return reference_channel(num, den, eps)


def select_channel(mat, ref_channel):
    """Column ``ref_channel`` of each matrix: mat (..., F, D, D) and a
    (...) index tensor -> (..., F, D)."""
    index = ref_channel[..., None, None, None].expand(*mat.shape[:-1], 1)
    return torch.gather(mat, -1, index)[..., 0]


def mvdr_souden_vector(cov_x, cov_n, *, eps=1e-10, ref_channel=None,
                       return_ref_channel=False, snr_reduce=None):
    """``w = (Phi_N^{-1} Phi_X / tr(Phi_N^{-1} Phi_X)) e_ref``: the given
    ``ref_channel`` (an int in [-D, D), or a tensor index, clamped to that
    range), else the SNR-optimal reference channel, one per utterance
    (``snr_reduce``: see :func:`_snr_optimal_reference_channel`).
    cov_x, cov_n (F, D, D) -> w (F, D), or for a batch (B, F, D, D) ->
    (B, F, D) (and the channel, a (B,) or 0-d tensor, when
    ``return_ref_channel``); see :func:`mvdr_souden_matrix` for the
    solve."""
    mat = mvdr_souden_matrix(cov_x, cov_n, eps=eps)
    D = mat.shape[-1]
    if ref_channel is None:
        ref_channel = _snr_optimal_reference_channel(
            mat, cov_x, cov_n, eps, snr_reduce=snr_reduce)
    elif isinstance(ref_channel, int):
        if not -D <= ref_channel < D:
            raise ValueError(
                f'ref_channel {ref_channel} out of range for D={D}')
        ref_channel = torch.tensor(ref_channel % D, device=mat.device)
    else:
        ref_channel = torch.clamp(torch.as_tensor(
            ref_channel, device=mat.device), -D, D - 1) % D
    w = select_channel(mat, ref_channel)
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



def _psds(Y, *masks, float64=False):
    """The (F, D, D) PSDs of Y (D, T, F) or (1, D, T, F) under each
    condensed mask, in float64 when asked; and Y as (F, D, T)."""
    Yf = _to_fdt(Y)
    Yc = Yf.to(torch.complex128) if float64 else Yf
    return Yf, [psd_matrix(Yc, condense_mask(m)) for m in masks]


def beamform_mvdr_souden_from_masks(Y, X_mask, N_mask, *, ban=True):
    """MVDR-Souden (+ BAN) from a speech and a noise mask: Y (D, T, F) (or
    (1, D, T, F)), masks (D, T, F) / (T, F) -> enhanced (T, F)."""
    Yf, (cov_x, cov_n) = _psds(Y, X_mask, N_mask)
    w = mvdr_souden_vector(cov_x, cov_n, eps=1e-10)
    if ban:
        w = blind_analytic_normalization(w, cov_n)
    return apply_beamforming_vector(w, Yf).T


def beamform_gev_from_masks(Y, X_mask, N_mask, *, ban=True):
    """GEV (+ BAN) from a speech and a noise mask, PSDs and vector in
    float64: Y (D, T, F), masks -> enhanced (T, F)."""
    Yf, (cov_x, cov_n) = _psds(Y, X_mask, N_mask, float64=True)
    w = gev_vector(cov_x, cov_n)
    if ban:
        w = blind_analytic_normalization(w, cov_n)
    return apply_beamforming_vector(w.to(Yf.dtype), Yf).T


def beamform_lcmv_from_masks(Y, X_mask, I_mask, N_mask, *, ban=False):
    """LCMV (+ BAN over interference and noise) from target, interference
    and noise masks, PSDs and vector in float64: Y (D, T, F), masks ->
    enhanced (T, F)."""
    Yf, (cov_x, cov_i, cov_n) = _psds(Y, X_mask, I_mask, N_mask,
                                      float64=True)
    w = lcmv_vector(cov_x, cov_i, cov_n)
    if ban:
        w = blind_analytic_normalization(w, cov_i + cov_n)
    return apply_beamforming_vector(w.to(Yf.dtype), Yf).T


def beamform_mvdr_souden_with_lorenz_mask(Y, X_hat=None):
    """Unsupervised MVDR: the speech mask is the Lorenz-curve energy mask
    of ``X_hat`` (default Y) along time, the noise mask its complement
    (reference wrapper:211-227)."""
    if X_hat is None:
        X_hat = Y
    X_mask = _masks.lorenz_mask(X_hat.transpose(-2, -1)).transpose(-2, -1)
    return beamform_mvdr_souden_from_masks(Y, X_mask, 1.0 - X_mask,
                                           ban=False)


def beamform_mvdr_souden_with_quantile_mask(Y, X_hat=None,
                                            quantile=(0.1, -0.8)):
    """Unsupervised MVDR: speech / noise masks from energy quantiles over
    time, by default the loudest 10 % vs the quietest 80 % of frames
    (reference wrapper:230-251)."""
    if X_hat is None:
        X_hat = Y
    X_mask, N_mask = _masks.quantile_mask(X_hat, list(quantile),
                                          sensor_axis=None, axis=-2)
    return beamform_mvdr_souden_from_masks(Y, X_mask, N_mask, ban=False)
