"""Complex angular-central-Gaussian mixture model EM — port of
``pb_chime5_tpu/ops/cacgmm.py`` (the "GSS" core).

The port's only EM driver is the counterpart of the JAX fused-kernel
driver ``_cacgmm_posteriors_pallas``: all frequencies advance together,
every E+M accumulation is one launch of the fused kernel
(:func:`~pb_chime5_tpu_torch.ops.kernels.fused_em.fused_em_scatter`), and
the per-iteration covariance finalize is batched over (F, K).  With the
Gauss-Jordan inverses the whole finalize is one launch of the
Gauss-Jordan kernel (``ops/kernels/gj_inverse.py::em_finalize``): with
the plain Gauss-Jordan's relative pivot floor (``inverse='auto'`` /
``'gauss_jordan'``) or with K3's pivot floored at ``FLT_MIN``
(``inverse='pallas_gj'``): the two floors differ, as they do in the JAX
package.  The other JAX inverses are ported as the JAX ``_invert`` has
them, after the same weights and covariances in plain PyTorch:
``'cholesky'`` (``cholesky_ex`` + triangular solve; a failed
factorization gives NaN, as ``jnp.linalg.cholesky`` does), ``'schur'``
(recursive Schur complements) and ``'eigh'`` (eigenvalues floored
relative to the largest).  Iteration structure (reference pb_chime5/core.py:180-202
with the pb_bss fit loop): one initialization-driven M-step, then
``iterations - 1`` masked (E, M) passes, then ``iterations_post - 1``
unmasked ones, then a final E-step — masked when ``iterations_post ==
0``, unmasked otherwise.  At the defaults 20 / 1 the kernel runs 20 times.

The kernel's E-step gates the per-frame softmax by the activity AFTER
the max shift over all classes (``fused_em.py``'s formula, reproduced as
written).  The final E-step is :func:`_e_step`, which masks in the log
domain, as the JAX driver does.
"""

import dataclasses

import torch

from pb_chime5_tpu_torch.ops.linalg import (
    _cholesky_or_nan, eye_like, gauss_jordan_inverse_and_logdet, hermitize,
    schur_inverse_and_logdet)
from pb_chime5_tpu_torch.ops.kernels.fused_em import fused_em_scatter
from pb_chime5_tpu_torch.ops.kernels.gj_inverse import (
    add_jitter, em_covariances, em_finalize, hermitian_inverse_and_logdet_2d,
    trace_normalize as _trace_normalize)

__all__ = ['CacgmmConfig', 'cacgmm_posteriors', 'make_initialization',
           'params_from_numpy', 'add_jitter']

_INIT_FLOOR = 1e-10
INVERSES = ('auto', 'gauss_jordan', 'pallas_gj', 'cholesky', 'schur', 'eigh')


@dataclasses.dataclass(frozen=True)
class CacgmmConfig:
    """EM configuration: the fields of the JAX ``CacgmmConfig`` that the
    fused-kernel EM uses."""
    iterations: int = 20
    iterations_post: int = 1
    # 'auto' == 'gauss_jordan': trace-scaled jitter + unpivoted GJ;
    # 'pallas_gj': the same jitter + the batched GJ kernel; 'cholesky',
    # 'schur': the same jitter + those inverses; 'eigh': floored
    # eigendecomposition
    inverse: str = 'auto'
    eigenvalue_floor: float = 1e-10  # 'eigh'
    diagonal_floor: float = 1e-6     # every other inverse
    # the fused E+M kernel ('auto' and 'pallas' both name it here)
    em_backend: str = 'auto'

    def __post_init__(self):
        if self.inverse not in INVERSES:
            raise NotImplementedError(
                f'inverse={self.inverse!r} is not an EM inverse of the JAX '
                f'package; use one of {INVERSES}')
        if self.em_backend not in ('auto', 'pallas'):
            raise NotImplementedError(
                f'em_backend={self.em_backend!r}: only the fused E+M kernel '
                f'EM is ported (ROADMAP.md, Queue 1)')


def make_initialization(activity):
    """Activity (K, T) -> initial affiliations (K, T) float32: zeros
    floored to 1e-10, columns normalized over classes."""
    init = activity.to(torch.float32)
    init = torch.where(init == 0, torch.full_like(init, _INIT_FLOOR), init)
    return init / init.sum(dim=0, keepdim=True)


def _normalize_observations(y):
    """(..., D) -> unit-norm rows; all-zero rows stay exactly zero."""
    norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    tiny = torch.finfo(norm.dtype).tiny
    return torch.where(norm > tiny, y / torch.clamp_min(norm, tiny),
                       torch.zeros((), dtype=y.dtype, device=y.device))


def _invert(cov, config: CacgmmConfig):
    """Hermitian (..., D, D) -> (precision, logdet): the JAX ``_invert``
    of the fused-kernel driver.  Every inverse but ``'eigh'`` first adds
    the trace-scaled diagonal jitter (clamped at ``tiny``)."""
    tiny = torch.finfo(cov.real.dtype).tiny
    if config.inverse == 'eigh':
        # a non-finite covariance gives NaN, as jnp.linalg.eigh does
        # (torch.linalg.eigh raises on it)
        finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)[..., None]
        ew, ev = torch.linalg.eigh(
            torch.where(finite[..., None], cov, eye_like(cov)))
        ew = torch.where(finite, ew, float('nan'))
        ev = torch.where(finite[..., None], ev, float('nan'))
        floor = ew.amax(dim=-1, keepdim=True) * config.eigenvalue_floor
        # the second clamp keeps an all-zero covariance finite
        ew = torch.clamp_min(torch.maximum(ew, floor), tiny)
        precision = (ev * (1.0 / ew)[..., None, :].to(ev.dtype)) \
            @ ev.conj().transpose(-2, -1)
        return precision, torch.log(ew).sum(dim=-1)
    cov = add_jitter(cov, config.diagonal_floor)
    if config.inverse == 'pallas_gj':
        return hermitian_inverse_and_logdet_2d(cov)
    if config.inverse == 'schur':
        return schur_inverse_and_logdet(cov)
    if config.inverse == 'cholesky':
        L = _cholesky_or_nan(cov)
        Linv = torch.linalg.solve_triangular(L, eye_like(cov), upper=False)
        precision = Linv.conj().transpose(-2, -1) @ Linv
        diag = torch.diagonal(L, dim1=-2, dim2=-1).real
        return precision, 2.0 * torch.log(
            torch.clamp_min(diag, tiny)).sum(dim=-1)
    return gauss_jordan_inverse_and_logdet(cov)


def _e_step(z, params, source_activity_mask):
    """E-step over all frequencies.  z (F, T, D), params ((F, K),
    (F, K, D, D), (F, K)), mask (K, T) bool or None -> (gamma (F, K, T),
    quadratic_form (F, K, T)).  Masks in the log domain."""
    log_weight, precision, logdet = params
    D = z.shape[-1]
    tiny = torch.finfo(logdet.dtype).tiny
    vz = torch.einsum('fkde,fte->fktd', precision, z)
    quadratic_form = torch.clamp_min(
        (vz * z.conj()[:, None]).sum(dim=-1).real, tiny)
    log_pdf = (log_weight[..., None] - D * torch.log(quadratic_form)
               - logdet[..., None])
    if source_activity_mask is not None:
        log_pdf = torch.where(source_activity_mask, log_pdf,
                              torch.full_like(log_pdf, -1e30))
    log_pdf = log_pdf - log_pdf.amax(dim=1, keepdim=True)
    gamma = torch.exp(log_pdf)
    if source_activity_mask is not None:
        gamma = gamma * source_activity_mask.to(gamma.dtype)
    s = gamma.sum(dim=1, keepdim=True)
    gamma = torch.where(s > 0.5, gamma / torch.clamp_min(s, tiny),
                        torch.zeros_like(gamma))
    return gamma, quadratic_form


# the Gauss-Jordan inverses' pivot floors, in em_finalize's names
_GJ_FLOORS = {'auto': 'relative', 'gauss_jordan': 'relative',
              'pallas_gj': 'flt_min'}


def _finalize(S, denom, config: CacgmmConfig):
    """Accumulated (S, den) -> next EM parameters."""
    floor = _GJ_FLOORS.get(config.inverse)
    if floor is not None:
        return em_finalize(S, denom, diagonal_floor=config.diagonal_floor,
                           floor=floor)
    log_weight, cov = em_covariances(S, denom)
    return (log_weight, *_invert(cov, config))


def _cacgmm_posteriors_fused(Y, initialization, source_activity_mask,
                             frame_mask, config: CacgmmConfig):
    """Counterpart of the JAX ``_cacgmm_posteriors_pallas``.

    Y (F, T, D) complex64; initialization (K, T) float32; mask (K, T)
    bool; frame_mask (T,) bool or None -> posteriors (F, K, T)."""
    z = _normalize_observations(Y).contiguous()
    F, T, D = z.shape
    K = initialization.shape[0]
    tiny = torch.finfo(torch.float32).tiny
    device = z.device
    fm = (torch.ones(T, device=device) if frame_mask is None
          else frame_mask.to(torch.float32)).contiguous()
    act_m = source_activity_mask.to(torch.float32).contiguous()
    act_1 = torch.ones((K, T), device=device)

    # First M-step through the same kernel: identity precisions and zero
    # log-weights / logdets make its E-step the identity on the
    # (column-normalized) initialization, so gamma == init.
    init = initialization / torch.clamp_min(
        initialization.sum(dim=0, keepdim=True), tiny)
    eye = torch.eye(D, dtype=z.dtype, device=device).expand(
        F, K, D, D).contiguous()
    zeros = torch.zeros((F, K), device=device)
    params = _finalize(
        *fused_em_scatter(z, (zeros, eye, zeros), init.contiguous(), fm),
        config)
    for _ in range(config.iterations - 1):
        params = _finalize(*fused_em_scatter(z, params, act_m, fm), config)
    if config.iterations_post == 0:
        return _e_step(z, params, source_activity_mask)[0]
    for _ in range(config.iterations_post - 1):
        params = _finalize(*fused_em_scatter(z, params, act_1, fm), config)
    return _e_step(z, params, None)[0]


def cacgmm_posteriors(Y, activity, *, config: CacgmmConfig = CacgmmConfig(),
                      frame_mask=None):
    """Guided source separation posteriors.

    Y (F, T, D) complex64; activity (K, T) bool/int/float per-class frame
    activity (initialization and source-activity mask); frame_mask (T,)
    bool or None -> (F, K, T) class posteriors.
    """
    initialization = make_initialization(activity)
    return _cacgmm_posteriors_fused(
        Y, initialization, activity != 0, frame_mask, config)


def params_from_numpy(params, device):
    """(log_weight (F, K), precision (F, K, D, D), logdet (F, K)) NumPy
    arrays (e.g. EM state taken from the JAX package) -> the port's
    float32 / complex64 contiguous tensors on ``device``."""
    log_weight, precision, logdet = params
    return (torch.as_tensor(log_weight, dtype=torch.float32,
                            device=device).contiguous(),
            torch.as_tensor(precision, dtype=torch.complex64,
                            device=device).contiguous(),
            torch.as_tensor(logdet, dtype=torch.float32,
                            device=device).contiguous())
