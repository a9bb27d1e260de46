"""Complex angular-central-Gaussian mixture model EM — port of
``pb_chime5_tpu/ops/cacgmm.py`` (the "GSS" core).

Two EM drivers, as in the JAX package (``CacgmmConfig.em_backend``):

* ``'pallas'``, the counterpart of the JAX fused-kernel driver
  ``_cacgmm_posteriors_pallas``: all frequencies advance together, every
  E+M accumulation is one launch of the fused kernel
  (:func:`~pb_chime5_tpu_torch.ops.kernels.fused_em.fused_em_scatter`),
  and the per-iteration covariance finalize is batched over (F, K).  With
  the Gauss-Jordan inverses the whole finalize is one launch of the
  Gauss-Jordan kernel (``ops/kernels/gj_inverse.py::em_finalize``): with
  the plain Gauss-Jordan's relative pivot floor (``inverse='auto'`` /
  ``'gauss_jordan'``) or with K3's pivot floored at ``FLT_MIN``
  (``inverse='pallas_gj'``): the two floors differ, as they do in the JAX
  package.  complex64 only.
* ``'xla'``, the JAX per-frequency EM ``_cacgmm_single_frequency`` batched
  over F: each E-step (:func:`_e_step`) and M-step (:func:`_m_step`) in
  plain PyTorch (the (F, K, T, D) intermediates materialized), the
  M-step's inverse with the relative floor for every Gauss-Jordan mode,
  ``'pallas_gj'`` included (JAX's unbatched ``_invert``): on the
  Gauss-Jordan kernel's relative entry for complex64, in plain PyTorch
  for complex128.  ``em_chunk_size`` runs each later (E, M) iteration
  over T-chunks of that many frames (JAX's ``_fused_em_iteration``): only
  the (F, K, D, D) scatter and (F, K) masses are accumulated, and the
  tail is :func:`_finalize` (``em_finalize`` for complex64).  The first
  M-step's scatter and the final E-step run over the same chunks (the
  same sums, split over T), so no (F, K, T, D) intermediate is made:
  JAX runs these two unfused.

``'auto'`` resolves to ``'pallas'`` for complex64 and to ``'xla'`` for
complex128 (no kernel computes in float64; JAX resolves to ``'xla'`` off
the TPU); ``'pallas'`` with complex128 raises.  The float64 path reaches
plain PyTorch by dtype at each call site, never through a kernel wrapper
that gives way: the wrappers raise for complex128 on CUDA.

The other JAX inverses are ported as the JAX ``_invert`` has them, after
the same weights and covariances in plain PyTorch: ``'cholesky'``
(``cholesky_ex`` + triangular solve; a failed factorization gives NaN, as
``jnp.linalg.cholesky`` does), ``'schur'`` (recursive Schur complements)
and ``'eigh'`` (eigenvalues floored relative to the largest).  Iteration
structure (reference pb_chime5/core.py:180-202 with the pb_bss fit loop):
one initialization-driven M-step, then ``iterations - 1`` masked (E, M)
passes, then ``iterations_post - 1`` unmasked ones, then a final E-step —
masked when ``iterations_post == 0``, unmasked otherwise.  At the
defaults 20 / 1 the fused kernel (or the M-step) runs 20 times.

The fused kernel's E-step gates the per-frame softmax by the activity
AFTER the max shift over all classes (``fused_em.py``'s formula,
reproduced as written).  :func:`_e_step` masks in the log domain, as the
JAX ``_e_step`` does: it is the final E-step of both drivers and every
E-step of the ``'xla'`` one.

:func:`cacgmm_posteriors_debug` is the JAX debug twin: the unfused EM
whatever ``em_backend`` says, with per-M-step statistics.
"""

import dataclasses

import torch

from pb_chime5_tpu_torch.ops import linalg
from pb_chime5_tpu_torch.ops.linalg import (
    _cholesky_or_nan, eye_like, hermitize, schur_inverse_and_logdet)
from pb_chime5_tpu_torch.ops.kernels import gj_inverse
from pb_chime5_tpu_torch.ops.kernels.fused_em import fused_em_scatter
from pb_chime5_tpu_torch.ops.kernels.gj_inverse import (
    add_jitter, em_covariances, em_finalize,
    trace_normalize as _trace_normalize)

__all__ = ['CacgmmConfig', 'cacgmm_posteriors', 'cacgmm_posteriors_debug',
           'make_initialization', 'params_from_numpy', 'add_jitter']

_INIT_FLOOR = 1e-10
INVERSES = ('auto', 'gauss_jordan', 'pallas_gj', 'cholesky', 'schur', 'eigh')
EM_BACKENDS = ('auto', 'pallas', 'xla')


@dataclasses.dataclass(frozen=True)
class CacgmmConfig:
    """EM configuration: the fields of the JAX ``CacgmmConfig``."""
    iterations: int = 20
    iterations_post: int = 1
    # 'auto' == 'gauss_jordan': trace-scaled jitter + unpivoted GJ;
    # 'pallas_gj': the same jitter + K3's floor in the fused driver (the
    # relative floor under 'xla'); 'cholesky', 'schur': the same jitter +
    # those inverses; 'eigh': floored eigendecomposition
    inverse: str = 'auto'
    eigenvalue_floor: float = 1e-10  # 'eigh'
    diagonal_floor: float = 1e-6     # every other inverse
    # 'xla' only: (E, M) iterations over T-chunks of this many frames
    # (None: unfused, the (F, K, T, D) intermediates materialized)
    em_chunk_size: int = None
    # 'auto' (fused kernel for complex64, 'xla' for complex128) |
    # 'pallas' (the fused E+M kernel) | 'xla' (the per-frequency EM)
    em_backend: str = 'auto'

    def __post_init__(self):
        if self.inverse not in INVERSES:
            raise NotImplementedError(
                f'inverse={self.inverse!r} is not an EM inverse of the JAX '
                f'package; use one of {INVERSES}')
        if self.em_backend not in EM_BACKENDS:
            raise NotImplementedError(
                f'em_backend={self.em_backend!r} is not an EM backend of '
                f'the JAX package; use one of {EM_BACKENDS}')
        chunk = self.em_chunk_size
        if chunk is not None and (isinstance(chunk, bool)
                                  or not isinstance(chunk, int)
                                  or chunk < 1):
            raise ValueError(f'em_chunk_size={chunk!r}')


def make_initialization(activity, dtype=torch.float32):
    """Activity (K, T) -> initial affiliations (K, T) of ``dtype``: zeros
    floored to 1e-10, columns normalized over classes."""
    init = activity.to(dtype)
    init = torch.where(init == 0, torch.full_like(init, _INIT_FLOOR), init)
    return init / init.sum(dim=0, keepdim=True)


def _normalize_observations(y):
    """(..., D) -> unit-norm rows; all-zero rows stay exactly zero."""
    norm = torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    tiny = torch.finfo(norm.dtype).tiny
    return torch.where(norm > tiny, y / torch.clamp_min(norm, tiny),
                       torch.zeros((), dtype=y.dtype, device=y.device))


def _relative_gauss_jordan(cov):
    """The relative-floor Gauss-Jordan: the kernel's entry for complex64
    (its plain version on the CPU), ``ops/linalg.py``'s for complex128."""
    if cov.dtype == torch.complex64 and cov.shape[-1] <= gj_inverse.MAX_D:
        return gj_inverse.gauss_jordan_inverse_and_logdet(cov.contiguous())
    return linalg.gauss_jordan_inverse_and_logdet(cov)


def _invert(cov, config: CacgmmConfig, *, batched=True):
    """Hermitian (..., D, D) -> (precision, logdet): the JAX ``_invert``.
    Every inverse but ``'eigh'`` first adds the trace-scaled diagonal
    jitter (clamped at ``tiny``).  ``'pallas_gj'`` is K3's floor only for
    a ``batched`` call (the fused driver's full (F, K) batch), the
    relative floor for the per-frequency EM's ``batched=False``, as in
    JAX."""
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
    if config.inverse == 'pallas_gj' and batched:
        return gj_inverse.hermitian_inverse_and_logdet_2d(cov)
    if config.inverse == 'schur':
        return schur_inverse_and_logdet(cov)
    if config.inverse == 'cholesky':
        L = _cholesky_or_nan(cov)
        Linv = torch.linalg.solve_triangular(L, eye_like(cov), upper=False)
        precision = Linv.conj().transpose(-2, -1) @ Linv
        diag = torch.diagonal(L, dim1=-2, dim2=-1).real
        return precision, 2.0 * torch.log(
            torch.clamp_min(diag, tiny)).sum(dim=-1)
    return _relative_gauss_jordan(cov)


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


def _scatter(z, coeff, chunk=None):
    """``sum_t coeff_fkt z_ft z_ft^H``: z (F, T, D), coeff (F, K, T) real
    -> (F, K, D, D), through the (F, K, T, D) weighted copy of z, or its
    T-chunks of ``chunk`` frames."""
    if chunk:
        return sum(_scatter(z[:, t:t + chunk], coeff[..., t:t + chunk])
                   for t in range(0, z.shape[1], chunk))
    weighted = z[:, None] * coeff[..., None].to(z.dtype)
    return weighted.transpose(-2, -1) @ z.conj()[:, None]


def _m_step(z, gamma, quadratic_form, frame_mask, config: CacgmmConfig):
    """The JAX ``_m_step`` batched over F: z (F, T, D), gamma and
    quadratic_form (F, K, T) -> params ((F, K), (F, K, D, D), (F, K))."""
    rdtype = gamma.dtype
    tiny = torch.finfo(rdtype).tiny
    D = z.shape[-1]
    if frame_mask is not None:
        gamma = gamma * frame_mask.to(rdtype)
    denom = gamma.sum(dim=-1)                                  # (F, K)
    total = denom.sum(dim=-1, keepdim=True)
    weight = torch.where(total > 0, denom / torch.clamp_min(total, tiny),
                         torch.zeros_like(denom))
    log_weight = torch.log(torch.clamp_min(weight, tiny))
    # one division with one floor, pinned to exactly 0 where gamma == 0
    # (an empty class: 0 / tiny, never 0 * inf)
    coeff = torch.where(
        gamma > 0,
        gamma / torch.clamp_min(denom[..., None] * quadratic_form, tiny),
        torch.zeros_like(gamma))
    cov = _trace_normalize(hermitize(
        _scatter(z, coeff, config.em_chunk_size) * D))
    precision, logdet = _invert(cov, config, batched=False)
    return log_weight, precision, logdet.to(rdtype)


# the Gauss-Jordan inverses' pivot floors, in em_finalize's names
_GJ_FLOORS = {'auto': 'relative', 'gauss_jordan': 'relative',
              'pallas_gj': 'flt_min'}


def _finalize(S, denom, config: CacgmmConfig, *, batched=True):
    """Accumulated (S, den) -> next EM parameters.  A Gauss-Jordan inverse
    in complex64 (D <= 32, K <= 8) is one launch of ``em_finalize``, with
    K3's floor for ``'pallas_gj'`` only in a ``batched`` call (the fused
    driver), as :func:`_invert`; anything else is the same finalize in
    plain PyTorch."""
    floor = _GJ_FLOORS.get(config.inverse)
    if floor is not None and not batched:
        floor = 'relative'
    F, K, D, _ = S.shape
    if floor is not None and S.dtype == torch.complex64 \
            and D <= gj_inverse.MAX_D and K <= gj_inverse.MAX_K:
        return em_finalize(S, denom, diagonal_floor=config.diagonal_floor,
                           floor=floor)
    log_weight, cov = em_covariances(S, denom)
    return (log_weight, *_invert(cov, config, batched=batched))


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


def _posterior(z, params, source_activity_mask, chunk=None):
    """The final E-step's responsibilities (F, K, T), over T-chunks of
    ``chunk`` frames when given."""
    if not chunk:
        return _e_step(z, params, source_activity_mask)[0]
    return torch.cat([
        _e_step(z[:, t:t + chunk], params,
                None if source_activity_mask is None
                else source_activity_mask[:, t:t + chunk])[0]
        for t in range(0, z.shape[1], chunk)], dim=-1)


def _chunked_em_iteration(z, params, source_activity_mask, frame_mask,
                          config: CacgmmConfig):
    """One (E, M) iteration over T-chunks of ``config.em_chunk_size``
    frames (the JAX ``_fused_em_iteration``): per chunk the E-step of
    :func:`_e_step` and the accumulation of S and den with the M-step's
    1 / den deferred to :func:`_finalize`."""
    F, T, D = z.shape
    K = params[0].shape[-1]
    rdtype = params[2].dtype
    S = torch.zeros((F, K, D, D), dtype=z.dtype, device=z.device)
    denom = torch.zeros((F, K), dtype=rdtype, device=z.device)
    for start in range(0, T, config.em_chunk_size):
        chunk = slice(start, start + config.em_chunk_size)
        zc = z[:, chunk]
        gamma, q = _e_step(zc, params, None if source_activity_mask is None
                           else source_activity_mask[:, chunk])
        if frame_mask is not None:
            gamma = gamma * frame_mask[chunk].to(rdtype)
        denom = denom + gamma.sum(dim=-1)
        # q can sit at its tiny clamp on zero frames: pinned to 0 there
        coeff = torch.where(gamma > 0, gamma / q, torch.zeros_like(gamma))
        S = S + _scatter(zc, coeff)
    return _finalize(S, denom, config, batched=False)


def _cacgmm_posteriors_xla(Y, initialization, source_activity_mask,
                           frame_mask, config: CacgmmConfig, on_m_step=None):
    """The JAX ``_cacgmm_single_frequency`` batched over F.  Y (F, T, D)
    complex64 or complex128, initialization (K, T) of Y's real dtype ->
    posteriors (F, K, T).  ``on_m_step(params, gamma)`` is called after
    each M-step with the responsibilities it consumed (unfused only)."""
    z = _normalize_observations(Y)
    gamma = initialization.expand(z.shape[0], -1, -1)
    # the first M-step consumes the (floored, unmasked) initialization:
    # the activity mask only enters the E-step
    params = _m_step(z, gamma, torch.ones_like(gamma), frame_mask, config)
    if on_m_step is not None:
        on_m_step(params, gamma)

    def iterate(params, mask):
        if config.em_chunk_size:
            return _chunked_em_iteration(z, params, mask, frame_mask, config)
        gamma, quadratic_form = _e_step(z, params, mask)
        params = _m_step(z, gamma, quadratic_form, frame_mask, config)
        if on_m_step is not None:
            on_m_step(params, gamma)
        return params

    for _ in range(config.iterations - 1):
        params = iterate(params, source_activity_mask)
    if config.iterations_post == 0:
        return _posterior(z, params, source_activity_mask,
                          config.em_chunk_size)
    for _ in range(config.iterations_post - 1):
        params = iterate(params, None)
    return _posterior(z, params, None, config.em_chunk_size)


def _resolve_backend(config: CacgmmConfig, dtype):
    backend = config.em_backend
    if backend == 'auto':
        backend = 'pallas' if dtype == torch.complex64 else 'xla'
    if backend == 'pallas' and dtype != torch.complex64:
        raise ValueError(f"em_backend='pallas' (the fused E+M kernel) "
                         f"computes in complex64, got {dtype}")
    return backend


def cacgmm_posteriors(Y, activity, *, config: CacgmmConfig = CacgmmConfig(),
                      frame_mask=None):
    """Guided source separation posteriors.

    Y (F, T, D) complex64 or complex128; activity (K, T) bool/int/float
    per-class frame activity (initialization and source-activity mask);
    frame_mask (T,) bool or None -> (F, K, T) class posteriors of Y's real
    dtype.
    """
    backend = _resolve_backend(config, Y.dtype)
    initialization = make_initialization(activity, dtype=Y.real.dtype)
    driver = (_cacgmm_posteriors_fused if backend == 'pallas'
              else _cacgmm_posteriors_xla)
    return driver(Y, initialization, activity != 0, frame_mask, config)


def _m_step_stats(params, D):
    """(weights, logdet, condition proxy) of one M-step's parameters: the
    covariances are trace-normalized to D, so trace(B) trace(B^-1) / D^2
    is trace(precision) / D."""
    log_weight, precision, logdet = params
    condition = torch.diagonal(precision, dim1=-2, dim2=-1).sum(-1).real / D
    return torch.exp(log_weight), logdet, condition


def _gamma_entropy(gamma, frame_mask):
    """Mean class-posterior entropy over valid frames (0 log 0 := 0):
    gamma (F, K, T) -> (F,)."""
    plogp = torch.where(gamma > 0, gamma * torch.log(gamma),
                        torch.zeros_like(gamma))
    ent = -plogp.sum(dim=-2)                                   # (F, T)
    if frame_mask is None:
        return ent.mean(dim=-1)
    m = frame_mask.to(ent.dtype)
    return (ent * m).sum(dim=-1) / torch.clamp_min(m.sum(), 1.0)


def cacgmm_posteriors_debug(Y, activity, *,
                            config: CacgmmConfig = CacgmmConfig(),
                            frame_mask=None):
    """:func:`cacgmm_posteriors` with per-iteration EM introspection (the
    JAX debug twin; the reference's ``stack_parameters``,
    pb_chime5/core.py:27-29, 211).  Always runs the unfused ``'xla'`` EM,
    whatever ``em_backend`` and ``em_chunk_size`` say.

    Returns (posteriors (F, K, T), dict) with, per M-step (axis 0, I =
    1 + (iterations - 1) + max(iterations_post - 1, 0), the
    initialization-driven first M-step included): ``weights`` (I, F, K)
    mixture weights, ``logdet`` (I, F, K) log|B_k| of the trace-normalized
    covariances, ``condition`` (I, F, K) trace(B) trace(B^-1) / D^2 (>= 1,
    1 iff B ~ I; exploding values mark collapsing classes) and
    ``posterior_entropy`` (I, F) the mean over valid frames of the
    class-posterior entropy fed into that M-step."""
    D = Y.shape[-1]
    records = []

    def on_m_step(params, gamma):
        records.append((*_m_step_stats(params, D),
                        _gamma_entropy(gamma, frame_mask)))

    posterior = _cacgmm_posteriors_xla(
        Y, make_initialization(activity, dtype=Y.real.dtype), activity != 0,
        frame_mask, dataclasses.replace(config, em_chunk_size=None),
        on_m_step)
    keys = ('weights', 'logdet', 'condition', 'posterior_entropy')
    return posterior, {key: torch.stack([r[i] for r in records])
                       for i, key in enumerate(keys)}


def params_from_numpy(params, device, dtype=torch.float32):
    """(log_weight (F, K), precision (F, K, D, D), logdet (F, K)) NumPy
    arrays (e.g. EM state taken from the JAX package) -> the port's
    contiguous tensors on ``device``: the real ones of ``dtype`` (float32
    or float64), the precision of the matching complex dtype."""
    cdtype = {torch.float32: torch.complex64,
              torch.float64: torch.complex128}[dtype]
    log_weight, precision, logdet = params
    return (torch.as_tensor(log_weight, dtype=dtype,
                            device=device).contiguous(),
            torch.as_tensor(precision, dtype=cdtype,
                            device=device).contiguous(),
            torch.as_tensor(logdet, dtype=dtype, device=device).contiguous())
