"""Batched Gauss-Jordan inverse and log-determinant of Hermitian PD
matrices, and the cacGMM EM finalize built on it — wrappers of the CUDA
kernel ``csrc/gj_inverse.cu`` (the port of the Pallas TPU kernels
``pb_chime5_tpu/ops/pallas/gj_inverse2d.py::_gj2d_kernel`` and
``pb_chime5_tpu/ops/pallas/hermitian_inverse.py::_gj_kernel``) and their
plain PyTorch versions.

The inverse entries take the JAX public layout, (..., D, D) complex64,
and return (inverse (..., D, D) complex64, logdet (...,) float32).  They
launch the same kernel and differ only in how the pivot is floored:

* :func:`hermitian_inverse_and_logdet_2d` (K3, the EM's
  ``bss_inverse='pallas_gj'``): ``p = max(Re a_ii, FLT_MIN)`` for both the
  log and the reciprocal;
* :func:`hermitian_inverse_and_logdet` (K4): ``log(max(Re a_ii, 1e-38))``
  and ``1 / Re a_ii``.  1e-38 is a float32 subnormal that XLA flushes to
  zero, so the JAX kernel's log floor runs as "below ``FLT_MIN`` -> 0"
  (a non-positive pivot gives a logdet of -inf); both versions here
  reproduce it as it runs;
* :func:`gauss_jordan_inverse_and_logdet`: the relative floor of
  ``ops/linalg.py::gauss_jordan_inverse_and_logdet`` (the EM's default
  inverse and the MVDR solve's), whose formula the kernel runs operation
  for operation; that function is its plain version.

:func:`hermitian_solve_gj` is ``ops/linalg.py::hermitian_solve``'s
Gauss-Jordan method with its inverse on that entry: the complex64 MVDR
solve of ``ops/beamform.py``.

:func:`em_finalize` runs the whole EM finalize — mixture weights,
covariances from the accumulated scatter, hermitization, trace
normalization, the trace-scaled jitter, inverse and logdet — in one
launch, with the relative floor (``inverse='auto'`` / ``'gauss_jordan'``)
or K3's (``'pallas_gj'``).  Its plain version is
:func:`em_finalize_reference`, which :func:`em_covariances`,
:func:`trace_normalize` and :func:`add_jitter` spell out.

For CUDA tensors an entry launches the kernel, for CPU tensors it runs
its ``..._reference`` plain version; any other placement, dtype, layout or
size raises.  Nothing falls back: a failed build or launch raises.  Each
entry's ``launches`` counts its kernel launches (never reference calls).
"""

import ctypes

import torch

from pb_chime5_tpu_torch.ops.kernels._build import check_launch, kernel_entry
from pb_chime5_tpu_torch.ops.linalg import (
    equilibrate,
    gauss_jordan_inverse_and_logdet as gauss_jordan_inverse_and_logdet_reference,
    hermitize)

__all__ = ['hermitian_inverse_and_logdet_2d', 'hermitian_inverse_and_logdet',
           'gauss_jordan_inverse_and_logdet', 'hermitian_solve_gj',
           'em_finalize',
           'hermitian_inverse_and_logdet_2d_reference',
           'hermitian_inverse_and_logdet_reference',
           'gauss_jordan_inverse_and_logdet_reference',
           'em_finalize_reference', 'em_covariances', 'trace_normalize',
           'add_jitter', 'FLOORS', 'MAX_D', 'MAX_K']

MAX_D = 32           # kMaxD in csrc/gj_inverse.cu (its launchers reject more)
MAX_K = 8            # kMaxK: classes of one frequency in the finalize
# the C entries' floor modes
_FLUSHED_LOG, _FLT_MIN, _RELATIVE = 0, 1, 2
FLOORS = {'relative': _RELATIVE, 'flt_min': _FLT_MIN}   # em_finalize's

_INVERSE_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (
    ctypes.c_void_p,)
_FINALIZE_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (
    ctypes.c_float,) * 2 + (ctypes.c_void_p,)


def _check_device(*tensors):
    device = tensors[0].device
    if device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {device}')
    if any(t.device != device for t in tensors):
        raise ValueError('the inputs lie on different devices')


def _check(B):
    if B.dim() < 2 or B.shape[-1] != B.shape[-2]:
        raise ValueError(f'expected (..., D, D), got {tuple(B.shape)}')
    D = B.shape[-1]
    if not 1 <= D <= MAX_D:
        raise ValueError(f'the Gauss-Jordan kernel supports 1 <= D <= '
                         f'{MAX_D}; got D={D}')
    if B.dtype != torch.complex64:
        raise ValueError(f'expected complex64, got {B.dtype}')
    if not B.is_contiguous():
        raise ValueError('the matrices must be contiguous')
    if B.numel() == 0:
        raise ValueError('empty batch')
    _check_device(B)


def _launch(B, mode):
    D = B.shape[-1]
    launch = kernel_entry('gj_inverse', 'pb_gj_inverse', _INVERSE_ARGTYPES)
    inv = torch.empty_like(B)
    logdet = torch.empty(B.shape[:-2], dtype=torch.float32, device=B.device)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = launch(B.data_ptr(), inv.data_ptr(), logdet.data_ptr(),
                     B.numel() // (D * D), D, mode, stream)
    check_launch(err, 'gj_inverse')
    return inv, logdet


def hermitian_inverse_and_logdet_2d(B):
    """K3: (..., D, D) complex64 Hermitian PD -> (inverse, logdet), pivot
    floored at ``FLT_MIN`` for the log and the reciprocal.  No pivoting:
    the caller ensures positive definiteness (diagonal loading)."""
    _check(B)
    if B.device.type == 'cpu':
        return hermitian_inverse_and_logdet_2d_reference(B)
    out = _launch(B, _FLT_MIN)
    hermitian_inverse_and_logdet_2d.launches += 1
    return out


hermitian_inverse_and_logdet_2d.launches = 0


def hermitian_inverse_and_logdet(B):
    """K4: as :func:`hermitian_inverse_and_logdet_2d`, with the log floored
    at 1e-38 and the reciprocal of the unfloored pivot."""
    _check(B)
    if B.device.type == 'cpu':
        return hermitian_inverse_and_logdet_reference(B)
    out = _launch(B, _FLUSHED_LOG)
    hermitian_inverse_and_logdet.launches += 1
    return out


hermitian_inverse_and_logdet.launches = 0


def gauss_jordan_inverse_and_logdet(B):
    """The relative-floor Gauss-Jordan of ``ops/linalg.py`` on the kernel:
    (..., D, D) complex64 -> (inverse, logdet), pivots below ``max(diag) *
    eps`` floored there (complex pivots, the rounding residuals of row
    and column p kept, as the plain version keeps them)."""
    _check(B)
    if B.device.type == 'cpu':
        return gauss_jordan_inverse_and_logdet_reference(B)
    out = _launch(B, _RELATIVE)
    gauss_jordan_inverse_and_logdet.launches += 1
    return out


gauss_jordan_inverse_and_logdet.launches = 0


def hermitian_solve_gj(A, B, *, relative_load=None):
    """``linalg.hermitian_solve(A, B, relative_load=..., method='gj')``
    with the inverse of the loaded, equilibrated ``A`` by
    :func:`gauss_jordan_inverse_and_logdet`: A (..., d, d) complex64,
    d <= 32, B (..., d, e) -> X (..., d, e).  On the CPU it is that call,
    bit for bit."""
    _, As, Bs, sinv = equilibrate(A, B, relative_load)
    inv, _ = gauss_jordan_inverse_and_logdet(As)
    return sinv[..., :, None] * (inv @ Bs)


def _check_finalize(S, den, floor):
    if floor not in FLOORS:
        raise ValueError(f'floor must be one of {sorted(FLOORS)}, got '
                         f'{floor!r}')
    if S.dim() != 4 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f'expected S (F, K, D, D), got {tuple(S.shape)}')
    F, K, D, _ = S.shape
    if den.shape != (F, K):
        raise ValueError(f'expected den {(F, K)}, got {tuple(den.shape)}')
    if not (1 <= D <= MAX_D and 1 <= K <= MAX_K and F >= 1):
        raise ValueError(f'the finalize supports F >= 1, 1 <= K <= {MAX_K}, '
                         f'1 <= D <= {MAX_D}; got {(F, K, D)}')
    if S.dtype != torch.complex64 or den.dtype != torch.float32:
        raise ValueError(f'expected complex64 S and float32 den, got '
                         f'{S.dtype} and {den.dtype}')
    if not (S.is_contiguous() and den.is_contiguous()):
        raise ValueError('S and den must be contiguous')
    _check_device(S, den)


def em_finalize(S, den, *, diagonal_floor, floor='relative'):
    """The EM finalize in one launch: accumulated scatter S (F, K, D, D)
    complex64 and den (F, K) float32 -> (log_weight (F, K), precision
    (F, K, D, D), logdet (F, K)), with the inverse's pivot ``floor``
    ``'relative'`` (the default EM inverse) or ``'flt_min'`` (K3's, the
    EM's ``'pallas_gj'``); see :func:`em_finalize_reference`."""
    _check_finalize(S, den, floor)
    if S.device.type == 'cpu':
        return em_finalize_reference(S, den, diagonal_floor=diagonal_floor,
                                     floor=floor)
    F, K, D, _ = S.shape
    launch = kernel_entry('gj_inverse', 'pb_em_finalize', _FINALIZE_ARGTYPES)
    precision = torch.empty_like(S)
    logdet = torch.empty_like(den)
    log_weight = torch.empty_like(den)
    with torch.cuda.device(S.device):
        stream = torch.cuda.current_stream(S.device).cuda_stream
        err = launch(S.data_ptr(), den.data_ptr(), precision.data_ptr(),
                     logdet.data_ptr(), log_weight.data_ptr(), F, K, D,
                     FLOORS[floor], diagonal_floor, _denom_floor(D), stream)
    check_launch(err, 'em_finalize')
    em_finalize.launches += 1
    return log_weight, precision, logdet


em_finalize.launches = 0


def _gauss_jordan(B, floor_reciprocal):
    """The kernel's in-place Gauss-Jordan, one pivot step at a time over
    the whole batch."""
    D = B.shape[-1]
    tiny = torch.finfo(torch.float32).tiny
    M = B.clone()
    logdet = torch.zeros(B.shape[:-2], dtype=torch.float32, device=B.device)
    for i in range(D):
        a = M[..., i, i].real
        if floor_reciprocal:
            pv = lg = torch.clamp_min(a, tiny)
        else:
            pv, lg = a, torch.where(a < tiny, torch.zeros_like(a), a)
        logdet = logdet + torch.log(lg)
        inv = (1.0 / pv)[..., None]
        row = M[..., i, :].clone()
        row[..., i] = 1
        row = torch.complex(row.real * inv, row.imag * inv)
        col = M[..., :, i].clone()
        col[..., i] = 0
        M[..., :, i] = 0
        M = M - col[..., :, None] * row[..., None, :]
        M[..., i, :] = row
    return M, logdet


def hermitian_inverse_and_logdet_2d_reference(B):
    """Plain PyTorch version of :func:`hermitian_inverse_and_logdet_2d`."""
    return _gauss_jordan(B, floor_reciprocal=True)


def hermitian_inverse_and_logdet_reference(B):
    """Plain PyTorch version of :func:`hermitian_inverse_and_logdet`."""
    return _gauss_jordan(B, floor_reciprocal=False)


def _denom_floor(D):
    """The overflow-aware floor of den: D / tiny is inf in float32, and an
    empty class (den == 0, S == 0) must give cov 0 (+ jitter), not
    0 * inf = NaN."""
    return 2.0 * D / torch.finfo(torch.float32).max


def trace_normalize(cov):
    """Scale each class covariance to trace == D; numerically zero
    covariances (a class silent in the whole window) become I."""
    D = cov.shape[-1]
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1).real[..., None, None] \
        / D
    is_zero = tr <= torch.finfo(tr.dtype).tiny
    eye = torch.eye(D, dtype=cov.dtype, device=cov.device)
    return torch.where(
        is_zero, eye,
        cov / torch.where(is_zero, torch.ones_like(tr), tr).to(cov.dtype))


def add_jitter(cov, diagonal_floor):
    """``cov + max(diagonal_floor * trace / D, tiny) I``: the EM's
    conditioning floor before its inverse."""
    D = cov.shape[-1]
    tiny = torch.finfo(cov.real.dtype).tiny
    tr = torch.diagonal(cov, dim1=-2, dim2=-1).sum(-1).real
    jitter = torch.clamp_min(diagonal_floor * tr / D, tiny)
    return cov + jitter[..., None, None].to(cov.dtype) \
        * torch.eye(D, dtype=cov.dtype, device=cov.device)


def em_covariances(S, den):
    """The EM finalize before its jitter and inverse (the ``finalize`` of
    the JAX fused-kernel EM): S (F, K, D, D), den (F, K) -> (log_weight
    (F, K), trace-normalized Hermitian covariances (F, K, D, D))."""
    D = S.shape[-1]
    finfo = torch.finfo(torch.float32)
    total = den.sum(dim=-1, keepdim=True)
    weight = torch.where(total > 0, den / torch.clamp_min(total, finfo.tiny),
                         torch.zeros_like(den))
    log_weight = torch.log(torch.clamp_min(weight, finfo.tiny))
    cov = trace_normalize(hermitize(
        S * (D / torch.clamp_min(den, _denom_floor(D)))[..., None, None]
        .to(S.dtype)))
    return log_weight, cov


def em_finalize_reference(S, den, *, diagonal_floor, floor='relative'):
    """Plain PyTorch version of :func:`em_finalize`: :func:`em_covariances`,
    :func:`add_jitter`, then the relative-floor Gauss-Jordan of
    ``ops/linalg.py`` or K3's plain version."""
    log_weight, cov = em_covariances(S, den)
    cov = add_jitter(cov, diagonal_floor)
    if floor == 'relative':
        precision, logdet = gauss_jordan_inverse_and_logdet_reference(cov)
    else:
        precision, logdet = hermitian_inverse_and_logdet_2d_reference(cov)
    return log_weight, precision, logdet
