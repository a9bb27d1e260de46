"""Batched Gauss-Jordan inverse and log-determinant of Hermitian PD
matrices — wrappers of the CUDA kernel ``csrc/gj_inverse.cu`` (the port
of the Pallas TPU kernels ``pb_chime5_tpu/ops/pallas/gj_inverse2d.py::
_gj2d_kernel`` and ``pb_chime5_tpu/ops/pallas/hermitian_inverse.py::
_gj_kernel``) and their plain PyTorch versions.

The two entries take the JAX public layout, (..., D, D) complex64, and
return (inverse (..., D, D) complex64, logdet (...,) float32).  They
launch the same kernel and differ only in how the pivot is floored:

* :func:`hermitian_inverse_and_logdet_2d` (K3, the EM's
  ``bss_inverse='pallas_gj'``): ``p = max(Re a_ii, FLT_MIN)`` for both the
  log and the reciprocal;
* :func:`hermitian_inverse_and_logdet` (K4): ``log(max(Re a_ii, 1e-38))``
  and ``1 / Re a_ii``.  1e-38 is a float32 subnormal that XLA flushes to
  zero, so the JAX kernel's log floor runs as "below ``FLT_MIN`` -> 0"
  (a non-positive pivot gives a logdet of -inf); both versions here
  reproduce it as it runs.

For CUDA tensors the entry launches the kernel, for CPU tensors it runs
its ``..._reference`` plain version; any other placement, dtype, layout or
size raises.  Nothing falls back: a failed build or launch raises.  Each
entry's ``launches`` counts its kernel launches (never reference calls).
"""

import ctypes

import torch

from pb_chime5_tpu_torch.ops.kernels._build import check_launch, kernel_entry

__all__ = ['hermitian_inverse_and_logdet_2d', 'hermitian_inverse_and_logdet',
           'hermitian_inverse_and_logdet_2d_reference',
           'hermitian_inverse_and_logdet_reference', 'MAX_D']

MAX_D = 32           # kMaxD in csrc/gj_inverse.cu (its launcher rejects more)

_ARGTYPES = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


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
    if B.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {B.device}')


def _launch(B, floor_reciprocal):
    D = B.shape[-1]
    launch = kernel_entry('gj_inverse', 'pb_gj_inverse', _ARGTYPES)
    inv = torch.empty_like(B)
    logdet = torch.empty(B.shape[:-2], dtype=torch.float32, device=B.device)
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        err = launch(B.data_ptr(), inv.data_ptr(), logdet.data_ptr(),
                     B.numel() // (D * D), D, int(floor_reciprocal), stream)
    check_launch(err, 'gj_inverse')
    return inv, logdet


def hermitian_inverse_and_logdet_2d(B):
    """K3: (..., D, D) complex64 Hermitian PD -> (inverse, logdet), pivot
    floored at ``FLT_MIN`` for the log and the reciprocal.  No pivoting:
    the caller ensures positive definiteness (diagonal loading)."""
    _check(B)
    if B.device.type == 'cpu':
        return hermitian_inverse_and_logdet_2d_reference(B)
    out = _launch(B, floor_reciprocal=True)
    hermitian_inverse_and_logdet_2d.launches += 1
    return out


hermitian_inverse_and_logdet_2d.launches = 0


def hermitian_inverse_and_logdet(B):
    """K4: as :func:`hermitian_inverse_and_logdet_2d`, with the log floored
    at 1e-38 and the reciprocal of the unfloored pivot."""
    _check(B)
    if B.device.type == 'cpu':
        return hermitian_inverse_and_logdet_reference(B)
    out = _launch(B, floor_reciprocal=False)
    hermitian_inverse_and_logdet.launches += 1
    return out


hermitian_inverse_and_logdet.launches = 0


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
