"""WPE correlation statistics — wrapper of the CUDA kernel
``csrc/wpe_stats.cu`` (the port of the Pallas TPU kernel
``pb_chime5_tpu/ops/pallas/wpe_stats.py::_kernel``) and its plain PyTorch
version.

:func:`wpe_statistics` launches the kernel for CUDA tensors and runs
:func:`wpe_statistics_reference` for CPU tensors; for any other
placement, dtype, layout or size it raises.  Nothing falls back: a
failed build or launch raises.  ``wpe_statistics.launches`` counts kernel
launches (never reference calls).

Both versions sum T in two levels, float32 then float64 (the kernel in
64-frame spans, the plain version in ``TILE``-frame complex64 matmuls):
one float32 sum over all T left the second WPE iteration's R indefinite
past the 1e-4 load at T = 4191 (``ops/wpe.py``).

``ops/wpe.py`` takes the kernel by default for complex64 on CUDA without
``chunk_size``, and the plain version for ``stats_backend='xla'``, on
the CPU and for complex128 (``stats_route``).
"""

import ctypes

import torch

from pb_chime5_tpu_torch.ops.kernels._build import check_launch, kernel_entry

__all__ = ['wpe_statistics', 'wpe_statistics_reference',
           'accumulate_statistics', 'TILE']

_ARGTYPES = (ctypes.c_void_p,) * 5 + (ctypes.c_int,) * 4 + (ctypes.c_void_p,)
TILE = 256      # frames a tile of the plain version's T sum


def _check(Y_tilde, Y, inv_power):
    if Y_tilde.dim() != 3 or Y.dim() != 3:
        raise ValueError(f'expected Y_tilde (F, dim, T) and Y (F, D, T), got '
                         f'{tuple(Y_tilde.shape)} and {tuple(Y.shape)}')
    F, dim, T = Y_tilde.shape
    D = Y.shape[1]
    if min(F, dim, D, T) < 1:
        raise ValueError(f'empty input: F={F}, dim={dim}, D={D}, T={T}')
    expected = {
        'Y_tilde': (Y_tilde, torch.complex64, (F, dim, T)),
        'Y': (Y, torch.complex64, (F, D, T)),
        'inv_power': (inv_power, torch.float32, (F, T)),
    }
    for name, (x, dtype, shape) in expected.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f'{name}: expected {dtype} {shape}, got {x.dtype} '
                f'{tuple(x.shape)}')
        if x.device != Y_tilde.device:
            raise ValueError(f'{name} is on {x.device}, Y_tilde on '
                             f'{Y_tilde.device}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if Y_tilde.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {Y_tilde.device}')
    return F, dim, D, T


def wpe_statistics(Y_tilde, Y, inv_power):
    """R = sum_t w_t Ytilde_t Ytilde_t^H, P = sum_t w_t Ytilde_t Y_t^H in
    one pass.

    Y_tilde (F, dim, T) complex64, Y (F, D, T) complex64, inv_power (F, T)
    float32 -> (R (F, dim, dim), P (F, dim, D)) complex64, R not yet
    hermitized (as the JAX function returns it).  The kernel computes R's
    lower triangle and writes its conjugate mirror above the diagonal.
    """
    F, dim, D, T = _check(Y_tilde, Y, inv_power)
    if Y_tilde.device.type == 'cpu':
        return wpe_statistics_reference(Y_tilde, Y, inv_power)
    launch = kernel_entry('wpe_stats', 'pb_wpe_statistics', _ARGTYPES)
    R = torch.empty((F, dim, dim), dtype=torch.complex64,
                    device=Y_tilde.device)
    P = torch.empty((F, dim, D), dtype=torch.complex64, device=Y_tilde.device)
    with torch.cuda.device(Y_tilde.device):
        stream = torch.cuda.current_stream(Y_tilde.device).cuda_stream
        err = launch(Y_tilde.data_ptr(), Y.data_ptr(), inv_power.data_ptr(),
                     R.data_ptr(), P.data_ptr(), F, dim, D, T, stream)
    check_launch(err, 'wpe_stats')
    wpe_statistics.launches += 1
    return R, P


wpe_statistics.launches = 0


def wpe_statistics_reference(Y_tilde, Y, inv_power):
    """Plain PyTorch version of :func:`wpe_statistics`, and the
    statistics of ``stats_backend='xla'`` (and of the default on the CPU
    and for complex128): the weighted complex matmuls over T-tiles of
    ``TILE`` frames, each tile's product added into complex128 sums
    (:func:`accumulate_statistics`), rounded to the input's dtype once.
    One matmul over all T drifts from the float64 sums by ~sqrt(T)
    roundings; a tile by ~sqrt(TILE)."""
    F, dim, _ = Y_tilde.shape
    R = torch.zeros((F, dim, dim), dtype=torch.complex128,
                    device=Y_tilde.device)
    P = torch.zeros((F, dim, Y.shape[-2]), dtype=torch.complex128,
                    device=Y_tilde.device)
    accumulate_statistics(R, P, Y_tilde, Y, inv_power)
    return R.to(Y_tilde.dtype), P.to(Y_tilde.dtype)


def accumulate_statistics(R, P, Y_tilde, Y, inv_power):
    """R += sum_t w_t Ytilde_t Ytilde_t^H, P += sum_t w_t Ytilde_t Y_t^H:
    for complex64, one weighted matmul pair a tile of ``TILE`` frames,
    added into R and P (complex128); complex128 input, whose matmuls
    already sum in float64, as one pair over all its frames."""
    T = Y_tilde.shape[-1]
    tile = T if Y_tilde.dtype == torch.complex128 else TILE
    for t0 in range(0, T, tile):
        yt = Y_tilde[..., t0:t0 + tile]
        weighted = yt * inv_power[:, None, t0:t0 + tile].to(yt.dtype)
        R += weighted @ yt.conj().transpose(-2, -1)
        P += weighted @ Y[..., t0:t0 + tile].conj().transpose(-2, -1)
