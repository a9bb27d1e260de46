"""Fused cacGMM E+M accumulation — wrapper of the CUDA kernel
``csrc/fused_em.cu`` (the port of the Pallas TPU kernel
``pb_chime5_tpu/ops/pallas/fused_em.py::_kernel``) and its plain PyTorch
version.

:func:`fused_em_scatter` launches the kernel for CUDA tensors and runs
:func:`fused_em_scatter_reference` for CPU tensors; for any other
placement, dtype, layout or size it raises.  Nothing falls back: a
failed build or launch raises.  ``fused_em_scatter.launches`` counts
kernel launches (never reference calls).  A batch of B utterances is
one launch over their B * F rows, each utterance with its own class gate
``act`` (B, K, T) and frame mask ``fm`` (B, T): the counterpart of the
JAX package's ``vmap`` of the Pallas call.

The kernel forms q_kt as this plain version does (the rows of P_k z_t,
then the conjugate dot), so that it rounds as the plain version rounds,
and accumulates S in the Hermitian form: :func:`frame_features` states
in plain PyTorch the layout of the D^2 real features of z z^H that it
forms per valid frame and in which it sums S's lower triangle.
"""

import ctypes

import torch

from pb_chime5_tpu_torch.ops.kernels._build import check_launch, kernel_entry

__all__ = ['fused_em_scatter', 'fused_em_scatter_reference', 'frame_features',
           'quadratic_form', 'MAX_D', 'MAX_K', 'CHUNK', 'CLUSTER']

# the kernel's compile-time bounds (kMaxD / kMaxK in csrc/fused_em.cu,
# whose launcher also rejects anything outside them): 6 arrays x 4 mics,
# 4 speakers + the noise class
MAX_D = 24
MAX_K = 5
# how the kernel splits T (kChunk / kCluster): frames 32c .. 32c + 31 form
# chunk c, which the CTA of rank c % 2 in the frequency's cluster takes
CHUNK = 32
CLUSTER = 2


_ARGTYPES = (ctypes.c_void_p,) * 8 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)


def _check(z, params, act, fm):
    """(F, T, D, K, B) of a valid call: F rows in all (B utterances of
    F / B rows each), B = 1 for an unbatched ``act`` (K, T)."""
    log_weight, precision, logdet = params
    if z.dim() != 3:
        raise ValueError(f'z must be (F, T, D), got {tuple(z.shape)}')
    F, T, D = z.shape
    K = log_weight.shape[-1]
    if not 1 <= D <= MAX_D or not 1 <= K <= MAX_K:
        raise ValueError(
            f'fused_em_scatter supports 1 <= D <= {MAX_D} and '
            f'1 <= K <= {MAX_K}; got D={D}, K={K}')
    batched = act.dim() == 3
    B = act.shape[0] if batched else 1
    if F % B:
        raise ValueError(f'{F} rows do not split into {B} utterances')
    expected = {
        'z': (z, torch.complex64, (F, T, D)),
        'log_weight': (log_weight, torch.float32, (F, K)),
        'precision': (precision, torch.complex64, (F, K, D, D)),
        'logdet': (logdet, torch.float32, (F, K)),
        'act': (act, torch.float32, (B, K, T) if batched else (K, T)),
        'fm': (fm, torch.float32, (B, T) if batched else (T,)),
    }
    for name, (x, dtype, shape) in expected.items():
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f'{name}: expected {dtype} {shape}, got {x.dtype} '
                f'{tuple(x.shape)}')
        if x.device != z.device:
            raise ValueError(f'{name} is on {x.device}, z on {z.device}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    return F, T, D, K, B


def fused_em_scatter(z, params, act, fm):
    """One fused E+M accumulation pass.

    z (F, T, D) complex64 unit-norm observations; params = (log_weight
    (F, K) float32, precision (F, K, D, D) complex64, logdet (F, K)
    float32); act (K, T) float32 class gate; fm (T,) float32 frame mask.
    Batched: the F rows are B utterances' F / B rows each, act (B, K, T)
    and fm (B, T) each utterance's; one launch for the batch, and B = 1
    gives the unbatched call's numbers bit for bit.
    Returns (S (F, K, D, D) complex64 — without the 1/den_k and D
    factors — and den (F, K) float32).
    """
    F, T, D, K, B = _check(z, params, act, fm)
    if z.device.type == 'cpu':
        return fused_em_scatter_reference(z, params, act, fm)
    if z.device.type != 'cuda':
        raise ValueError(f'unsupported device {z.device}')
    log_weight, precision, logdet = params
    launch = kernel_entry('fused_em', 'pb_fused_em_scatter_batched',
                          _ARGTYPES)
    S = torch.empty((F, K, D, D), dtype=torch.complex64, device=z.device)
    den = torch.empty((F, K), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        stream = torch.cuda.current_stream(z.device).cuda_stream
        err = launch(z.data_ptr(), precision.data_ptr(), log_weight.data_ptr(),
                     logdet.data_ptr(), act.data_ptr(), fm.data_ptr(),
                     S.data_ptr(), den.data_ptr(), F, T, D, K, F // B,
                     stream)
    check_launch(err, 'fused_em')
    fused_em_scatter.launches += 1
    return S, den


fused_em_scatter.launches = 0


def _lower_pairs(D, device):
    """Row and column of the pairs d > e of a D x D lower triangle, in
    row-major order."""
    return torch.tril_indices(D, D, -1, device=device).unbind(0)


def frame_features(z):
    """(..., D) complex -> (..., D^2) real: Re and Im of z_d conj(z_e) for
    each pair d > e in row-major order, interleaved, then |z_d|^2 for each
    d.  The kernel forms these per valid frame and sums S's lower
    triangle in this layout."""
    d, e = _lower_pairs(z.shape[-1], z.device)
    m = z[..., d] * z[..., e].conj()
    off = torch.stack((m.real, m.imag), dim=-1).flatten(-2)
    return torch.cat((off, z.real ** 2 + z.imag ** 2), dim=-1)


def quadratic_form(z, precision):
    """Re(z_t^H P_k z_t) by the full complex product: z (F, T, D),
    precision (F, K, D, D) -> (F, K, T)."""
    vz = torch.einsum('fkde,fte->fktd', precision, z)
    return (vz * z.conj()[:, None]).real.sum(dim=-1)


def fused_em_scatter_reference(z, params, act, fm):
    """Plain PyTorch version of :func:`fused_em_scatter` (same formula,
    batched einsums over (F, K, T, D)); act (B, K, T) and fm (B, T) of a
    batch gate their utterance's rows."""
    log_weight, precision, logdet = params
    F, _, D = z.shape
    if act.dim() == 3:
        act = act.repeat_interleave(F // act.shape[0], dim=0)
        fm = fm.repeat_interleave(F // fm.shape[0], dim=0)[:, None, :]
    tiny = torch.finfo(torch.float32).tiny
    q = torch.clamp_min(quadratic_form(z, precision), tiny)
    log_pdf = log_weight[..., None] - D * torch.log(q) - logdet[..., None]
    log_pdf = log_pdf - log_pdf.amax(dim=1, keepdim=True)
    gamma = torch.exp(log_pdf) * act
    gamma = gamma / torch.clamp_min(gamma.sum(dim=1, keepdim=True), tiny)
    gamma = gamma * fm
    weighted = z[:, None] * (gamma / q)[..., None]        # (F, K, T, D)
    S = weighted.transpose(-2, -1) @ z.conj()[:, None]    # (F, K, D, D)
    return S, gamma.sum(dim=-1)
