"""Batched SPD solve by blocked Cholesky — wrappers of the CUDA kernel
``csrc/chol_solve.cu`` (the port of the Pallas TPU kernel
``pb_chime5_tpu/ops/pallas/chol_solve.py::_kernel``) and their plain
PyTorch versions.

* :func:`chol_solve_real_spd` solves ``A2 X = B2`` for real SPD A2
  (F, S, S) float32, ``S % 32 == 0`` (padding rows carry an uncoupled
  identity block), B2 (F, S, E) float32: unpivoted right-looking Cholesky
  in 32-wide panels, each pivot floored at ``FLT_MIN`` before its square
  root, then forward and back substitution applying each diagonal block
  by its explicit inverse.
* :func:`hermitian_solve_pallas` is the JAX drop-in for
  ``ops/linalg.py::hermitian_solve`` on complex Hermitian PD batches: the
  equilibration, hermitize and diagonal load of that solve
  (``linalg.equilibrate``, as the JAX wrapper copies them), the system
  in its real block form ``[[Ar, -Ai], [Ai, Ar]]`` padded with an identity
  block to a multiple of 32, one solve, the scaling undone.  The TPU's
  padding of E to 128 lanes is not carried over.

For CUDA tensors an entry launches the kernel, for CPU tensors it runs
the plain version (``..._reference``, the same algorithm step by step,
with the same floor, its products as ``torch.matmul``); any other
placement, dtype, layout or size raises, and a failed build or launch
raises.  Each entry's ``launches`` counts its kernel launches (never
plain-version calls).  No configuration of the chain reaches K5, in the
JAX package either: the WPE solve is ``linalg.hermitian_solve``.
"""

import ctypes

import torch

from pb_chime5_tpu_torch.ops.kernels._build import check_launch, kernel_entry
from pb_chime5_tpu_torch.ops.linalg import equilibrate

__all__ = ['chol_solve_real_spd', 'hermitian_solve_pallas',
           'chol_solve_real_spd_reference', 'hermitian_solve_pallas_reference',
           'real_block_form', 'max_rows', 'BLOCK']

BLOCK = 32                  # panel width (kB in csrc/chol_solve.cu)
_SMEM_FLOATS = 232448 // 4  # the largest shared memory of one block

_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)


def max_rows(E: int) -> int:
    """The largest S the kernel takes for E right-hand sides: the panel
    (32 S), the block inverse, the right-hand sides (S E) and one solved
    block (32 E) must fit one block's shared memory."""
    S = (_SMEM_FLOATS - BLOCK * BLOCK - BLOCK * E) // (BLOCK + E)
    return S // BLOCK * BLOCK


def _check(A2, B2):
    if A2.dim() != 3 or B2.dim() != 3 or A2.shape[1] != A2.shape[2] \
            or B2.shape[:2] != A2.shape[:2]:
        raise ValueError(f'expected A2 (F, S, S) and B2 (F, S, E), got '
                         f'{tuple(A2.shape)} and {tuple(B2.shape)}')
    F, S, _ = A2.shape
    E = B2.shape[2]
    if min(F, S, E) < 1:
        raise ValueError(f'empty input: F={F}, S={S}, E={E}')
    if S % BLOCK:
        raise ValueError(f'S={S} is not a multiple of {BLOCK}')
    if S > max_rows(E):
        raise ValueError(f'S={S} with E={E} right-hand sides exceeds the '
                         f'kernel\'s shared memory (S <= {max_rows(E)})')
    for name, x in (('A2', A2), ('B2', B2)):
        if x.dtype != torch.float32:
            raise ValueError(f'{name}: expected float32, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if B2.device != A2.device:
        raise ValueError(f'B2 is on {B2.device}, A2 on {A2.device}')
    if A2.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {A2.device}')
    return F, S, E


def _solve(A2, B2, entry):
    """The kernel for CUDA tensors (counted on ``entry``), the plain
    version for CPU tensors."""
    F, S, E = _check(A2, B2)
    if A2.device.type == 'cpu':
        return chol_solve_real_spd_reference(A2, B2)
    launch = kernel_entry('chol_solve', 'pb_chol_solve', _ARGTYPES)
    work = torch.empty_like(A2)
    X2 = torch.empty_like(B2)
    with torch.cuda.device(A2.device):
        stream = torch.cuda.current_stream(A2.device).cuda_stream
        err = launch(A2.data_ptr(), B2.data_ptr(), work.data_ptr(),
                     X2.data_ptr(), F, S, E, stream)
    check_launch(err, 'chol_solve')
    entry.launches += 1
    return X2


def chol_solve_real_spd(A2, B2):
    """K5: A2 (F, S, S) float32 SPD, S % 32 == 0, B2 (F, S, E) float32
    -> X (F, S, E) float32 with ``A2 X = B2``.  No pivoting: the caller
    ensures positive definiteness (equilibration and a diagonal load)."""
    return _solve(A2, B2, chol_solve_real_spd)


chol_solve_real_spd.launches = 0


def real_block_form(As, Bs):
    """Complex Hermitian (F, D, D) and (F, D, E) -> the real SPD block
    form ``[[Ar, -Ai], [Ai, Ar]]`` (F, S, S) and ``[Br; Bi]`` (F, S, E),
    float32, S = 2 D rounded up to a multiple of 32 with an identity
    block (and zero right-hand sides) in the padding."""
    F, D, _ = As.shape
    E = Bs.shape[-1]
    S0 = 2 * D
    S = -(-S0 // BLOCK) * BLOCK
    Ar = As.real.to(torch.float32)
    Ai = As.imag.to(torch.float32)
    A2 = torch.zeros((F, S, S), dtype=torch.float32, device=As.device)
    A2[:, :D, :D] = Ar
    A2[:, :D, D:S0] = -Ai
    A2[:, D:S0, :D] = Ai
    A2[:, D:S0, D:S0] = Ar
    A2[:, S0:, S0:] = torch.eye(S - S0, device=As.device)
    B2 = torch.zeros((F, S, E), dtype=torch.float32, device=As.device)
    B2[:, :D] = Bs.real.to(torch.float32)
    B2[:, D:S0] = Bs.imag.to(torch.float32)
    return A2, B2


def _hermitian_solve(A, B, relative_load, solve):
    D = A.shape[-1]
    _, As, Bs, sinv = equilibrate(A, B, relative_load)
    X2 = solve(*real_block_form(As, Bs))
    X = torch.complex(X2[:, :D], X2[:, D:2 * D]).to(A.dtype)
    return sinv[..., :, None] * X


def hermitian_solve_pallas(A, B, *, relative_load=None):
    """Drop-in for ``linalg.hermitian_solve`` on complex HPD batches,
    through K5.  A (F, D, D) complex, B (F, D, E) complex -> X (F, D, E)
    of A's dtype (solved in float32)."""
    return _hermitian_solve(
        A, B, relative_load,
        lambda A2, B2: _solve(A2, B2, hermitian_solve_pallas))


hermitian_solve_pallas.launches = 0


def _factor_block(P):
    """The kernel's 32-step factorization of the (F, 32, 32) diagonal
    block; returns inv(L11) (lower triangular)."""
    P = P.clone()
    inv = torch.zeros_like(P)
    tiny = torch.finfo(P.dtype).tiny
    rows = torch.arange(BLOCK, device=P.device)
    for p in range(BLOCK):
        col = P[:, :, p]
        rpiv = torch.sqrt(torch.clamp_min(col[:, p], tiny))[:, None]
        lcol = torch.where(rows >= p, col, torch.zeros_like(col)) / rpiv
        P[:, :, p + 1:] -= lcol[:, :, None] * lcol[:, None, p + 1:]
        P[:, :, p] = lcol
        e = (rows == p).to(P.dtype)
        inv[:, p, :] = (e - (P[:, p:p + 1, :p] @ inv[:, :p, :])[:, 0]) / rpiv
    return inv


def chol_solve_real_spd_reference(A2, B2):
    """Plain PyTorch version of :func:`chol_solve_real_spd` (any device):
    the TPU kernel's panels, step by step."""
    F, S, _ = A2.shape
    T = A2.clone()
    invs, below, right = [], [], []      # inv(L11), L21, L21^T per panel
    for c0 in range(0, S, BLOCK):
        c1 = c0 + BLOCK
        inv = _factor_block(T[:, c0:c1, c0:c1])
        invs.append(inv)
        if c1 < S:
            L21 = T[:, c1:, c0:c1] @ inv.transpose(-2, -1)
            L21T = inv @ T[:, c0:c1, c1:]
            below.append(L21)
            right.append(L21T)
            T[:, c1:, c1:] -= L21 @ L21T
    Y = B2.clone()
    for j, c0 in enumerate(range(0, S, BLOCK)):
        c1 = c0 + BLOCK
        yj = invs[j] @ Y[:, c0:c1]
        Y[:, c0:c1] = yj
        if c1 < S:
            Y[:, c1:] -= below[j] @ yj
    X = torch.empty_like(B2)
    for j in reversed(range(S // BLOCK)):
        c0, c1 = j * BLOCK, (j + 1) * BLOCK
        xj = invs[j].transpose(-2, -1) @ Y[:, c0:c1]
        X[:, c0:c1] = xj
        # L^T's block column j above the diagonal: the L21^T of every
        # earlier panel, at its columns of panel j
        for k in range(j):
            r0 = k * BLOCK
            Y[:, r0:r0 + BLOCK] -= \
                right[k][:, :, c0 - r0 - BLOCK:c1 - r0 - BLOCK] @ xj
    return X


def hermitian_solve_pallas_reference(A, B, *, relative_load=None):
    """Plain PyTorch version of :func:`hermitian_solve_pallas` (any
    device)."""
    return _hermitian_solve(A, B, relative_load,
                            chol_solve_real_spd_reference)
