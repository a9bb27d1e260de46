"""Batched Hermitian / SPD solve by blocked Cholesky — wrappers of the
CUDA kernel ``csrc/chol_solve.cu`` (the port of the Pallas TPU kernel
``pb_chime5_tpu/ops/pallas/chol_solve.py::_kernel``, K5) and their plain
PyTorch versions.  One kernel, two instantiations:

* :func:`hermitian_solve_chol` (complex) is the WPE filter solve of the
  default path: JAX's ``ops/linalg.py::hermitian_solve(A, B,
  relative_load=..., method='chol', refine=...)`` in one launch — the
  equilibration of ``linalg.equilibrate`` (scales floored at ``eps *
  max(diag)``, an all-zero matrix unscaled), the hermitize and diagonal
  load, the padding to a multiple of 32 with an identity block,
  ``_cholesky_panels`` with each pivot floored relative to the matrix at
  ``eps^2 * max(diag)`` (the padding's ones counted), ``_solve_from_panels``,
  ``refine`` refinement steps against the unloaded matrix, the unscale.
  A (F, d, d) complex64, 32 < d <= 256, B (F, d, E) complex64.
* :func:`chol_solve_real_spd` (real) is the TPU kernel's function: A2
  (F, S, S) float32 SPD, ``S % 32 == 0`` (padding rows carry an uncoupled
  identity block), B2 (F, S, E) float32, each pivot floored at
  ``FLT_MIN``.  :func:`hermitian_solve_pallas` is the JAX wrapper of that
  kernel: the equilibrated, loaded complex system in its real block form
  ``[[Ar, -Ai], [Ai, Ar]]`` padded to a multiple of 32, one solve, the
  scaling undone (the TPU's padding of E to 128 lanes is not carried
  over).  No configuration of the chain calls these two.

For CUDA tensors an entry launches the kernel, for CPU tensors it runs
its plain version (``..._reference``: the JAX functions step by step,
the same floors, the products as ``torch.matmul``); any other placement,
dtype, layout or size raises, and a failed build or launch raises.  Each
entry's ``launches`` counts its kernel launches (never plain-version
calls).
"""

import ctypes

import torch

from pb_chime5_tpu_torch.ops.kernels._build import check_launch, kernel_entry
from pb_chime5_tpu_torch.ops.linalg import equilibrate

__all__ = ['hermitian_solve_chol', 'chol_solve_real_spd',
           'hermitian_solve_pallas', 'hermitian_solve_chol_reference',
           'chol_solve_real_spd_reference', 'hermitian_solve_pallas_reference',
           'real_block_form', 'supports', 'max_rows', 'BLOCK', 'MAX_D']

BLOCK = 32                  # panel width (kB in csrc/chol_solve.cu)
MAX_D = 256                 # the complex instantiation's largest d
_SMEM_BYTES = 232448        # the largest shared memory of one block
_WARPS = 8                  # kThreads / 32 in csrc/chol_solve.cu

_REAL_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 \
    + (ctypes.c_void_p,)
_COMPLEX_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3 \
    + (ctypes.c_float, ctypes.c_int, ctypes.c_void_p)


def _padded(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _smem_bytes(n: int, E: int, complex_form: bool) -> int:
    """The kernel's dynamic shared memory (``smem_bytes`` in the source):
    the panel (32 rows of n_p - 32 elements and 16 bytes; the complex form
    a second one, for A21), the diagonal block and its inverse (complex:
    in float64), the right-hand sides (n_p x E), one solved block
    (32 x E), the block reduction and the pivot roots; the complex form
    adds the scales."""
    dp = _padded(n)
    size = 8 if complex_form else 4
    elems = (2 if complex_form else 1) * BLOCK * (dp - BLOCK + 16 // size) \
        + dp * E + BLOCK * E
    wide = 2 * size                     # float64 (complex) / float32 (real)
    return size * elems + (wide if complex_form else size) * 2 * BLOCK ** 2 \
        + 4 * ((dp if complex_form else 0) + _WARPS + BLOCK)


def max_rows(E: int) -> int:
    """The largest S the real instantiation takes for E right-hand sides
    (its shared memory must fit one block)."""
    S = BLOCK
    while _smem_bytes(S + BLOCK, E, False) <= _SMEM_BYTES:
        S += BLOCK
    return S


def supports(d: int, E: int) -> bool:
    """Whether :func:`hermitian_solve_chol` takes d x d systems with E
    right-hand sides: ``32 < d <= 256`` and its shared memory fits."""
    return BLOCK < d <= MAX_D and E >= 1 \
        and _smem_bytes(d, E, True) <= _SMEM_BYTES


def _check_pair(A, B, dtype, names):
    if A.dim() != 3 or B.dim() != 3 or A.shape[1] != A.shape[2] \
            or B.shape[:2] != A.shape[:2]:
        raise ValueError(f'expected {names[0]} (F, n, n) and {names[1]} '
                         f'(F, n, E), got {tuple(A.shape)} and '
                         f'{tuple(B.shape)}')
    F, n, _ = A.shape
    E = B.shape[2]
    if min(F, n, E) < 1:
        raise ValueError(f'empty input: F={F}, n={n}, E={E}')
    for name, x in zip(names, (A, B)):
        if x.dtype != dtype:
            raise ValueError(f'{name}: expected {dtype}, got {x.dtype}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if B.device != A.device:
        raise ValueError(f'{names[1]} is on {B.device}, {names[0]} on '
                         f'{A.device}')
    if A.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {A.device}')
    return F, n, E


def _check(A2, B2):
    F, S, E = _check_pair(A2, B2, torch.float32, ('A2', 'B2'))
    if S % BLOCK:
        raise ValueError(f'S={S} is not a multiple of {BLOCK}')
    if S > max_rows(E):
        raise ValueError(f'S={S} with E={E} right-hand sides exceeds the '
                         f'kernel\'s shared memory (S <= {max_rows(E)})')
    return F, S, E


def _work(A, n):
    nb = _padded(n) // BLOCK
    return torch.empty((A.shape[0], nb * (nb + 1) // 2, BLOCK, BLOCK),
                       dtype=A.dtype, device=A.device)


def _solve(A2, B2, entry):
    """The kernel for CUDA tensors (counted on ``entry``), the plain
    version for CPU tensors."""
    F, S, E = _check(A2, B2)
    if A2.device.type == 'cpu':
        return chol_solve_real_spd_reference(A2, B2)
    launch = kernel_entry('chol_solve', 'pb_chol_solve', _REAL_ARGTYPES)
    work = _work(A2, S)
    X2 = torch.empty_like(B2)
    with torch.cuda.device(A2.device):
        stream = torch.cuda.current_stream(A2.device).cuda_stream
        err = launch(A2.data_ptr(), B2.data_ptr(), work.data_ptr(),
                     X2.data_ptr(), F, S, E, stream)
    check_launch(err, 'chol_solve')
    entry.launches += 1
    return X2


def hermitian_solve_chol(A, B, *, relative_load=None, refine: int = 0):
    """A (F, d, d) complex64 Hermitian, 32 < d <= 256, B (F, d, E)
    complex64 -> X (F, d, E) complex64: JAX's ``hermitian_solve(A, B,
    relative_load=..., method='chol', refine=...)`` (``relative_load``
    None: 64 eps) in one launch; see :func:`hermitian_solve_chol_reference`.
    """
    F, d, E = _check_pair(A, B, torch.complex64, ('A', 'B'))
    if not supports(d, E):
        raise ValueError(f'd={d}, E={E}: the kernel takes {BLOCK} < d <= '
                         f'{MAX_D} and a shared memory of at most '
                         f'{_SMEM_BYTES} bytes')
    if isinstance(refine, bool) or not isinstance(refine, int) \
            or refine < 0:
        raise ValueError(f'refine must be a non-negative int, got {refine!r}')
    if relative_load is None:
        relative_load = 64 * torch.finfo(torch.float32).eps
    if A.device.type == 'cpu':
        return hermitian_solve_chol_reference(
            A, B, relative_load=relative_load, refine=refine)
    launch = kernel_entry('chol_solve', 'pb_hermitian_solve_chol',
                          _COMPLEX_ARGTYPES)
    work = _work(A, d)
    X = torch.empty_like(B)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = launch(A.data_ptr(), B.data_ptr(), work.data_ptr(),
                     X.data_ptr(), F, d, E, float(relative_load), refine,
                     stream)
    check_launch(err, 'chol_solve')
    hermitian_solve_chol.launches += 1
    return X


hermitian_solve_chol.launches = 0


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
    S = _padded(S0)
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
    through the real instantiation.  A (F, D, D) complex, B (F, D, E)
    complex -> X (F, D, E) of A's dtype (solved in float32)."""
    return _hermitian_solve(
        A, B, relative_load,
        lambda A2, B2: _solve(A2, B2, hermitian_solve_pallas))


hermitian_solve_pallas.launches = 0


# ---- plain versions --------------------------------------------------------

def _factor_block(P):
    """The TPU kernel's 32-step factorization of the (F, 32, 32) real
    diagonal block; returns inv(L11) (lower triangular)."""
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


def _div_real(z, r):
    """z / r for real r, each part divided (as XLA divides a complex value
    by a real one)."""
    return torch.complex(z.real / r, z.imag / r)


def _parts(A, B, conj_a, conj_b, dtype):
    """The real and imaginary parts of A and B in ``dtype``, conjugated on
    request."""
    ar, ai = A.real.to(dtype), A.imag.to(dtype)
    br, bi = B.real.to(dtype), B.imag.to(dtype)
    return ar, -ai if conj_a else ai, br, -bi if conj_b else bi


def _sum(A, B, conj_a, conj_b, dtype):
    """A (..., m, K) B (..., K, n), A or B conjugated on request, in
    ``dtype``: each term's real products added to the sum in ascending k
    and in a fixed order (re += ar br, re -= ai bi, im += ar bi,
    im += ai br), rounded to A's dtype at the end."""
    ar, ai, br, bi = _parts(A, B, conj_a, conj_b, dtype)
    shape = A.shape[:-1] + B.shape[-1:]
    re = torch.zeros(shape, dtype=dtype, device=A.device)
    im = torch.zeros_like(re)
    for k in range(A.shape[-1]):
        a_r, a_i = ar[..., :, k, None], ai[..., :, k, None]
        b_r, b_i = br[..., None, k, :], bi[..., None, k, :]
        re = re + a_r * b_r
        re = re - a_i * b_i
        im = im + a_r * b_i
        im = im + a_i * b_r
    return torch.complex(re, im).to(A.dtype)


def _dot(A, B, *, conj_a=False, conj_b=False):
    """:func:`_sum` in float64, rounded once: the kernel's fused float64
    multiply-adds, which round as these separate steps do (the product of
    two float32 values is exact in float64).  The products whose
    accuracy the solve needs: the diagonal block's steps, L21 and the
    applications of inv(L11)."""
    return _sum(A, B, conj_a, conj_b, torch.float64)


def _dot_own(A, B, *, conj_a=False, conj_b=False):
    """:func:`_sum` in A's own precision, each product and sum rounded
    (the kernel fuses no multiply-add here): the trailing update and the
    substitutions' long sums, the bulk of the work, where float32 sums
    keep the solve as accurate as LAPACK's on WPE statistics (PERF.md)."""
    return _sum(A, B, conj_a, conj_b, A.real.dtype)


def _factor_panel(panel, pivfloor):
    """JAX's ``_cholesky_panels.factor_panel`` on the (F, b, b) complex
    diagonal block: b steps building L11 and inv(L11) row by row, the
    multipliers taken from the masked column ``lcol``, never from the
    pivot row.  Returns (L11, inv(L11)), both lower triangular."""
    P = panel.clone()
    b = P.shape[-1]
    Inv = torch.zeros_like(P)
    rows = torch.arange(b, device=P.device)
    for p in range(b):
        col = P[:, :, p]
        rpiv = torch.sqrt(torch.maximum(col[:, p].real, pivfloor))[:, None]
        lcol = _div_real(torch.where(rows >= p, col, torch.zeros_like(col)),
                         rpiv)
        P[:, :, p + 1:] = P[:, :, p + 1:] - _dot(
            lcol[:, :, None], lcol[:, None, p + 1:], conj_b=True)
        P[:, :, p] = lcol
        # row p of inv(L11): (e_p - L[p, :p] inv(L11)[:p, :]) / r
        e = (rows == p).to(P.dtype)
        Inv[:, p, :] = _div_real(
            e - _dot(P[:, p:p + 1, :p], Inv[:, :p, :])[:, 0], rpiv)
    return P.tril(), Inv.tril()


def _cholesky_panels(A):
    """JAX's ``_cholesky_panels``: A (F, d, d) -> (col_blocks, inv_blocks),
    ``col_blocks[j]`` = [L11; L21] of block column j of the factor of A
    padded to a multiple of 32 with an identity block, each pivot floored
    at ``eps^2 * max(diag)`` of the padded matrix."""
    F, d, _ = A.shape
    dp = _padded(d)
    if dp > d:
        Ap = torch.zeros((F, dp, dp), dtype=A.dtype, device=A.device)
        Ap[:, :d, :d] = A
        Ap[:, d:, d:] = torch.eye(dp - d, dtype=A.dtype, device=A.device)
        A = Ap
    finfo = torch.finfo(A.real.dtype)
    diag0 = torch.diagonal(A, dim1=-2, dim2=-1).real
    pivfloor = torch.clamp_min(diag0.amax(dim=-1) * finfo.eps ** 2,
                               finfo.tiny)
    col_blocks, inv_blocks = [], []
    trailing = A
    for j in range(dp // BLOCK):
        L11, Inv11 = _factor_panel(trailing[:, :BLOCK, :BLOCK], pivfloor)
        inv_blocks.append(Inv11)
        if j < dp // BLOCK - 1:
            # L21 = A21 inv(L11)^H;  A22 - L21 L21^H
            L21 = _dot(trailing[:, BLOCK:, :BLOCK], Inv11.transpose(-2, -1),
                       conj_b=True)
            col_blocks.append(torch.cat([L11, L21], dim=-2))
            trailing = trailing[:, BLOCK:, BLOCK:] \
                - _dot_own(L21, L21.transpose(-2, -1), conj_b=True)
        else:
            col_blocks.append(L11)
    return col_blocks, inv_blocks


def _solve_from_panels(col_blocks, inv_blocks, B):
    """JAX's ``_solve_from_panels``: L L^H X = B from the panels, B
    zero-extended to the padded rows, which are dropped."""
    nb = len(col_blocks)
    F, d, E = B.shape
    dp = nb * BLOCK
    if dp > d:
        B = torch.cat([B, B.new_zeros((F, dp - d, E))], dim=-2)
    ys = []
    for j in range(nb):
        lo = j * BLOCK
        rhs = B[:, lo:lo + BLOCK]
        if j:
            lrow = torch.cat([col_blocks[k][:, lo - k * BLOCK:
                                            lo - k * BLOCK + BLOCK]
                              for k in range(j)], dim=-1)
            rhs = rhs - _dot_own(lrow, torch.cat(ys, dim=-2))
        ys.append(_dot(inv_blocks[j], rhs))
    xs = [None] * nb
    for j in reversed(range(nb)):
        rhs = ys[j]
        if j < nb - 1:
            below = col_blocks[j][:, BLOCK:]
            rhs = rhs - _dot_own(below.transpose(-2, -1),
                             torch.cat(xs[j + 1:], dim=-2), conj_a=True)
        xs[j] = _dot(inv_blocks[j].transpose(-2, -1), rhs, conj_a=True)
    return torch.cat(xs, dim=-2)[:, :d]


def hermitian_solve_chol_reference(A, B, *, relative_load=None,
                                   refine: int = 0):
    """Plain PyTorch version of :func:`hermitian_solve_chol` (any device,
    complex64 or complex128): JAX's ``hermitian_solve(..., method='chol')``
    step by step — ``linalg.equilibrate``, the blocked-Cholesky panels,
    the panel substitutions, ``refine`` refinement steps against the
    unloaded equilibrated matrix, the unscale.  Every product of JAX's
    graph (a matmul, or the diagonal block's rank-1 and row updates) is a
    sum in a fixed order, in float64 (:func:`_dot`) or, for the trailing
    update and the substitutions' long sums, in A's dtype
    (:func:`_dot_own`), rounded to A's dtype once; the rest runs in A's
    dtype as JAX runs it.  The kernel repeats these operations one for
    one, so the two agree bit for bit.  In complex128 (no kernel) it is
    the float64 WPE solve's floored fallback (``ops/wpe.py::solve_floored``).
    (In float32 arithmetic these panels, with their explicit block
    inverses, are ~5x less accurate than LAPACK's Cholesky on WPE
    statistics: PERF.md, Findings.)"""
    As0, As, Bs, sinv = equilibrate(A, B, relative_load)
    col_blocks, inv_blocks = _cholesky_panels(As)
    X = _solve_from_panels(col_blocks, inv_blocks, Bs)
    for _ in range(refine):
        X = X + _solve_from_panels(col_blocks, inv_blocks,
                                   Bs - _dot(As0, X))
    return sinv[..., :, None] * X
