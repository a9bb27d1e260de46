"""Batched linear algebra — port of ``pb_chime5_tpu/ops/linalg.py``.

* :func:`gauss_jordan_inverse_and_logdet` mirrors the JAX unpivoted
  Gauss-Jordan with its relative pivot floor step for step: it is the EM
  inverse (``bss_inverse='gauss_jordan'``) and the ``d <= 32`` branch of
  :func:`hermitian_solve` (the MVDR solve, D = 24).
* :func:`block_gauss_jordan_inverse_and_logdet` and
  :func:`schur_inverse_and_logdet` are the JAX blocked Gauss-Jordan and
  recursive Schur-complement inverses, operation for operation.
* :func:`hermitian_solve` keeps the JAX equilibration, scale floor,
  diagonal load, ``method`` choices and iterative refinement.  Its
  ``'chol'`` method (the default above ``d = 32``) factors with
  ``torch.linalg.cholesky_ex`` + ``cholesky_solve`` in place of the JAX
  blocked-Cholesky panels; a failed factorization raises where the JAX
  panels floor the pivot at ``eps^2 * max(diag)``.  The WPE filter solve
  (d = taps * D = 240) does not come here in complex64: it runs the JAX
  panels, with their floor, in the hand-written Cholesky kernel
  (``ops/kernels/chol_solve.py::hermitian_solve_chol``, called by
  ``ops/wpe.py``); complex128 and d > 256 still solve here.
* :func:`blocked_cholesky` and :func:`blocked_cholesky_solve` are the JAX
  blocked Cholesky (the panels of the WPE solve's plain version, pivots
  floored at ``eps^2 * max(diag)``) and its blocked substitutions.
* :func:`dominant_eigenvector` is the JAX repeated squaring, with the
  largest column picked by indexing (the one-hot reduction was a TPU
  workaround); :func:`stable_cholesky` returns NaN where the
  factorization fails, as ``jnp.linalg.cholesky`` does.
"""

import torch

__all__ = ['hermitize', 'eye_like', 'stable_solve', 'stable_cholesky',
           'gauss_jordan_inverse_and_logdet',
           'block_gauss_jordan_inverse_and_logdet', 'schur_inverse_and_logdet',
           'equilibrate', 'hermitian_solve', 'dominant_eigenvector',
           'blocked_cholesky', 'blocked_cholesky_solve']


def hermitize(mat):
    """Force Hermitian symmetry: ``(A + A^H) / 2``."""
    return 0.5 * (mat + mat.transpose(-2, -1).conj())


def eye_like(mat):
    """The identity broadcast to ``mat``'s shape, dtype and device."""
    d = mat.shape[-1]
    return torch.eye(d, dtype=mat.dtype, device=mat.device).expand(mat.shape)


def stable_solve(A, B):
    """Solve ``A X = B`` batched, with a pseudo-inverse for the matrices
    whose direct solve is not finite (the ``regularization=0`` WPE path,
    reference ``np.linalg.solve`` with a least-squares fallback)."""
    direct, info = torch.linalg.solve_ex(A, B)
    pinv = torch.linalg.pinv(A) @ B
    bad = (info != 0) | ~torch.isfinite(direct).all(dim=-1).all(dim=-1)
    return torch.where(bad[..., None, None], pinv, direct)


def _cholesky_or_nan(A):
    """Lower Cholesky factor; where the factorization fails, a lower
    triangle of NaN (what ``jnp.linalg.cholesky`` returns)."""
    L, info = torch.linalg.cholesky_ex(A)
    nan = torch.full_like(L, float('nan')).tril()
    return torch.where((info != 0)[..., None, None], nan, L)


def stable_cholesky(mat, *, eps_scale=1e-6):
    """Cholesky of a Hermitian PSD matrix with trace-scaled diagonal
    jitter ``eps_scale * trace(mat) / D`` (scale floored at ``tiny``)."""
    d = mat.shape[-1]
    tr = torch.diagonal(mat, dim1=-2, dim2=-1).sum(-1).real
    scale = torch.clamp_min(tr / d, torch.finfo(tr.dtype).tiny)
    jitter = (eps_scale * scale)[..., None, None].to(mat.dtype) \
        * eye_like(mat)
    return _cholesky_or_nan(hermitize(mat) + jitter)


def gauss_jordan_inverse_and_logdet(M):
    """Batched unpivoted Gauss-Jordan inverse + log|M| of Hermitian PD
    matrices.  M (..., d, d) -> (inverse (..., d, d), logdet (...,)).

    Pivots below ``max(diag) * eps`` are rounding noise for an HPD input
    and are floored there (relative, not ``tiny``: a ``tiny`` pivot's
    rank-1 update overflows float32)."""
    d = M.shape[-1]
    rdtype = M.real.dtype
    finfo = torch.finfo(rdtype)
    diag0 = torch.diagonal(M, dim1=-2, dim2=-1).real
    pivfloor = torch.clamp_min(diag0.amax(dim=-1) * finfo.eps, finfo.tiny)
    pivfloor_c = pivfloor.to(M.dtype)
    A = M.clone()
    logdet = torch.zeros(M.shape[:-2], dtype=rdtype, device=M.device)
    for p in range(d):
        row = A[..., p, :]
        col = A[..., :, p]
        pivot = A[..., p, p]
        safe = torch.where(pivot.abs() > pivfloor, pivot, pivfloor_c)
        inv_piv = 1.0 / safe
        rown = row * inv_piv[..., None]
        # the rank-1 step zeroes row and column p; the fixups then write
        # the inverse's row and column p in their place
        colfix = -col * inv_piv[..., None]
        A = A - col[..., :, None] * rown[..., None, :]
        rowfix = rown.clone()
        rowfix[..., p] = inv_piv
        colfix[..., p] = 0
        A[..., p, :] += rowfix
        A[..., :, p] += colfix
        logdet = logdet + torch.log(torch.maximum(pivot.real, pivfloor))
    return A, logdet


def block_gauss_jordan_inverse_and_logdet(M, *, block=32):
    """Blocked unpivoted Gauss-Jordan inverse + log|M|: the elimination
    order of :func:`gauss_jordan_inverse_and_logdet` in ``d / block``
    pivot steps, each pivot block inverted by the scalar version and
    applied by matrix products.  A ``d`` that is not a multiple of
    ``block`` is extended by an identity block (inverse extended alike,
    logdet unchanged)."""
    d = M.shape[-1]
    pad = (-d) % block
    A = M
    if pad:
        A = torch.zeros(M.shape[:-2] + (d + pad, d + pad), dtype=M.dtype,
                        device=M.device)
        A[..., :d, :d] = M
        A[..., d:, d:] = torch.eye(pad, dtype=M.dtype, device=M.device)
    logdet = torch.zeros(M.shape[:-2], dtype=M.real.dtype, device=M.device)
    for lo in range(0, d + pad, block):
        hi = lo + block
        inv_piv, ld = gauss_jordan_inverse_and_logdet(A[..., lo:hi, lo:hi])
        logdet = logdet + ld
        col = A[..., :, lo:hi]
        rown = inv_piv @ A[..., lo:hi, :]
        # the rank-block update zeroes block row and column j exactly; the
        # fixups then write the inverse's blocks
        colfix = -(col @ inv_piv)
        colfix[..., lo:hi, :] = 0
        A = A - col @ rown
        rowfix = rown.clone()
        rowfix[..., :, lo:hi] = inv_piv
        A[..., lo:hi, :] = rowfix
        A[..., :, lo:hi] += colfix
    return A[..., :d, :d], logdet


def schur_inverse_and_logdet(M):
    """Batched Hermitian-PD inverse + log|M| by recursive 2 x 2-block
    Schur complements, bottoming out at closed-form 1 x 1 / 2 x 2
    inverses (the 2 x 2 determinant floored at ``8 eps a c``).  No
    pivoting: the caller ensures positive definiteness.

    M (..., d, d) complex -> (inverse (..., d, d), logdet (...,) real)."""
    d = M.shape[-1]
    finfo = torch.finfo(M.real.dtype)
    if d == 1:
        safe = torch.clamp_min(M[..., 0, 0].real, finfo.tiny)
        return (1.0 / safe).to(M.dtype)[..., None, None], torch.log(safe)
    if d == 2:
        a = M[..., 0, 0].real
        c = M[..., 1, 1].real
        b = M[..., 0, 1]
        floor = torch.clamp_min(8 * finfo.eps * a * c, finfo.tiny)
        det = torch.maximum(a * c - (b * b.conj()).real, floor)
        inv_det = (1.0 / det).to(M.dtype)
        inv = torch.stack([
            torch.stack([c.to(M.dtype), -b], dim=-1),
            torch.stack([-b.conj(), a.to(M.dtype)], dim=-1),
        ], dim=-2) * inv_det[..., None, None]
        return inv, torch.log(det)
    h = d // 2
    A = M[..., :h, :h]
    B = M[..., :h, h:]
    Ai, logdet_a = schur_inverse_and_logdet(A)
    AiB = Ai @ B
    S = hermitize(M[..., h:, h:] - B.conj().transpose(-2, -1) @ AiB)
    Si, logdet_s = schur_inverse_and_logdet(S)
    AiB_Si = AiB @ Si
    top_left = Ai + AiB_Si @ AiB.conj().transpose(-2, -1)
    top_right = -AiB_Si
    inv = torch.cat([
        torch.cat([top_left, top_right], dim=-1),
        torch.cat([top_right.conj().transpose(-2, -1), Si], dim=-1),
    ], dim=-2)
    return hermitize(inv), logdet_a + logdet_s


def equilibrate(A, B, relative_load=None):
    """The conditioning of :func:`hermitian_solve` and of K5's plain
    versions (``ops/kernels/chol_solve.py``; the kernel runs it in its
    prologue): ``A`` scaled to unit diagonal (the
    scales floored at ``eps * max(diag)``; an all-zero matrix is not
    scaled) and hermitized, ``relative_load`` (default ``64 * eps``) added
    on that diagonal, ``B``'s rows scaled alike.

    A (..., d, d), B (..., d, e) -> (As0 unloaded, As loaded, Bs,
    sinv (..., d) of A's dtype); the solution of ``A X = B`` is
    ``sinv[..., :, None] * Xs`` where ``As Xs = Bs``.
    """
    d = A.shape[-1]
    finfo = torch.finfo(A.real.dtype)
    if relative_load is None:
        relative_load = 64 * finfo.eps
    diag = torch.diagonal(A, dim1=-2, dim2=-1).real
    # scale floor relative to the largest diagonal entry: an all-zero
    # row (silent channel) must not get a 1/sqrt(tiny) scale; an all-zero
    # matrix skips equilibration
    maxdiag = diag.amax(dim=-1, keepdim=True)
    floor = torch.where(maxdiag > 0, maxdiag * finfo.eps,
                        torch.ones_like(maxdiag))
    s = torch.sqrt(torch.maximum(diag, floor))
    sinv = (1.0 / s).to(A.dtype)
    As0 = hermitize(A * sinv[..., :, None] * sinv[..., None, :])
    As = As0 + relative_load * torch.eye(d, dtype=A.dtype, device=A.device)
    return As0, As, sinv[..., :, None] * B, sinv


def hermitian_solve(A, B, *, relative_load=None, method=None,
                    refine: int = 0):
    """Solve ``A X = B`` for Hermitian (PSD) ``A``: equilibrate to unit
    diagonal, add ``relative_load`` (default ``64 * eps``) on that
    diagonal, solve, undo the scaling.

    ``method``: ``None`` ('gj' for ``d <= 32``, else 'chol'), 'gj' (the
    Gauss-Jordan inverse), 'block_gj', 'schur' (explicit inverses) or
    'chol' (cuSOLVER / LAPACK Cholesky; raises where it fails: the
    complex64 WPE solve uses the kernel entry
    ``ops/kernels/chol_solve.py::hermitian_solve_chol`` instead, which
    floors the pivot as JAX does).
    ``refine > 0`` runs that many iterative-refinement steps: the residual
    against the UNLOADED equilibrated matrix, corrected through the
    factorization (or inverse) of the loaded one.

    A (..., d, d), B (..., d, e) -> X (..., d, e).
    """
    d = A.shape[-1]
    if method is None:
        method = 'gj' if d <= 32 else 'chol'
    if method not in ('gj', 'block_gj', 'schur', 'chol'):
        raise ValueError(f'unknown method {method!r}')
    As0, As, Bs, sinv = equilibrate(A, B, relative_load)
    if method == 'chol':
        L, info = torch.linalg.cholesky_ex(As)
        bad = int((info != 0).sum())
        if bad:
            raise torch.linalg.LinAlgError(
                f'hermitian_solve: Cholesky failed on {bad} of '
                f'{info.numel()} loaded, equilibrated matrices')

        def apply_inv(rhs):
            return torch.cholesky_solve(rhs, L)
    else:
        inverse = {'gj': gauss_jordan_inverse_and_logdet,
                   'block_gj': block_gauss_jordan_inverse_and_logdet,
                   'schur': schur_inverse_and_logdet}[method]
        inv, _ = inverse(As)

        def apply_inv(rhs):
            return inv @ rhs
    X = apply_inv(Bs)
    for _ in range(refine):
        X = X + apply_inv(Bs - As0 @ X)
    return sinv[..., :, None] * X


def dominant_eigenvector(M, *, squarings=14, power_steps=2):
    """Dominant eigenvector of a batched matrix with a real non-negative
    spectrum (Hermitian PSD, or ``N^{-1} Phi`` of two HPSDs) by repeated
    squaring: ``squarings`` max-normalized squarings, the largest column,
    then ``1 + power_steps`` power steps.  Unit 2-norm, the first
    component's phase rotated real-positive (sign for real input).

    M (..., D, D) -> (..., D).
    """
    tiny = torch.finfo(M.real.dtype).tiny

    def renorm(A):
        scale = A.abs().amax(dim=(-2, -1), keepdim=True)
        return A / torch.clamp_min(scale, tiny).to(A.dtype)

    P = renorm(M)
    for _ in range(squarings):
        P = renorm(P @ P)
    pick = torch.linalg.vector_norm(P, dim=-2).argmax(dim=-1)
    v = torch.take_along_dim(P, pick[..., None, None], dim=-1)[..., 0]

    def power(v):
        v = (M @ v[..., None])[..., 0]
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return v / torch.clamp_min(n, tiny).to(v.dtype)

    for _ in range(1 + power_steps):
        v = power(v)
    if v.is_complex():
        return v * torch.exp(-1j * torch.angle(v[..., :1])).to(v.dtype)
    return v * torch.sign(torch.where(v[..., :1] == 0,
                                      torch.ones_like(v[..., :1]),
                                      v[..., :1]))


def blocked_cholesky(A, *, block=32):
    """The lower factor L of A = L L^H for batched Hermitian PD A
    (..., d, d), by the JAX package's right-looking panels (its default
    block of 32: ``ops/kernels/chol_solve.py``'s plain version), each pivot
    floored at ``eps^2 * max(diag)``; zero above the diagonal."""
    from pb_chime5_tpu_torch.ops.kernels.chol_solve import (
        BLOCK, _cholesky_panels)
    if block != BLOCK:
        raise NotImplementedError(f'block={block}: the panels are {BLOCK} '
                                  f'wide')
    d = A.shape[-1]
    A3 = A.reshape(-1, d, d)
    col_blocks, _ = _cholesky_panels(A3)
    dp = len(col_blocks) * BLOCK
    L = A3.new_zeros((A3.shape[0], dp, dp))
    for j, cb in enumerate(col_blocks):
        L[:, j * BLOCK:, j * BLOCK:(j + 1) * BLOCK] = cb
    return L[:, :d, :d].reshape(A.shape)


def blocked_cholesky_solve(L, B, *, block=32):
    """X with L L^H X = B for the factor of :func:`blocked_cholesky`:
    blocked forward and backward substitutions, each diagonal block
    applied by its Gauss-Jordan inverse (a partial last block padded with
    an identity), as the JAX package solves.  L (..., d, d), B (..., d, e)
    -> (..., d, e)."""
    d = L.shape[-1]
    spans = [(lo, min(lo + block, d)) for lo in range(0, d, block)]
    inv_diag = []
    for lo, hi in spans:
        blk = L[..., lo:hi, lo:hi]
        if hi - lo < block:
            full = torch.eye(block, dtype=L.dtype, device=L.device).expand(
                *L.shape[:-2], block, block).clone()
            full[..., :hi - lo, :hi - lo] = blk
            blk = full
        inv_diag.append(
            gauss_jordan_inverse_and_logdet(blk)[0][..., :hi - lo, :hi - lo])
    Y = torch.zeros_like(B)
    for (lo, hi), inv in zip(spans, inv_diag):
        rhs = B[..., lo:hi, :]
        if lo:
            rhs = rhs - L[..., lo:hi, :lo] @ Y[..., :lo, :]
        Y[..., lo:hi, :] = inv @ rhs
    X = torch.zeros_like(B)
    for (lo, hi), inv in reversed(list(zip(spans, inv_diag))):
        rhs = Y[..., lo:hi, :]
        if hi < d:
            rhs = rhs - L[..., hi:, lo:hi].conj().transpose(-2, -1) \
                @ X[..., hi:, :]
        X[..., lo:hi, :] = inv.conj().transpose(-2, -1) @ rhs
    return X
