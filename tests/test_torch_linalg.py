"""Port linalg vs the JAX package: Gauss-Jordan inverse / logdet and the
equilibrated Hermitian solve (d = 8: Gauss-Jordan branch, d = 40:
Cholesky branch).

Tolerances: complex128 runs compare the algorithms (the GJ steps are
mirrored one for one: 1e-10; the d = 40 branch factors with LAPACK in
place of the JAX blocked panels: 1e-8 relative on well-conditioned
inputs).  complex64 runs allow float32 rounding through an inverse of
condition ~1e2: 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops import linalg as jl
from pb_chime5_tpu_torch.ops import linalg as tl

torch.set_num_threads(2)


def _random_hpd(rng, shape, d, dtype):
    A = rng.standard_normal((*shape, d, d)) \
        + 1j * rng.standard_normal((*shape, d, d))
    return (A @ A.conj().swapaxes(-1, -2) / d + 0.5 * np.eye(d)).astype(
        dtype)


@pytest.mark.parametrize('d', [1, 3, 8, 24])
@pytest.mark.parametrize('dtype,tol', [(np.complex128, 1e-10),
                                       (np.complex64, 1e-4)])
def test_gauss_jordan_matches_jax(rng, d, dtype, tol):
    M = _random_hpd(rng, (2, 5), d, dtype)
    inv, ld = tl.gauss_jordan_inverse_and_logdet(torch.from_numpy(M))
    inv_j, ld_j = jl.gauss_jordan_inverse_and_logdet(jnp.asarray(M))
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), rtol=tol,
                               atol=tol * np.abs(np.asarray(inv_j)).max())
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(M)[1],
                               rtol=tol, atol=tol * d)


def test_gauss_jordan_pivot_floor_keeps_singular_finite():
    M = np.zeros((2, 4, 4), np.complex64)
    M[0] = np.eye(4)
    M[1, 0, 0] = 1.0                          # rank 1: pivots 1..3 are 0
    inv, ld = tl.gauss_jordan_inverse_and_logdet(torch.from_numpy(M))
    inv_j, ld_j = jl.gauss_jordan_inverse_and_logdet(jnp.asarray(M))
    assert torch.isfinite(inv).all() and torch.isfinite(ld).all()
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), rtol=1e-6)
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=1e-6)


@pytest.mark.parametrize('d', [8, 40])
@pytest.mark.parametrize('dtype,tol', [(np.complex128, 1e-8),
                                       (np.complex64, 1e-4)])
def test_hermitian_solve_matches_jax(rng, d, dtype, tol):
    A = _random_hpd(rng, (3,), d, dtype)
    A[1] *= 1e-3                              # equilibration at work
    B = (rng.standard_normal((3, d, 5))
         + 1j * rng.standard_normal((3, d, 5))).astype(dtype)
    for load in (None, 1e-4):
        got = tl.hermitian_solve(torch.from_numpy(A), torch.from_numpy(B),
                                 relative_load=load).numpy()
        want = np.asarray(jl.hermitian_solve(
            jnp.asarray(A), jnp.asarray(B), relative_load=load))
        scale = np.abs(want).max(axis=(-2, -1), keepdims=True)
        np.testing.assert_allclose(got / scale, want / scale, atol=tol)


def test_hermitian_solve_zero_matrix_is_finite():
    A = np.zeros((2, 40, 40), np.complex64)
    B = np.ones((2, 40, 3), np.complex64)
    X = tl.hermitian_solve(torch.from_numpy(A), torch.from_numpy(B),
                           relative_load=1e-4)
    assert torch.isfinite(X).all()


def test_hermitian_solve_cholesky_failure_raises():
    A = -np.broadcast_to(np.eye(40), (2, 40, 40)).astype(np.complex64)
    B = np.ones((2, 40, 3), np.complex64)
    with pytest.raises(torch.linalg.LinAlgError):
        tl.hermitian_solve(torch.from_numpy(A.copy()), torch.from_numpy(B))


def test_stable_solve_matches_numpy_and_handles_singular(rng):
    A = _random_hpd(rng, (2,), 6, np.complex128)
    A[1] = 0.0
    B = rng.standard_normal((2, 6, 2)) + 0j
    X = tl.stable_solve(torch.from_numpy(A), torch.from_numpy(B)).numpy()
    np.testing.assert_allclose(X[0], np.linalg.solve(A[0], B[0]),
                               rtol=1e-10)
    np.testing.assert_array_equal(X[1], 0)


# --- the rest of ops/linalg.py: tolerances as tests/test_linalg_device.py
# pins the JAX functions against NumPy in float64 (1e-10 for the
# inverses, 1e-8 for the solve and the eigenvectors), at 1e-4 relative in
# complex64 where the two packages round differently.

def test_eye_like_matches_jax(rng):
    M = _random_hpd(rng, (2, 3), 5, np.complex64)
    got = tl.eye_like(torch.from_numpy(M))
    assert got.shape == M.shape and got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jl.eye_like(jnp.asarray(M))))


@pytest.mark.parametrize('inverse', ['schur_inverse_and_logdet',
                                     'block_gauss_jordan_inverse_and_logdet'])
@pytest.mark.parametrize('d', [1, 2, 5, 24, 40])
@pytest.mark.parametrize('dtype,tol', [(np.complex128, 1e-10),
                                       (np.complex64, 1e-4)])
def test_explicit_inverses_match_jax(rng, inverse, d, dtype, tol):
    M = _random_hpd(rng, (3,), d, dtype)
    kw = {'block': 8} if inverse.startswith('block') else {}
    inv, ld = getattr(tl, inverse)(torch.from_numpy(M), **kw)
    inv_j, ld_j = getattr(jl, inverse)(jnp.asarray(M), **kw)
    np.testing.assert_allclose(inv.numpy(), np.asarray(inv_j), rtol=tol,
                               atol=tol * np.abs(np.asarray(inv_j)).max())
    np.testing.assert_allclose(ld.numpy(), np.asarray(ld_j), rtol=tol,
                               atol=tol * d)
    if dtype == np.complex128:
        np.testing.assert_allclose(inv.numpy(), np.linalg.inv(M),
                                   atol=1e-10)
        np.testing.assert_allclose(ld.numpy(), np.linalg.slogdet(M)[1],
                                   atol=1e-10)


@pytest.mark.parametrize('method', ['gj', 'block_gj', 'schur', 'chol'])
@pytest.mark.parametrize('refine', [0, 2])
def test_hermitian_solve_methods_match_jax(rng, method, refine):
    """Each ``method`` and iterative refinement (residual against the
    unloaded matrix, the factorization reused) against the JAX function
    in complex128, at a load of 1e-3 that refinement must mostly undo."""
    d = 40
    A = _random_hpd(rng, (3,), d, np.complex128)
    B = rng.standard_normal((3, d, 4)) + 1j * rng.standard_normal((3, d, 4))
    kw = dict(relative_load=1e-3, method=method, refine=refine)
    got = tl.hermitian_solve(torch.from_numpy(A), torch.from_numpy(B),
                             **kw).numpy()
    want = np.asarray(jl.hermitian_solve(jnp.asarray(A), jnp.asarray(B),
                                         **kw))
    np.testing.assert_allclose(got, want, atol=1e-8 * np.abs(want).max())
    exact = np.linalg.solve(A, B)
    bias = np.abs(got - exact).max() / np.abs(exact).max()
    assert bias < (1e-5 if refine else 1e-2), bias


def test_hermitian_solve_default_call_is_unchanged(rng):
    """``method=None, refine=0`` is 'gj' up to d = 32 and 'chol' above,
    bit for bit."""
    for d, method in ((8, 'gj'), (40, 'chol')):
        A = torch.from_numpy(_random_hpd(rng, (2,), d, np.complex64))
        B = torch.from_numpy(
            (rng.standard_normal((2, d, 3)) + 0j).astype(np.complex64))
        torch.testing.assert_close(
            tl.hermitian_solve(A, B),
            tl.hermitian_solve(A, B, method=method, refine=0), rtol=0,
            atol=0)
    with pytest.raises(ValueError):
        tl.hermitian_solve(A, B, method='lu')


@pytest.mark.parametrize('kind', ['hermitian', 'generalized', 'real'])
def test_dominant_eigenvector_matches_jax_and_numpy(rng, kind):
    M = _random_hpd(rng, (4,), 6, np.complex128)
    if kind == 'generalized':
        N = _random_hpd(rng, (4,), 6, np.complex128)
        M = np.linalg.solve(N, M)
    elif kind == 'real':
        M = M.real @ M.real.swapaxes(-1, -2)
    v = tl.dominant_eigenvector(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(
        v, np.asarray(jl.dominant_eigenvector(jnp.asarray(M))), atol=1e-8)
    w, V = np.linalg.eig(M)
    ref = np.take_along_axis(V, np.argmax(w.real, -1)[:, None, None],
                             -1)[..., 0]
    ref = ref / np.linalg.norm(ref, axis=-1, keepdims=True)
    ref = ref * np.exp(-1j * np.angle(ref[..., :1]))
    np.testing.assert_allclose(v, ref, atol=1e-8)


def test_dominant_eigenvector_float32_matches_jax(rng):
    M = _random_hpd(rng, (5,), 24, np.complex64)
    v = tl.dominant_eigenvector(torch.from_numpy(M)).numpy()
    np.testing.assert_allclose(
        v, np.asarray(jl.dominant_eigenvector(jnp.asarray(M))), atol=1e-4)


def test_stable_cholesky_matches_jax(rng):
    M = _random_hpd(rng, (3,), 6, np.complex128)
    M[2] = -np.eye(6)                         # not PD: NaN, as in JAX
    got = tl.stable_cholesky(torch.from_numpy(M)).numpy()
    want = np.asarray(jl.stable_cholesky(jnp.asarray(M)))
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-10)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[2]).any()
