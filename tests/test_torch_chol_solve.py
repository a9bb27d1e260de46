"""The blocked Cholesky solve K5 — its plain PyTorch versions, which the
entries run on the CPU — vs the JAX package.

* The real instantiation (``chol_solve_real_spd``,
  ``hermitian_solve_pallas``) vs the JAX Pallas kernel in interpret mode.
  Tolerance: the largest absolute difference over the largest |X| <=
  1e-5.  Both run the same float32 algorithm (the same panels, pivot
  floor and explicit block inverses); they differ in the summation order
  of the 32-wide products (measured ~2e-7 at S = 64).  The FLT_MIN floor
  pin is exact: a zero pivot gives ``1 / FLT_MIN`` in both packages.
* The complex instantiation (``hermitian_solve_chol``, the WPE solve) vs
  JAX's ``hermitian_solve(..., method='chol')`` (XLA, the JAX default
  above d = 32): relative Frobenius error per system <= 1e-5 in
  complex64 (the same panels and relative floor, the products summed in
  other orders: measured ~2-5e-7) and <= 1e-10 in complex128 (measured
  ~1e-15), with and without ``refine``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops.pallas import chol_solve as jax_k5
from pb_chime5_tpu_torch.ops import linalg
from pb_chime5_tpu_torch.ops.kernels import chol_solve as k5

torch.set_num_threads(2)

RTOL = 1e-5
FLT_MIN = np.finfo(np.float32).tiny


def random_spd(F, S, *, seed=0, pad=0):
    """(A2 (F, S, S), B2 (F, S, 5)) float32: a well-conditioned SPD block
    ``M M^T / S + I`` on the first ``S - pad`` rows and an uncoupled
    identity block (zero right-hand sides) on the last ``pad``."""
    rng = np.random.default_rng(seed)
    S0 = S - pad
    M = rng.standard_normal((F, S0, S0))
    A2 = np.broadcast_to(np.eye(S), (F, S, S)).copy()
    A2[:, :S0, :S0] = M @ M.transpose(0, 2, 1) / S0 + np.eye(S0)
    B2 = np.zeros((F, S, 5))
    B2[:, :S0] = rng.standard_normal((F, S0, 5))
    return A2.astype(np.float32), B2.astype(np.float32)


def random_hpd_system(F, D, E, *, seed=0):
    """Complex64 HPD (F, D, D) with a spread of scales (equilibration at
    work) and (F, D, E) right-hand sides."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((F, D, D)) + 1j * rng.standard_normal((F, D, D))
    A = A @ A.conj().transpose(0, 2, 1) / D + 0.5 * np.eye(D)
    s = np.exp(rng.uniform(-2, 2, (F, D)))
    A = A * s[:, :, None] * s[:, None, :]
    B = rng.standard_normal((F, D, E)) + 1j * rng.standard_normal((F, D, E))
    return A.astype(np.complex64), B.astype(np.complex64)


def rel_max(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def rel_fro(got, want):
    """Largest relative Frobenius error over the batch."""
    return float((np.linalg.norm(got - want, axis=(-2, -1))
                  / np.linalg.norm(want, axis=(-2, -1))).max())


@pytest.mark.parametrize('S,pad', [(64, 0), (64, 24)],
                         ids=['two-panels', 'padded-D20'])
def test_reference_matches_jax_kernel(S, pad):
    A2, B2 = random_spd(3, S, seed=S + pad, pad=pad)
    X = k5.chol_solve_real_spd_reference(torch.from_numpy(A2),
                                         torch.from_numpy(B2)).numpy()
    Xj = np.asarray(jax_k5.chol_solve_real_spd(
        jnp.asarray(A2), jnp.asarray(B2), interpret=True))
    assert X.shape == Xj.shape == B2.shape and X.dtype == np.float32
    assert rel_max(X, Xj) <= RTOL, rel_max(X, Xj)
    if pad:                                  # the identity block solves 0
        assert not X[:, S - pad:].any()
    X64 = np.linalg.solve(A2.astype(np.float64), B2.astype(np.float64))
    assert rel_max(X, X64) <= 1e-5


def test_hermitian_solve_pallas_matches_jax_kernel():
    A, B = random_hpd_system(2, 32, 6, seed=1)
    for load in (None, 1e-4):
        X = k5.hermitian_solve_pallas(torch.from_numpy(A),
                                      torch.from_numpy(B),
                                      relative_load=load).numpy()
        Xj = np.asarray(jax_k5.hermitian_solve_pallas(
            jnp.asarray(A), jnp.asarray(B), relative_load=load,
            interpret=True))
        assert X.dtype == np.complex64
        assert rel_max(X, Xj) <= RTOL, (load, rel_max(X, Xj))


def test_padded_block_form_matches_jax_wrapper():
    """D = 20: the real block form S0 = 40 padded to 64, through the
    wrapper of both packages."""
    A, B = random_hpd_system(2, 20, 3, seed=2)
    X = k5.hermitian_solve_pallas(torch.from_numpy(A), torch.from_numpy(B),
                                  relative_load=1e-4).numpy()
    Xj = np.asarray(jax_k5.hermitian_solve_pallas(
        jnp.asarray(A), jnp.asarray(B), relative_load=1e-4, interpret=True))
    assert rel_max(X, Xj) <= RTOL, rel_max(X, Xj)
    A2, B2 = k5.real_block_form(*linalg.equilibrate(
        torch.from_numpy(A), torch.from_numpy(B), 1e-4)[1:3])
    assert A2.shape == (2, 64, 64) and B2.shape == (2, 64, 3)
    torch.testing.assert_close(A2[:, 40:, 40:], torch.eye(24).expand(2, 24, 24),
                               rtol=0, atol=0)
    assert not A2[:, 40:, :40].any() and not B2[:, 40:].any()
    torch.testing.assert_close(A2, A2.transpose(-2, -1), rtol=0, atol=0)


def test_zero_pivot_floor_pin():
    """A2 = I_64 with A2[5, 5] = 0 and B2[5, 0] = 1: the pivot is floored
    at FLT_MIN before its square root, so X[5, 0] = 1 / FLT_MIN, and the
    rows with a healthy pivot come out exact — in both packages."""
    A2 = np.eye(64, dtype=np.float32)[None].copy()
    A2[0, 5, 5] = 0
    B2 = np.zeros((1, 64, 3), np.float32)
    B2[0, 5, 0] = 1
    B2[0, 7, 1] = 2
    X = k5.chol_solve_real_spd(torch.from_numpy(A2),
                               torch.from_numpy(B2)).numpy()
    Xj = np.asarray(jax_k5.chol_solve_real_spd(
        jnp.asarray(A2), jnp.asarray(B2), interpret=True))
    for got in (X, Xj):
        assert got[0, 5, 0] == np.float32(1 / FLT_MIN) == 8.507059e37
        want = B2.copy()
        want[0, 5, 0] = got[0, 5, 0]
        np.testing.assert_array_equal(got, want)


def test_three_cholesky_floors_on_a_zero_pivot():
    """The Cholesky paths on a zero pivot (identity with A[3, 3] = 0, no
    load): the port's ``hermitian_solve`` (LAPACK / cuSOLVER) raises;
    K5's real instantiation floors the pivot absolutely, at FLT_MIN; the
    JAX ``hermitian_solve`` and K5's complex instantiation (the port's WPE
    solve) floor it relative to the matrix, at ``eps^2 max(diag)`` with
    the padding's ones counted.  The equilibration scales row 3 by
    ``1 / sqrt(eps)`` first (its scale floor), so X[3] = b / eps / floor."""
    from pb_chime5_tpu.ops.linalg import hermitian_solve as jax_solve
    eps = np.finfo(np.float32).eps
    A = np.broadcast_to(np.eye(40), (1, 40, 40)).astype(np.complex64).copy()
    A[0, 3, 3] = 0
    B = np.zeros((1, 40, 1), np.complex64)
    B[0, 3, 0] = 1e-20
    with pytest.raises(torch.linalg.LinAlgError):
        linalg.hermitian_solve(torch.from_numpy(A), torch.from_numpy(B),
                               relative_load=0)
    X = k5.hermitian_solve_pallas(torch.from_numpy(A), torch.from_numpy(B),
                                  relative_load=0).numpy()
    Xj = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(B),
                              relative_load=0))
    Xc = k5.hermitian_solve_chol(torch.from_numpy(A), torch.from_numpy(B),
                                 relative_load=0).numpy()
    for got, floor in ((X, FLT_MIN), (Xj, eps ** 2), (Xc, eps ** 2)):
        np.testing.assert_allclose(got[0, 3, 0], 1e-20 / eps / floor,
                                   rtol=1e-5)
        assert not np.delete(got, 3, axis=1).any()
    assert rel_fro(Xc, Xj) <= 1e-5


def test_entries_run_reference_on_cpu_without_counting():
    A2, B2 = random_spd(2, 64, seed=3)
    A, B = random_hpd_system(2, 12, 2, seed=3)
    cases = (
        (k5.chol_solve_real_spd, k5.chol_solve_real_spd_reference,
         (torch.from_numpy(A2), torch.from_numpy(B2))),
        (k5.hermitian_solve_pallas, k5.hermitian_solve_pallas_reference,
         (torch.from_numpy(A), torch.from_numpy(B))),
    )
    for entry, reference, args in cases:
        before = entry.launches
        torch.testing.assert_close(entry(*args), reference(*args), rtol=0,
                                   atol=0)
        assert entry.launches == before


def test_hermitian_solve_pallas_matches_port_hermitian_solve():
    """K5's plain version against the port's LAPACK solve of the same
    loaded, equilibrated system (the library call ``chip_smoke.py`` times
    K5 against), at the WPE load 1e-4."""
    A, B = random_hpd_system(3, 40, 4, seed=4)
    X = k5.hermitian_solve_pallas(torch.from_numpy(A), torch.from_numpy(B),
                                  relative_load=1e-4).numpy()
    want = linalg.hermitian_solve(torch.from_numpy(A), torch.from_numpy(B),
                                  relative_load=1e-4).numpy()
    assert rel_max(X, want) <= 1e-4


@pytest.mark.parametrize('bad', ['S', 'dtype', 'layout', 'shape', 'empty',
                                 'smem', 'device'])
def test_rejects_unsupported_inputs(bad):
    A2, B2 = (torch.from_numpy(x) for x in random_spd(2, 64, seed=5))
    if bad == 'S':
        A2, B2 = A2[:, :48, :48].contiguous(), B2[:, :48].contiguous()
    elif bad == 'dtype':
        A2 = A2.double()
    elif bad == 'layout':
        A2 = A2.transpose(-2, -1)
    elif bad == 'shape':
        B2 = B2[:, :32]
    elif bad == 'empty':
        A2, B2 = A2[:0], B2[:0]
    elif bad == 'smem':
        n = k5.max_rows(5) + k5.BLOCK
        A2, B2 = torch.eye(n)[None], torch.zeros(1, n, 5)
    elif bad == 'device':
        B2 = B2.to('meta')
    with pytest.raises(ValueError):
        k5.chol_solve_real_spd(A2, B2)
    assert k5.max_rows(24) >= 512            # the WPE headline fits


HERMITIAN_RTOL = {np.complex64: 1e-5, np.complex128: 1e-10}


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128],
                         ids=['c64', 'c128'])
@pytest.mark.parametrize('d,E,refine', [
    (33, 1, 0), (33, 24, 0), (40, 1, 0), (40, 24, 1), (64, 1, 1),
    (64, 24, 0), (240, 1, 0), (240, 24, 0), (240, 24, 1)],
    ids=lambda v: str(v))
def test_hermitian_solve_chol_reference_matches_jax(d, E, refine, dtype):
    """The plain version of the WPE solve (and the entry on CPU tensors,
    which runs it uncounted) vs JAX's default ``hermitian_solve``
    (``method='chol'``) at the WPE load, on equilibration-heavy HPD
    systems."""
    from pb_chime5_tpu.ops.linalg import hermitian_solve as jax_solve
    A, B = random_hpd_system(3 if d == 240 else 2, d, E, seed=d + E)
    A, B = A.astype(dtype), B.astype(dtype)
    X = k5.hermitian_solve_chol_reference(
        torch.from_numpy(A), torch.from_numpy(B), relative_load=1e-4,
        refine=refine).numpy()
    Xj = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(B),
                              relative_load=1e-4, method='chol',
                              refine=refine))
    assert X.dtype == Xj.dtype == dtype and np.isfinite(X).all()
    assert rel_fro(X, Xj) <= HERMITIAN_RTOL[dtype], rel_fro(X, Xj)
    if dtype == np.complex64:
        before = k5.hermitian_solve_chol.launches
        got = k5.hermitian_solve_chol(torch.from_numpy(A),
                                      torch.from_numpy(B),
                                      relative_load=1e-4, refine=refine)
        np.testing.assert_array_equal(got.numpy(), X)
        assert k5.hermitian_solve_chol.launches == before


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128],
                         ids=['c64', 'c128'])
def test_hermitian_solve_chol_all_zero_matrix_matches_jax(dtype):
    """An all-zero matrix skips the equilibration (scale 1): the load
    alone is factored, X = B / load, finite, as JAX gives."""
    from pb_chime5_tpu.ops.linalg import hermitian_solve as jax_solve
    _, B = random_hpd_system(2, 40, 3, seed=7)
    A = np.zeros((2, 40, 40), dtype)
    B = B.astype(dtype)
    X = k5.hermitian_solve_chol_reference(
        torch.from_numpy(A), torch.from_numpy(B), relative_load=1e-4).numpy()
    Xj = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(B),
                              relative_load=1e-4, method='chol'))
    assert np.isfinite(X).all()
    assert rel_fro(X, Xj) <= HERMITIAN_RTOL[dtype]
    np.testing.assert_allclose(X, B / dtype(1e-4).real, rtol=1e-5)


@pytest.mark.parametrize('bad', ['small', 'large', 'dtype', 'layout',
                                 'shape', 'empty', 'device', 'refine'])
def test_hermitian_solve_chol_rejects_unsupported_inputs(bad):
    A, B = (torch.from_numpy(x) for x in random_hpd_system(2, 40, 3, seed=8))
    kw = {}
    if bad == 'small':
        A, B = A[:, :32, :32].contiguous(), B[:, :32].contiguous()
    elif bad == 'large':
        A = torch.eye(264, dtype=A.dtype)[None]
        B = torch.zeros((1, 264, 3), dtype=B.dtype)
    elif bad == 'dtype':
        A, B = A.to(torch.complex128), B.to(torch.complex128)
    elif bad == 'layout':
        A = A.transpose(-2, -1)
    elif bad == 'shape':
        B = B[:, :33].contiguous()
    elif bad == 'empty':
        A, B = A[:0], B[:0]
    elif bad == 'device':
        B = B.to('meta')
    elif bad == 'refine':
        kw = dict(refine=-1)
    with pytest.raises(ValueError):
        k5.hermitian_solve_chol(A, B, relative_load=1e-4, **kw)
    assert k5.supports(240, 24) and not k5.supports(32, 24)
