"""Port cacGMM EM and the fused E+M kernel's plain version vs the JAX
package (its Pallas kernel in interpret mode).

Tolerances: the E+M accumulation at atol 1e-5, as
``tests/test_pallas_kernels.py`` pins the JAX kernel (plus 1e-6 relative
on the affiliation masses, which sum ~T values); the posteriors
after 4 + 1 EM iterations at atol 2e-3, as ``tests/test_cacgmm.py`` pins
the JAX kernel backend against its XLA backend (EM amplifies float32
rounding, so only short trajectories are compared).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pb_chime5_tpu.ops.cacgmm import CacgmmConfig as JaxCacgmmConfig
from pb_chime5_tpu.ops.cacgmm import _e_step as jax_e_step
from pb_chime5_tpu.ops.cacgmm import cacgmm_posteriors as jax_posteriors
from pb_chime5_tpu.ops.pallas.fused_em import (
    fused_em_scatter as jax_fused_em_scatter)
from pb_chime5_tpu_torch.ops import cacgmm
from pb_chime5_tpu_torch.ops.kernels import fused_em
from tests.test_torch_fused_em_cuda import random_inputs

torch.set_num_threads(2)


def _to_numpy(z, params, act, fm):
    return (z.numpy(), tuple(p.numpy() for p in params), act.numpy(),
            fm.numpy())


# ids as before the non-Hermitian case was added (False: HPD, True: the
# identity first pass)
@pytest.mark.parametrize('case', ['hpd', 'identity', 'non_hermitian'],
                         ids=['False', 'True', 'non_hermitian'])
def test_scatter_reference_matches_jax_kernel(case):
    """Also for a precision that is HPD plus an anti-Hermitian part: both
    versions take the full product P z, as the port's kernel does."""
    identity = case == 'identity'
    z, params, act, fm = random_inputs(
        8, 300, 4, 3, seed=1, identity=identity,
        skew=0.3 if case == 'non_hermitian' else 0.0)
    S, den = fused_em.fused_em_scatter_reference(z, params, act, fm)
    zn, pn, an, fn = _to_numpy(z, params, act, fm)
    S_j, den_j = jax_fused_em_scatter(
        jnp.asarray(zn), tuple(jnp.asarray(p) for p in pn),
        jnp.asarray(an), jnp.asarray(fn > 0), interpret=True)
    assert S.dtype == torch.complex64 and den.dtype == torch.float32
    np.testing.assert_allclose(S.numpy(), np.asarray(S_j), atol=1e-5)
    # den sums ~T responsibilities (up to ~300): float32 relative 1e-6
    np.testing.assert_allclose(den.numpy(), np.asarray(den_j), atol=1e-5,
                               rtol=1e-6)
    # the empty class and the padded frames contribute nothing
    if not identity:
        assert not S[:, 1].any() and not den[:, 1].any()
    z2 = z.clone()
    z2[:, 270:] = 0.5                 # inside the padded tail (fm == 0)
    S2, den2 = fused_em.fused_em_scatter_reference(z2, params, act, fm)
    torch.testing.assert_close(S2, S, rtol=0, atol=0)
    torch.testing.assert_close(den2, den, rtol=0, atol=0)


def test_wrapper_runs_reference_on_cpu_without_counting():
    z, params, act, fm = random_inputs(3, 50, 4, 2, seed=2)
    before = fused_em.fused_em_scatter.launches
    S, den = fused_em.fused_em_scatter(z, params, act, fm)
    S_r, den_r = fused_em.fused_em_scatter_reference(z, params, act, fm)
    torch.testing.assert_close(S, S_r, rtol=0, atol=0)
    torch.testing.assert_close(den, den_r, rtol=0, atol=0)
    assert fused_em.fused_em_scatter.launches == before


@pytest.mark.parametrize('bad', ['D', 'K', 'dtype', 'layout', 'shape'])
def test_wrapper_rejects_unsupported_inputs(bad):
    D = fused_em.MAX_D + 1 if bad == 'D' else 4
    K = fused_em.MAX_K + 1 if bad == 'K' else 2
    z, params, act, fm = random_inputs(2, 20, D, K, seed=3)
    if bad == 'dtype':
        z = z.to(torch.complex128)
    elif bad == 'layout':
        z = z.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == 'shape':
        act = act[:, :10]
    with pytest.raises(ValueError):
        fused_em.fused_em_scatter(z, params, act, fm)


def test_e_step_matches_jax_on_shared_state(rng):
    """EM state made once in NumPy and carried to both packages."""
    F, T, D, K = 5, 60, 4, 3
    z, params, act, _ = random_inputs(F, T, D, K, seed=4)
    zn = z.numpy()
    pn = tuple(p.numpy() for p in params)
    mask = act.numpy() > 0
    tparams = cacgmm.params_from_numpy(pn, 'cpu')
    for m in (None, mask):
        got, q = cacgmm._e_step(
            z, tparams, None if m is None else torch.from_numpy(m))
        want = jax.vmap(lambda zf, lw, pr, ld: jax_e_step(
            zf, (lw, pr, ld), None if m is None else jnp.asarray(m))[0])(
            jnp.asarray(zn), *(jnp.asarray(p) for p in pn))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5)
        assert torch.isfinite(q).all()


def _problem(rng, F=16, T=300, D=4, K=3):
    Y = (rng.standard_normal((F, T, D))
         + 1j * rng.standard_normal((F, T, D))).astype(np.complex64)
    act = rng.random((K, T)) > 0.3
    act[-1] = True
    return Y, act


@pytest.mark.parametrize('masked', [False, True])
def test_posteriors_match_jax_kernel_backend(rng, masked):
    Y, act = _problem(rng)
    fm = np.arange(Y.shape[1]) < 280 if masked else None
    want = np.asarray(jax_posteriors(
        jnp.asarray(Y), jnp.asarray(act),
        config=JaxCacgmmConfig(iterations=4, iterations_post=1,
                               em_backend='pallas'),
        frame_mask=None if fm is None else jnp.asarray(fm)))
    got = cacgmm.cacgmm_posteriors(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(iterations=4, iterations_post=1),
        frame_mask=None if fm is None else torch.from_numpy(fm)).numpy()
    assert got.shape == want.shape == (16, 3, 300)
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize('post', [0, 3])
def test_post_iterations_match_jax_and_count_launches(rng, post,
                                                       monkeypatch):
    Y, act = _problem(rng, F=6, T=200)
    calls = []
    real = cacgmm.fused_em_scatter
    monkeypatch.setattr(cacgmm, 'fused_em_scatter',
                        lambda *a: calls.append(1) or real(*a))
    got = cacgmm.cacgmm_posteriors(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(iterations=3,
                                   iterations_post=post)).numpy()
    # 1 + (iterations - 1) + max(iterations_post - 1, 0) passes
    assert len(calls) == 3 + max(post - 1, 0)
    want = np.asarray(jax_posteriors(
        jnp.asarray(Y), jnp.asarray(act),
        config=JaxCacgmmConfig(iterations=3, iterations_post=post,
                               em_backend='pallas')))
    np.testing.assert_allclose(got, want, atol=2e-3)


@pytest.mark.parametrize('masked', [False, True])
def test_pallas_gj_posteriors_match_jax_kernel_backend(rng, masked):
    """``inverse='pallas_gj'`` (the Gauss-Jordan kernel's plain version on
    the CPU, FLT_MIN pivot floor) against the JAX fused-kernel EM with its
    Pallas Gauss-Jordan kernel in interpret mode, at 4 + 1 iterations."""
    Y, act = _problem(rng)
    fm = np.arange(Y.shape[1]) < 280 if masked else None
    want = np.asarray(jax_posteriors(
        jnp.asarray(Y), jnp.asarray(act),
        config=JaxCacgmmConfig(iterations=4, iterations_post=1,
                               em_backend='pallas', inverse='pallas_gj'),
        frame_mask=None if fm is None else jnp.asarray(fm)))
    got = cacgmm.cacgmm_posteriors(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(iterations=4, iterations_post=1,
                                   inverse='pallas_gj'),
        frame_mask=None if fm is None else torch.from_numpy(fm)).numpy()
    assert got.shape == want.shape == (16, 3, 300)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_pallas_gj_inverse_runs_once_per_finalize(rng, monkeypatch):
    """K3's inverse runs inside the fused finalize (``em_finalize`` with
    its ``FLT_MIN`` floor), one batched (F, K) launch per E+M pass."""
    Y, act = _problem(rng, F=4, T=100)
    calls = []
    real = cacgmm.em_finalize

    def record(S, den, **kw):
        calls.append((S.shape, kw['floor']))
        return real(S, den, **kw)
    monkeypatch.setattr(cacgmm, 'em_finalize', record)
    got = cacgmm.cacgmm_posteriors(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(iterations=3, iterations_post=2,
                                   inverse='pallas_gj'))
    # one batched (F, K) inverse per E+M pass: 1 + 2 + 1
    assert calls == [((4, 3, 4, 4), 'flt_min')] * 4
    assert torch.isfinite(got).all()


def test_empty_activity_class_stays_finite(rng):
    """A class silent in the whole window must not poison the EM (the
    overflow-aware denominator floor and B = I for empty classes)."""
    F, T, D, K = 8, 200, 4, 4
    Y = (rng.standard_normal((F, T, D))
         + 1j * rng.standard_normal((F, T, D))).astype(np.complex64)
    act = np.zeros((K, T), bool)
    act[0, :120] = True
    act[1, 80:] = True
    act[3] = True
    fm = np.arange(T) < 180
    for fmv in (None, fm):
        got = cacgmm.cacgmm_posteriors(
            torch.from_numpy(Y), torch.from_numpy(act),
            config=cacgmm.CacgmmConfig(iterations=5, iterations_post=1),
            frame_mask=None if fmv is None else torch.from_numpy(fmv))
        assert torch.isfinite(got).all()
        assert got[:, 2, :].max() < 1e-3


def test_config_rejects_unported_options():
    for kw in (dict(inverse='lu'), dict(inverse='xla'),
               dict(em_backend='xla')):
        with pytest.raises(NotImplementedError):
            cacgmm.CacgmmConfig(**kw)


def test_make_initialization_matches_jax(rng):
    from pb_chime5_tpu.ops.cacgmm import make_initialization
    act = rng.random((3, 40)) > 0.5
    np.testing.assert_allclose(
        cacgmm.make_initialization(torch.from_numpy(act)).numpy(),
        np.asarray(make_initialization(jnp.asarray(act))), rtol=1e-7)


# --- the EM inverses 'cholesky', 'schur' and 'eigh' ---

INVERSES = ['gauss_jordan', 'cholesky', 'schur', 'eigh']


def _covariances(rng, F=6, K=3, D=8):
    """EM-like trace-normalized covariances: full rank, rank-deficient
    (only the jitter makes it invertible) and an empty class (B = I)."""
    Z = (rng.standard_normal((F, K, D, 3 * D))
         + 1j * rng.standard_normal((F, K, D, 3 * D)))
    Z[:, 1, :, D // 2:] = 0
    S = Z @ Z.conj().swapaxes(-1, -2)
    S[:, 2] = 0
    return np.asarray(cacgmm._trace_normalize(cacgmm.hermitize(
        torch.from_numpy(S.astype(np.complex64)))))


@pytest.mark.parametrize('inverse', INVERSES)
@pytest.mark.parametrize('dtype,tol', [(np.complex128, 1e-5),
                                       (np.complex64, 1e-4)])
def test_invert_matches_jax(rng, inverse, dtype, tol):
    """Each ``_invert`` mode against the JAX ``_invert`` on the same
    covariances: precision within ``tol`` of its largest entry, logdet
    within ``tol`` of the largest |logdet|.  complex128 holds every class
    (the rank-deficient one has condition ~1e6 after the jitter, ~1e10
    under 'eigh''s relative eigenvalue floor: 1e-5); complex64 the
    full-rank and the empty class (float32 on the rank-deficient class
    sits 5e-2 to 1 from float64 in both packages alike)."""
    from pb_chime5_tpu.ops.cacgmm import _invert as jax_invert
    cov = _covariances(rng).astype(dtype)
    if dtype == np.complex64:
        cov = cov[:, [0, 2]]
    cfg = cacgmm.CacgmmConfig(inverse=inverse)
    prec, ld = cacgmm._invert(torch.from_numpy(cov), cfg)
    prec_j, ld_j = jax_invert(jnp.asarray(cov), JaxCacgmmConfig(
        inverse=inverse), batched=True)
    prec_j, ld_j = np.asarray(prec_j), np.asarray(ld_j)
    assert prec.dtype == torch.from_numpy(cov).dtype
    scale = np.abs(prec_j).max(axis=(-2, -1), keepdims=True)
    np.testing.assert_allclose(prec.numpy() / scale, prec_j / scale,
                               atol=tol)
    np.testing.assert_allclose(ld.numpy(), ld_j,
                               atol=tol * np.abs(ld_j).max())
    assert torch.isfinite(prec).all() and torch.isfinite(ld).all()


def test_cholesky_inverse_gives_nan_where_the_factorization_fails():
    """Not positive definite after the jitter: NaN, as the JAX inverse
    gives (``jnp.linalg.cholesky``), not an exception."""
    from pb_chime5_tpu.ops.cacgmm import _invert as jax_invert
    cov = np.broadcast_to(np.eye(4), (2, 4, 4)).astype(np.complex64).copy()
    cov[1, 2, 2] = -1
    cfg = cacgmm.CacgmmConfig(inverse='cholesky')
    prec, ld = cacgmm._invert(torch.from_numpy(cov), cfg)
    prec_j, ld_j = jax_invert(jnp.asarray(cov), JaxCacgmmConfig(
        inverse='cholesky'), batched=True)
    np.testing.assert_array_equal(torch.isnan(prec).numpy(),
                                  np.isnan(np.asarray(prec_j)))
    np.testing.assert_array_equal(torch.isnan(ld).numpy(),
                                  np.isnan(np.asarray(ld_j)))
    assert torch.isfinite(prec[0]).all() and torch.isnan(ld[1])


@pytest.mark.parametrize('inverse', INVERSES)
def test_short_em_per_inverse_matches_jax(rng, inverse):
    """2 + 0 EM iterations per inverse against the JAX fused-kernel EM
    with the same inverse, under the 3e-2 that PARITY.md's stress leg
    holds the 2 + 0 EM to."""
    Y, act = _problem(rng, F=8, T=200, D=6)
    fm = np.arange(200) < 180
    want = np.asarray(jax_posteriors(
        jnp.asarray(Y), jnp.asarray(act),
        config=JaxCacgmmConfig(iterations=2, iterations_post=0,
                               em_backend='pallas', inverse=inverse),
        frame_mask=jnp.asarray(fm)))
    got = cacgmm.cacgmm_posteriors(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(iterations=2, iterations_post=0,
                                   inverse=inverse),
        frame_mask=torch.from_numpy(fm)).numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 3e-2, np.abs(got - want).max()


def test_eigh_inverse_gives_nan_for_a_non_finite_covariance(rng):
    """A non-finite covariance (an EM that blew up in one bin) gives NaN
    in that bin and leaves the rest alone, as ``jnp.linalg.eigh`` does;
    ``torch.linalg.eigh`` alone would raise for the whole batch."""
    from pb_chime5_tpu.ops.cacgmm import _invert as jax_invert
    cov = _covariances(rng)
    cov[1, 2, 0, 0] = np.inf
    cfg = cacgmm.CacgmmConfig(inverse='eigh')
    prec, ld = cacgmm._invert(torch.from_numpy(cov), cfg)
    prec_j, ld_j = jax_invert(jnp.asarray(cov), JaxCacgmmConfig(
        inverse='eigh'), batched=True)
    np.testing.assert_array_equal(torch.isnan(ld).numpy(),
                                  np.isnan(np.asarray(ld_j)))
    assert torch.isnan(prec[1, 2]).all() and torch.isnan(ld[1, 2])
    ok = torch.ones(ld.shape, dtype=torch.bool)
    ok[1, 2] = False
    assert torch.isfinite(prec[ok]).all() and torch.isfinite(ld[ok]).all()
