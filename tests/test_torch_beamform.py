"""Port MVDR-Souden + BAN and the reference-channel choice vs the JAX
package and the NumPy oracle.

Tolerances: complex128 1e-9 (same algorithm, same equilibrated
Gauss-Jordan solve).  complex64 1e-3 of the largest coefficient: the
64-eps diagonal load is ~1e-5 relative in float32, and both packages
sit 0.3-2% of the peak from their float64 results on this scene, but
within 3.3e-4 of the peak of each other (measured over four seeds).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops import beamform as jbf
from pb_chime5_tpu_torch.ops import beamform as tbf

from tests import reference_numpy as ref
from tests.test_beamform import _scene

torch.set_num_threads(2)


@pytest.mark.parametrize('dtype,tol', [(np.complex128, 1e-9),
                                       (np.complex64, 1e-3)])
def test_mvdr_ban_chain_matches_jax(rng, dtype, tol):
    Y, x_mask, n_mask, *_ = _scene(rng)
    Y = Y.astype(dtype)
    Yt, Yj = torch.from_numpy(Y), jnp.asarray(Y)
    cov_x = tbf.psd_matrix(Yt, torch.from_numpy(x_mask))
    cov_n = tbf.psd_matrix(Yt, torch.from_numpy(n_mask))
    cov_xj = jbf.psd_matrix(Yj, jnp.asarray(x_mask))
    cov_nj = jbf.psd_matrix(Yj, jnp.asarray(n_mask))

    def close(a, b):
        b = np.asarray(b)
        np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                                   atol=tol * np.abs(b).max())

    close(cov_x, cov_xj)
    close(cov_n, cov_nj)
    w, ref_ch = tbf.mvdr_souden_vector(cov_x, cov_n, return_ref_channel=True)
    wj, ref_chj = jbf.mvdr_souden_vector(cov_xj, cov_nj,
                                         return_ref_channel=True)
    assert int(ref_ch) == int(ref_chj)
    close(w, wj)
    w = tbf.blind_analytic_normalization(w, cov_n)
    wj = jbf.blind_analytic_normalization(wj, cov_nj)
    close(w, wj)
    close(tbf.apply_beamforming_vector(w, Yt),
          jbf.apply_beamforming_vector(wj, Yj))


def test_mvdr_matches_numpy_oracle(rng):
    Y, x_mask, n_mask, *_ = _scene(rng)
    cov_x = ref.psd_np(Y, x_mask)
    cov_n = ref.psd_np(Y, n_mask)
    np.testing.assert_allclose(
        tbf.psd_matrix(torch.from_numpy(Y), torch.from_numpy(x_mask)).numpy(),
        cov_x, rtol=1e-10, atol=1e-12)
    w, ref_ch = tbf.mvdr_souden_vector(torch.from_numpy(cov_x),
                                       torch.from_numpy(cov_n),
                                       return_ref_channel=True)
    want, want_ch = ref.mvdr_souden_np(cov_x, cov_n)
    assert int(ref_ch) == want_ch
    np.testing.assert_allclose(w.numpy(), want, atol=1e-8)
    w_ban = tbf.blind_analytic_normalization(w, torch.from_numpy(cov_n))
    np.testing.assert_allclose(
        w_ban.numpy(), ref.ban_np(w.numpy(), cov_n), atol=1e-8)


def test_silent_mask_stays_finite(rng):
    Y, x_mask, _, *_ = _scene(rng)
    Y = Y.astype(np.complex64)
    cov_x = tbf.psd_matrix(torch.from_numpy(Y), torch.from_numpy(x_mask))
    cov_n = tbf.psd_matrix(torch.from_numpy(Y),
                           torch.zeros(x_mask.shape))
    w = tbf.blind_analytic_normalization(
        tbf.mvdr_souden_vector(cov_x, cov_n), cov_n)
    assert torch.isfinite(w).all()


def _covs(Y, *masks):
    return [tbf.psd_matrix(torch.from_numpy(Y), torch.from_numpy(m))
            for m in masks], [jbf.psd_matrix(jnp.asarray(Y), jnp.asarray(m))
                              for m in masks]


@pytest.mark.parametrize('dtype,tol', [(np.complex128, 1e-8),
                                       (np.complex64, 1e-3)])
def test_gev_matches_jax_and_scipy(rng, dtype, tol):
    """GEV against the JAX function (complex128 1e-8, as
    ``tests/test_linalg_device.py`` pins the eigenvector; complex64 1e-3
    of the largest coefficient, as for MVDR above) and against SciPy's
    generalized eigenvector at the 1e-6 ``tests/test_beamform.py`` pins."""
    Y, x_mask, n_mask, *_ = _scene(rng)
    Y = Y.astype(dtype)
    (cx, cn), (cxj, cnj) = _covs(Y, x_mask, n_mask)
    w = tbf.gev_vector(cx, cn).numpy()
    wj = np.asarray(jbf.gev_vector(cxj, cnj))
    np.testing.assert_allclose(w, wj, atol=tol * np.abs(wj).max())
    if dtype == np.complex128:
        np.testing.assert_allclose(
            w, ref.gev_np(cx.numpy(), cn.numpy()), atol=1e-6)
    w_ban = tbf.blind_analytic_normalization(torch.from_numpy(w), cn)
    wj_ban = np.asarray(jbf.blind_analytic_normalization(wj, cnj))
    np.testing.assert_allclose(w_ban.numpy(), wj_ban,
                               atol=tol * np.abs(wj_ban).max())


@pytest.mark.parametrize('dtype,tol', [(np.complex128, 1e-8),
                                       (np.complex64, 1e-3)])
def test_lcmv_matches_jax_and_nulls_interference(rng, dtype, tol):
    """LCMV against the JAX function; unit response toward the target's
    dominant eigenvector, a null toward the interference's."""
    Y, x_mask, n_mask, *_ = _scene(rng)
    Y = Y.astype(dtype)
    noise = 0 * n_mask + 0.05
    (cx, ci, cn), (cxj, cij, cnj) = _covs(Y, x_mask, n_mask, noise)
    w = tbf.lcmv_vector(cx, ci, cn)
    wj = np.asarray(jbf.lcmv_vector(cxj, cij, cnj))
    np.testing.assert_allclose(w.numpy(), wj, atol=tol * np.abs(wj).max())
    if dtype == np.complex128:
        from pb_chime5_tpu_torch.ops.linalg import dominant_eigenvector
        a_x = dominant_eigenvector(cx)
        a_i = dominant_eigenvector(ci)
        resp_x = torch.einsum('fd,fd->f', w.conj(), a_x)
        resp_i = torch.einsum('fd,fd->f', w.conj(), a_i)
        np.testing.assert_allclose(resp_x.numpy(), 1.0, atol=1e-8)
        np.testing.assert_allclose(resp_i.numpy(), 0.0, atol=1e-8)
