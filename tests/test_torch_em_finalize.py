"""The fused EM finalize (``ops/kernels/gj_inverse.py::em_finalize``) on
the CPU, where it runs its plain version: against the finalize of the
JAX fused-kernel EM, as the port's finalize it replaced, and its routing
(``ops/cacgmm.py::_finalize``; the MVDR solve's Gauss-Jordan in
``ops/beamform.py::mvdr_souden_vector``).

Tolerances: those of ``tests/test_torch_cacgmm.py::
test_invert_matches_jax`` for complex64 (precision within 1e-4 of each
matrix's largest entry, logdet within 1e-4 of the largest |logdet|) on
full-rank scatter (float32 on a rank-deficient class sits far from
float64 in both packages alike); log_weight within 1e-6 (the sum over K
in another order).  The empty class and the silent frequency give
log(FLT_MIN) exactly in both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops import cacgmm as jax_cacgmm
from pb_chime5_tpu_torch.ops import beamform, cacgmm, linalg
from pb_chime5_tpu_torch.ops.kernels import gj_inverse
from tests.test_torch_kernels_cuda import DIAGONAL_FLOOR, em_state

torch.set_num_threads(2)

TOL = 1e-4
LOG_WEIGHT_ATOL = 1e-6
FLOOR_OF = {'gauss_jordan': 'relative', 'pallas_gj': 'flt_min'}


def jax_finalize(S, den, inverse):
    """The ``finalize`` of the JAX fused-kernel EM
    (``pb_chime5_tpu/ops/cacgmm.py:483-499``), rebuilt from its
    ``hermitize``, ``_trace_normalize`` and ``_invert(..., batched=True)``;
    ``'pallas_gj'`` runs K3 in interpret mode on the CPU."""
    S, den = jnp.asarray(S.numpy()), jnp.asarray(den.numpy())
    D = S.shape[-1]
    tiny = jnp.finfo(jnp.float32).tiny
    total = jnp.sum(den, axis=-1, keepdims=True)
    weight = jnp.where(total > 0, den / jnp.maximum(total, tiny),
                       jnp.zeros((), jnp.float32))
    log_weight = jnp.log(jnp.maximum(weight, tiny))
    denom_floor = 2.0 * D / jnp.finfo(jnp.float32).max
    cov = jax_cacgmm._trace_normalize(jax_cacgmm.hermitize(
        S * (D / jnp.maximum(den, denom_floor))[..., None, None]
        .astype(S.dtype)))
    precision, logdet = jax_cacgmm._invert(
        cov, jax_cacgmm.CacgmmConfig(inverse=inverse), batched=True)
    return tuple(np.asarray(x) for x in (log_weight, precision, logdet))


@pytest.mark.parametrize('inverse', sorted(FLOOR_OF))
@pytest.mark.parametrize('K,D', [(1, 2), (2, 3), (3, 4), (4, 5), (5, 6)])
def test_reference_matches_jax_finalize(inverse, K, D):
    S, den = em_state(7, K, D, frames=3 * D, seed=K + D)
    lw, prec, ld = gj_inverse.em_finalize(
        S, den, diagonal_floor=DIAGONAL_FLOOR, floor=FLOOR_OF[inverse])
    lw_j, prec_j, ld_j = jax_finalize(S, den, inverse)
    assert lw.shape == den.shape and prec.shape == S.shape \
        and ld.shape == den.shape
    assert prec.dtype == torch.complex64 and ld.dtype == torch.float32
    scale = np.abs(prec_j).max(axis=(-2, -1), keepdims=True)
    np.testing.assert_allclose(prec.numpy() / scale, prec_j / scale,
                               atol=TOL)
    np.testing.assert_allclose(ld.numpy(), ld_j, atol=TOL * np.abs(ld_j).max())
    np.testing.assert_allclose(lw.numpy(), lw_j, atol=LOG_WEIGHT_ATOL, rtol=0)
    # the silent frequency and the empty class: log(FLT_MIN) exactly
    empty = [(0, k) for k in range(K)] + [(1, K - 1)]
    for f, k in empty:
        assert lw[f, k] == lw_j[f, k] == np.log(np.float32(1.1754944e-38))
    assert all(torch.isfinite(x).all() for x in (lw, prec, ld))


@pytest.mark.parametrize('inverse', sorted(FLOOR_OF))
def test_reference_is_the_finalize_it_replaced(inverse):
    """Bit for bit: the weights and covariances, then ``_invert``: the
    port's finalize before it became one entry (EM-like rank-deficient
    scatter, the empty class, a tiny den, the silent frequency)."""
    S, den = em_state(9, 5, 8, seed=2)
    got = gj_inverse.em_finalize(S, den, diagonal_floor=DIAGONAL_FLOOR,
                                 floor=FLOOR_OF[inverse])
    log_weight, cov = gj_inverse.em_covariances(S, den)
    want = (log_weight, *cacgmm._invert(
        cov, cacgmm.CacgmmConfig(inverse=inverse)))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize('floor', sorted(gj_inverse.FLOORS))
def test_entries_run_reference_on_cpu_without_counting(floor):
    S, den = em_state(4, 3, 5, seed=1)
    before = gj_inverse.em_finalize.launches
    got = gj_inverse.em_finalize(S, den, diagonal_floor=DIAGONAL_FLOOR,
                                 floor=floor)
    want = gj_inverse.em_finalize_reference(
        S, den, diagonal_floor=DIAGONAL_FLOOR, floor=floor)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert gj_inverse.em_finalize.launches == before
    B = gj_inverse.add_jitter(gj_inverse.em_covariances(S, den)[1], 1e-6)
    entry = gj_inverse.gauss_jordan_inverse_and_logdet
    before = entry.launches
    got = entry(B)
    want = linalg.gauss_jordan_inverse_and_logdet(B)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert entry.launches == before


@pytest.mark.parametrize('bad', [
    'S dtype', 'den dtype', 'den shape', 'S rank', 'not square', 'K', 'D',
    'layout', 'empty', 'floor'])
def test_em_finalize_rejects_unsupported_inputs(bad):
    S, den = em_state(3, 2, 4, seed=3)
    kw = dict(diagonal_floor=DIAGONAL_FLOOR)
    if bad == 'S dtype':
        S = S.to(torch.complex128)
    elif bad == 'den dtype':
        den = den.double()
    elif bad == 'den shape':
        den = den[:, :1].contiguous()
    elif bad == 'S rank':
        S = S[0]
    elif bad == 'not square':
        S = S[..., :3].contiguous()
    elif bad == 'K':
        S, den = em_state(2, gj_inverse.MAX_K + 1, 4)
    elif bad == 'D':
        S, den = em_state(2, 1, gj_inverse.MAX_D + 1)
    elif bad == 'layout':
        S = S.transpose(-2, -1)
    elif bad == 'empty':
        S, den = S[:0], den[:0]
    else:
        kw['floor'] = 'flushed_log'
    with pytest.raises(ValueError):
        gj_inverse.em_finalize(S, den, **kw)


@pytest.mark.parametrize('inverse', cacgmm.INVERSES)
def test_finalize_calls_em_finalize_for_the_gauss_jordan_inverses(
        inverse, monkeypatch):
    """Once per finalize (1 + 2 + 1 at 3 + 2 iterations) for 'auto',
    'gauss_jordan' and 'pallas_gj', with their floors; never for the
    other inverses."""
    rng = np.random.default_rng(0)
    F, T, D, K = 4, 80, 4, 3
    Y = (rng.standard_normal((F, T, D))
         + 1j * rng.standard_normal((F, T, D))).astype(np.complex64)
    act = rng.random((K, T)) > 0.3
    calls = []
    real = cacgmm.em_finalize

    def record(S, den, **kw):
        calls.append(kw['floor'])
        return real(S, den, **kw)
    monkeypatch.setattr(cacgmm, 'em_finalize', record)
    got = cacgmm.cacgmm_posteriors(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(iterations=3, iterations_post=2,
                                   inverse=inverse))
    floor = {'auto': 'relative', 'gauss_jordan': 'relative',
             'pallas_gj': 'flt_min'}.get(inverse)
    assert calls == ([floor] * 4 if floor else [])
    assert torch.isfinite(got).all()


def test_mvdr_solve_takes_the_kernel_entry_on_complex64_only(monkeypatch):
    """The MVDR solve (``ops/beamform.py``) goes through the kernel's
    relative-mode entry for complex64 (its plain version on the CPU, so
    the solve is ``linalg.hermitian_solve``'s bit for bit); complex128
    keeps the plain function, and ``linalg.hermitian_solve`` itself never
    reaches the entry, for any method or dtype."""
    rng = np.random.default_rng(1)
    A = rng.standard_normal((5, 6, 6)) + 1j * rng.standard_normal((5, 6, 6))
    A = A @ A.conj().swapaxes(-1, -2) + np.eye(6)
    B = rng.standard_normal((5, 6, 6)) + 1j * rng.standard_normal((5, 6, 6))
    B = B @ B.conj().swapaxes(-1, -2)
    calls = []
    real = gj_inverse.gauss_jordan_inverse_and_logdet

    def record(M):
        calls.append(M.dtype)
        return real(M)
    monkeypatch.setattr(gj_inverse, 'gauss_jordan_inverse_and_logdet', record)
    A64, B64 = (torch.as_tensor(x.astype(np.complex64)) for x in (A, B))
    assert torch.equal(gj_inverse.hermitian_solve_gj(A64, B64),
                       linalg.hermitian_solve(A64, B64))
    assert calls == [torch.complex64]
    w = beamform.mvdr_souden_vector(B64, A64)
    assert calls == [torch.complex64] * 2
    assert w.dtype == torch.complex64 and torch.isfinite(w).all()
    beamform.mvdr_souden_vector(torch.as_tensor(B), torch.as_tensor(A))
    for method in ('gj', 'block_gj', 'schur', 'chol'):
        for dtype in (torch.complex64, torch.complex128):
            linalg.hermitian_solve(torch.as_tensor(A).to(dtype),
                                   torch.as_tensor(B).to(dtype),
                                   method=method)
    assert calls == [torch.complex64] * 2
