"""Port WPE vs the JAX package and the float64 NumPy oracle.

Tolerance atol = rtol = 1e-4, as ``tests/test_wpe.py`` pins the JAX WPE
against the same oracle.  The regularized float32 main path is held to
the JAX main path at the same 1e-4 (its statistics are a real-form
staircase in JAX and a complex matmul here: same products, other
summation order, through a 1e-4-loaded solve).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops import wpe as jax_wpe
from pb_chime5_tpu.ops.wpe import (build_y_tilde as jax_build_y_tilde,
                                   get_power_inverse as jax_power_inverse)
from pb_chime5_tpu_torch.ops import wpe as port

from tests import reference_numpy as ref
from tests.test_wpe import _random_reverberant

torch.set_num_threads(2)


def test_build_y_tilde_matches_jax(rng):
    Y = rng.standard_normal((3, 2, 9)) + 1j * rng.standard_normal((3, 2, 9))
    for taps, delay in ((2, 1), (3, 2), (4, 8)):
        np.testing.assert_array_equal(
            port.build_y_tilde(torch.from_numpy(Y), taps, delay).numpy(),
            np.asarray(jax_build_y_tilde(jnp.asarray(Y), taps, delay)))


def test_power_inverse_matches_jax(rng):
    X = rng.standard_normal((2, 3, 10)) + 0j
    X[..., 5] = 0.0
    fm = np.arange(10) < 8
    for m in (None, fm):
        got = port.get_power_inverse(
            torch.from_numpy(X),
            frame_mask=None if m is None else torch.from_numpy(m)).numpy()
        want = np.asarray(jax_power_inverse(
            jnp.asarray(X), frame_mask=None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_wpe_matches_numpy_oracle_and_jax(rng):
    Y = _random_reverberant(rng)
    want = ref.wpe_np(Y, taps=4, delay=2, iterations=3)
    got = port.wpe(torch.from_numpy(Y), taps=4, delay=2, iterations=3,
                   regularization=0.0).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    jax_got = np.asarray(jax_wpe(jnp.asarray(Y), taps=4, delay=2,
                                 iterations=3, regularization=0.0))
    np.testing.assert_allclose(got, jax_got, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('masked', [False, True])
def test_wpe_main_path_matches_jax(rng, masked):
    """Main-path settings (10 taps, delay 2, 3 iterations, 1e-4 load),
    with and without a padded tail.  In complex128 the two packages agree
    to 1e-9 (same algorithm).  In complex64 the port is held to 1e-4 of
    the peak |X| against both the float64 result and the JAX float32
    result (measured: 1.4e-5 and 6.5e-5 of the peak over three seeds;
    the JAX float32 result itself sits 5e-5 of the peak from float64)."""
    Y = _random_reverberant(rng, F=9, D=4, T=200)
    fm = np.arange(200) < 170
    if masked:
        Y[..., 170:] = 0
    kw = dict(frame_mask=torch.from_numpy(fm) if masked else None)
    jkw = dict(frame_mask=jnp.asarray(fm) if masked else None)
    want64 = np.asarray(jax_wpe(jnp.asarray(Y), **jkw))
    np.testing.assert_allclose(port.wpe(torch.from_numpy(Y), **kw).numpy(),
                               want64, atol=1e-9, rtol=1e-9)
    Y32 = Y.astype(np.complex64)
    got = port.wpe(torch.from_numpy(Y32), **kw).numpy()
    want32 = np.asarray(jax_wpe(jnp.asarray(Y32), **jkw))
    assert got.dtype == np.complex64
    atol = 1e-4 * np.abs(want64).max()
    np.testing.assert_allclose(got, want64, atol=atol, rtol=0)
    np.testing.assert_allclose(got, want32, atol=atol, rtol=0)
    if masked:
        assert not got[..., 170:].any()



@pytest.mark.parametrize('context', [1, 2, 4])
def test_power_inverse_psd_context_matches_jax(rng, context):
    """The box sum over +-context frames divided by the frames the window
    holds (fewer at the edges), before the frame mask."""
    X = rng.standard_normal((2, 3, 12)) + 1j * rng.standard_normal((2, 3, 12))
    fm = np.arange(12) < 9
    for m in (None, fm):
        got = port.get_power_inverse(
            torch.from_numpy(X), context,
            None if m is None else torch.from_numpy(m)).numpy()
        want = np.asarray(jax_power_inverse(
            jnp.asarray(X), context, None if m is None else jnp.asarray(m)))
        np.testing.assert_allclose(got, want, rtol=1e-12)


def test_wpe_psd_context_matches_oracle_and_jax(rng):
    """At the 1e-4 that ``tests/test_wpe.py`` pins the JAX WPE to."""
    Y = _random_reverberant(rng, F=4, D=2, T=50)
    want = ref.wpe_np(Y, taps=3, delay=1, iterations=2, psd_context=2)
    kw = dict(taps=3, delay=1, iterations=2, psd_context=2,
              regularization=0.0)
    got = port.wpe(torch.from_numpy(Y), **kw).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(
        got, np.asarray(jax_wpe(jnp.asarray(Y), **kw)), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize('masked', [False, True])
def test_chunked_matches_unchunked_and_jax(rng, masked):
    """Chunked statistics (main-path taps, +-1 frame power context): the
    same sums in another association.  In complex128 chunked ==
    unchunked == JAX to 1e-8; in complex64 to 1e-4 of the peak |X|
    (measured <= 1.6e-5 on this scene; on less determined scenes the
    1e-4-loaded solve amplifies float32 rounding to ~1e-3 between ANY
    two float32 summation orders, the JAX package's own included)."""
    Y = _random_reverberant(rng, F=9, D=4, T=200)
    fm = np.arange(200) < 170
    if masked:
        Y[..., 170:] = 0
    kw = dict(psd_context=1)
    tkw = dict(kw, frame_mask=torch.from_numpy(fm) if masked else None)
    jkw = dict(kw, frame_mask=jnp.asarray(fm) if masked else None)
    for dtype, atol in ((np.complex128, 1e-8), (np.complex64, 1e-4)):
        Yd = Y.astype(dtype)
        base = port.wpe(torch.from_numpy(Yd), **tkw).numpy()
        scale = 1.0 if dtype == np.complex128 else np.abs(base).max()
        for chunk in (32, 50, 256):
            got = port.wpe(torch.from_numpy(Yd), chunk_size=chunk,
                           **tkw).numpy()
            np.testing.assert_allclose(got, base, atol=atol * scale, rtol=0)
            want = np.asarray(jax_wpe(jnp.asarray(Yd), chunk_size=chunk,
                                      stats_backend='xla', **jkw))
            np.testing.assert_allclose(got, want, atol=atol * scale, rtol=0)
            if masked:
                assert not got[..., 170:].any()


def test_chunked_pallas_backend_runs_no_statistics_kernel(rng, monkeypatch):
    """``chunk_size`` with ``stats_backend='pallas'``: the chunked complex
    statistics, as the JAX package runs its XLA chunked statistics there;
    the statistics kernel is not called."""
    calls = []
    monkeypatch.setattr(port, 'wpe_statistics',
                        lambda *a: calls.append(1) or None)
    Y = _random_reverberant(rng, F=3, D=2, T=60).astype(np.complex64)
    kw = dict(taps=3, delay=1, iterations=2, chunk_size=16)
    got = port.wpe(torch.from_numpy(Y), stats_backend='pallas', **kw)
    assert calls == []
    torch.testing.assert_close(
        got, port.wpe(torch.from_numpy(Y), stats_backend='xla', **kw),
        rtol=0, atol=0)


def test_solve_refine_matches_jax_and_cancels_bias(rng):
    """``tests/test_wpe.py``'s bias contraction: one refinement step
    brings the 1e-4-loaded WPE at least 5x closer to the unregularized
    oracle; the port equals JAX to 1e-8 in complex128."""
    Y = _random_reverberant(rng, F=5, D=3, T=120)
    want = ref.wpe_np(Y, taps=4, delay=1, iterations=2)

    def dev(refine, chunk_size=None):
        kw = dict(taps=4, delay=1, iterations=2, regularization=1e-4,
                  solve_refine=refine, chunk_size=chunk_size)
        got = port.wpe(torch.from_numpy(Y), **kw).numpy()
        np.testing.assert_allclose(
            got, np.asarray(jax_wpe(jnp.asarray(Y), stats_backend='xla',
                                    **kw)), atol=1e-8, rtol=0)
        return float(np.linalg.norm(got - want) / np.linalg.norm(want))

    d0, d1, d2 = dev(0), dev(1), dev(2)
    assert d1 < d0 / 5, (d0, d1)
    assert d2 < d1, (d1, d2)
    assert abs(dev(1, chunk_size=32) - d1) < 1e-9


def test_complex64_solve_runs_the_cholesky_kernel_entry(rng, monkeypatch):
    """complex64 with 32 < taps * D <= 256: every filter solve (plain and
    chunked iteration, ``solve_refine`` too) goes through
    ``hermitian_solve_chol``, whose plain version runs on the CPU; in
    complex128 (and at d <= 32) it is not called: there the solve is
    ``wpe.solve_floored`` (the library's Cholesky, which needs the
    floored plain version only where a pivot falls below JAX's floor)
    or ``linalg.hermitian_solve``."""
    from pb_chime5_tpu_torch.ops.kernels import chol_solve
    calls = []
    plain = chol_solve.hermitian_solve_chol_reference

    def counted(*args, **kwargs):
        calls.append(kwargs.get('refine'))
        return plain(*args, **kwargs)
    monkeypatch.setattr(chol_solve, 'hermitian_solve_chol_reference', counted)
    Y = _random_reverberant(rng, F=3, D=8, T=80)
    kw = dict(taps=5, delay=1, iterations=2)
    for chunk_size, refine in ((None, 0), (32, 1)):
        calls.clear()
        got = port.wpe(torch.from_numpy(Y.astype(np.complex64)),
                       chunk_size=chunk_size, solve_refine=refine, **kw)
        assert calls == [refine] * 2
        assert got.dtype == torch.complex64 and torch.isfinite(got).all()
    calls.clear()
    port.wpe(torch.from_numpy(Y), **kw)
    port.wpe(torch.from_numpy(Y.astype(np.complex64)), taps=4, delay=1,
             iterations=2)
    assert calls == []
