"""The port's per-frequency cacGMM EM (``em_backend='xla'``), its T-chunked
iteration (``em_chunk_size``) and the debug twin
(``cacgmm_posteriors_debug``) against the JAX package's on the same
seeded inputs (JAX off the TPU runs this EM itself, as ``'auto'``).

Tolerances:

* complex128 at 20 + 1 iterations: posteriors within 1e-9 (both packages
  run the same float64 operations in other summation orders; measured
  ~1e-13);
* complex64 at 2 + 0: within 1e-4 (float32 rounding through two M-steps
  and the final E-step; measured ~1e-6; longer float32 trajectories are
  chaotic, as tests/test_torch_cacgmm.py notes);
* the chunked EM against JAX's chunked EM, and against the port's unfused
  EM, within 1e-9 in complex128 (the chunk only reorders the sums of S and
  den; measured ~1e-13); on the card ``chip_smoke.py`` holds the chunked
  EM to the unfused one at 1e-6 in float64 at the headline.

An unmasked (E, M) pass (``iterations_post > 1``) lets an empty class
grow from denormal responsibilities, whose values depend on the order of
the sums: there JAX's own chunked and unfused EMs differ by 1.  The tests
with such a pass give every class some activity.
* the debug twin's statistics and posteriors within 1e-9 in complex128.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops.cacgmm import CacgmmConfig as JaxCacgmmConfig
from pb_chime5_tpu.ops.cacgmm import cacgmm_posteriors as jax_posteriors
from pb_chime5_tpu.ops.cacgmm import (
    cacgmm_posteriors_debug as jax_posteriors_debug)
from pb_chime5_tpu_torch.ops import cacgmm
from pb_chime5_tpu_torch.ops.kernels import gj_inverse
from tests.test_torch_cacgmm_cuda import complex128_calls

torch.set_num_threads(2)

F, T, D, K = 6, 240, 6, 3
F64_ATOL = 1e-9
F32_ATOL = 1e-4


@pytest.fixture(scope='module')
def problem():
    """Y (F, T, D) complex128 with an all-zero frequency and zero padded
    frames, activity (K, T) with an empty class (class 1 never active),
    frame mask (T,)."""
    rng = np.random.default_rng(3)
    Y = rng.standard_normal((F, T, D)) + 1j * rng.standard_normal((F, T, D))
    Y[:, :, 0] *= 3.0
    Y[4] = 0
    valid = T - 20
    Y[:, valid:] = 0
    act = np.zeros((K, T), bool)
    act[0, :150] = True
    act[2] = True
    return Y, act, np.arange(T) < valid


@pytest.fixture(scope='module')
def no_empty_class(problem):
    """``problem`` with class 1 active in frames 100-199."""
    Y, act, fm = problem
    act = act.copy()
    act[1, 100:200] = True
    return Y, act, fm


def both(Y, act, fm, dtype, **kw):
    """(port, JAX) posteriors with ``em_backend='xla'`` and ``kw``."""
    Yd = Y.astype(dtype)
    got = cacgmm.cacgmm_posteriors(
        torch.from_numpy(Yd), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(em_backend='xla', **kw),
        frame_mask=None if fm is None else torch.from_numpy(fm)).numpy()
    want = np.asarray(jax_posteriors(
        jnp.asarray(Yd), jnp.asarray(act),
        config=JaxCacgmmConfig(em_backend='xla', **kw),
        frame_mask=None if fm is None else jnp.asarray(fm)))
    return got, want


@pytest.mark.parametrize('inverse', cacgmm.INVERSES)
def test_xla_em_matches_jax_complex128(problem, inverse):
    """20 + 1 iterations, every inverse ('pallas_gj' is the relative
    floor here, as JAX's unbatched ``_invert`` has it)."""
    Y, act, fm = problem
    got, want = both(Y, act, fm, np.complex128, inverse=inverse)
    assert got.dtype == np.float64 and got.shape == (F, K, T)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=F64_ATOL, rtol=0)
    assert got[:, 1].max() < 1e-200             # the empty class
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.parametrize('inverse', ['auto', 'pallas_gj', 'eigh'])
def test_xla_em_matches_jax_complex64_short(problem, inverse):
    Y, act, fm = problem
    got, want = both(Y, act, fm, np.complex64, iterations=2,
                     iterations_post=0, inverse=inverse)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize('post', [0, 2], ids=['post0', 'post2'])
@pytest.mark.parametrize('masked', [True, False], ids=['fm', 'no_fm'])
def test_xla_em_iteration_structure_matches_jax(problem, no_empty_class,
                                                post, masked):
    """``iterations_post`` 0 (a masked final E-step, the empty class
    kept) and 2 (one unmasked (E, M) pass), with and without the frame
    mask."""
    Y, act, fm = problem if post == 0 else no_empty_class
    got, want = both(Y, act, fm if masked else None, np.complex128,
                     iterations=6, iterations_post=post)
    np.testing.assert_allclose(got, want, atol=F64_ATOL, rtol=0)
    if post == 0:                              # masked: inactive -> 0
        assert not got[:, 0, 150:].any()


@pytest.mark.parametrize('chunk', [60, 70], ids=['divides', 'remainder'])
@pytest.mark.parametrize('post', [1, 2], ids=['post1', 'post2'])
def test_chunked_em_matches_jax_and_unfused(problem, no_empty_class, chunk,
                                            post):
    """A chunk that divides T and one that leaves a short last chunk, at
    the default 1 post iteration (the empty class kept) and at 2:
    against JAX's chunked EM and the port's own unfused EM."""
    Y, act, fm = problem if post == 1 else no_empty_class
    got, want = both(Y, act, fm, np.complex128, em_chunk_size=chunk,
                     iterations=8, iterations_post=post)
    np.testing.assert_allclose(got, want, atol=F64_ATOL, rtol=0)
    unfused, _ = both(Y, act, fm, np.complex128, iterations=8,
                      iterations_post=post)
    np.testing.assert_allclose(got, unfused, atol=F64_ATOL, rtol=0)


def test_chunked_em_complex64_matches_jax(problem):
    Y, act, fm = problem
    got, want = both(Y, act, fm, np.complex64, em_chunk_size=64,
                     iterations=2, iterations_post=0)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize('backend', ['auto', 'pallas', 'xla'])
def test_debug_twin_matches_jax(no_empty_class, backend):
    """The four statistics (I = 1 + 5 + 1 M-steps) and the posteriors:
    the unfused EM whatever ``em_backend`` (and ``em_chunk_size``) say."""
    Y, act, fm = no_empty_class
    kw = dict(iterations=6, iterations_post=2)
    got, stats = cacgmm.cacgmm_posteriors_debug(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(em_backend=backend, em_chunk_size=64,
                                   **kw),
        frame_mask=torch.from_numpy(fm))
    want, stats_j = jax_posteriors_debug(
        jnp.asarray(Y), jnp.asarray(act), config=JaxCacgmmConfig(**kw),
        frame_mask=jnp.asarray(fm))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=F64_ATOL, rtol=0)
    assert sorted(stats) == sorted(stats_j) == [
        'condition', 'logdet', 'posterior_entropy', 'weights']
    for key, value in stats.items():
        assert value.shape == (7, F, K)[:value.dim()] == stats_j[key].shape
        np.testing.assert_allclose(value.numpy(), np.asarray(stats_j[key]),
                                   atol=F64_ATOL, rtol=1e-12)
    np.testing.assert_allclose(stats['weights'].sum(dim=-1).numpy(), 1.0,
                               atol=1e-12)
    # >= 1 but for the jitter: B = I (a silent frequency) gives
    # 1 / (1 + diagonal_floor)
    assert (stats['condition'] >= 1 / (1 + 1e-6) - 1e-12).all()
    ent = stats['posterior_entropy']
    assert (ent >= 0).all() and (ent <= np.log(K) + 1e-12).all()


def test_auto_routes_by_dtype(problem, monkeypatch):
    """'auto' runs the fused-kernel driver for complex64 and the
    per-frequency EM for complex128; 'pallas' with complex128 raises."""
    Y, act, fm = problem
    calls = []
    for name in ('_cacgmm_posteriors_fused', '_cacgmm_posteriors_xla'):
        real = getattr(cacgmm, name)

        def record(*args, _name=name, _real=real, **kwargs):
            calls.append(_name)
            return _real(*args, **kwargs)
        monkeypatch.setattr(cacgmm, name, record)
    cfg = cacgmm.CacgmmConfig(iterations=2)
    for dtype in (np.complex64, np.complex128):
        out = cacgmm.cacgmm_posteriors(torch.from_numpy(Y.astype(dtype)),
                                       torch.from_numpy(act), config=cfg)
        assert out.dtype == (torch.float32 if dtype == np.complex64
                             else torch.float64)
    assert calls == ['_cacgmm_posteriors_fused', '_cacgmm_posteriors_xla']
    with pytest.raises(ValueError):
        cacgmm.cacgmm_posteriors(
            torch.from_numpy(Y), torch.from_numpy(act),
            config=cacgmm.CacgmmConfig(em_backend='pallas'))


@pytest.mark.parametrize('dtype', [np.complex64, np.complex128],
                         ids=['c64', 'c128'])
def test_xla_inverses_run_by_dtype(problem, dtype, monkeypatch):
    """complex64: every unfused M-step's inverse on the Gauss-Jordan
    kernel's relative entry (20 at 20 + 1), the chunked EM's later
    M-steps on ``em_finalize`` with the relative floor ('pallas_gj'
    included: 1 + 19); complex128: neither entry is called (plain
    PyTorch by dtype)."""
    Y, act, fm = problem
    calls = []
    for name in ('gauss_jordan_inverse_and_logdet', 'em_finalize'):
        real = getattr(gj_inverse, name)

        def record(*args, _name=name, _real=real, **kwargs):
            calls.append((_name, kwargs.get('floor')))
            return _real(*args, **kwargs)
        monkeypatch.setattr(gj_inverse, name, record)
        monkeypatch.setattr(cacgmm, name, record, raising=False)
    Yt, act_t = torch.from_numpy(Y.astype(dtype)), torch.from_numpy(act)
    cacgmm.cacgmm_posteriors(Yt, act_t, config=cacgmm.CacgmmConfig(
        em_backend='xla', inverse='pallas_gj'))
    unfused, calls[:] = list(calls), []
    cacgmm.cacgmm_posteriors(Yt, act_t, config=cacgmm.CacgmmConfig(
        em_backend='xla', inverse='pallas_gj', em_chunk_size=100))
    if dtype == np.complex128:
        assert unfused == calls == []
        return
    assert unfused == [('gauss_jordan_inverse_and_logdet', None)] * 20
    assert calls == [('gauss_jordan_inverse_and_logdet', None)] + [
        ('em_finalize', 'relative')] * 19


def test_make_initialization_follows_dtype():
    from pb_chime5_tpu.ops.cacgmm import make_initialization
    act = np.random.default_rng(1).random((3, 40)) > 0.5
    for dtype, jdtype in ((torch.float64, jnp.float64),
                          (torch.float32, jnp.float32)):
        got = cacgmm.make_initialization(torch.from_numpy(act), dtype=dtype)
        want = np.asarray(make_initialization(jnp.asarray(act), jdtype))
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_params_from_numpy_takes_a_dtype():
    rng = np.random.default_rng(2)
    params = (rng.standard_normal((2, 3)),
              rng.standard_normal((2, 3, 4, 4)) + 0j,
              rng.standard_normal((2, 3)))
    lw, prec, ld = cacgmm.params_from_numpy(params, 'cpu', torch.float64)
    assert (lw.dtype, prec.dtype, ld.dtype) == (
        torch.float64, torch.complex128, torch.float64)
    np.testing.assert_array_equal(prec.numpy(), params[1])
    lw, prec, ld = cacgmm.params_from_numpy(params, 'cpu')
    assert (lw.dtype, prec.dtype) == (torch.float32, torch.complex64)


def test_kernel_wrappers_refuse_complex128():
    """The wrappers' dtype checks hold on any device: complex128 CPU
    tensors raise too (the card test holds the CUDA ones), so the float64
    chain never reaches a kernel wrapper."""
    for call in complex128_calls('cpu'):
        with pytest.raises(ValueError):
            call()


def test_chunked_em_works_on_chunks_only(problem, monkeypatch):
    """With ``em_chunk_size`` every E-step and every scatter (the first
    M-step's and the final E-step's included) sees at most that many
    frames: no (F, K, T, D) intermediate is made."""
    Y, act, fm = problem
    seen = []
    for name in ('_e_step', '_scatter'):
        real = getattr(cacgmm, name)

        def record(z, *args, _real=real, _name=name):
            if _name == '_e_step' or len(args) == 1 or not args[1]:
                seen.append(z.shape[1])       # not the chunking call
            return _real(z, *args)
        monkeypatch.setattr(cacgmm, name, record)
    cacgmm.cacgmm_posteriors(
        torch.from_numpy(Y), torch.from_numpy(act),
        config=cacgmm.CacgmmConfig(em_backend='xla', em_chunk_size=70,
                                   iterations=3),
        frame_mask=torch.from_numpy(fm))
    assert seen and max(seen) <= 70
    # 4 chunks of 240 frames: the first scatter, 2 iterations of an
    # E-step and a scatter each, the final E-step
    assert len(seen) == 4 * (1 + 2 * 2 + 1)


def test_xla_em_beyond_the_kernels_shapes_matches_jax():
    """D = 40 (> the Gauss-Jordan kernel's 32) in complex64: the M-step's
    inverse and the chunked finalize run in plain PyTorch, by shape."""
    rng = np.random.default_rng(8)
    Y = rng.standard_normal((3, 200, 40)) + 1j * rng.standard_normal(
        (3, 200, 40))
    act = rng.random((3, 200)) > 0.3
    for chunk in (None, 64):
        got, want = both(Y, act, None, np.complex64, iterations=2,
                         iterations_post=0, em_chunk_size=chunk)
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
