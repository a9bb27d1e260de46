"""The port's unsupervised masks (``ops/masks.py``) and the wrapper-level
beamformer entry points of ``ops/beamform.py`` (``condense_mask``, the
from-masks beamformers, the Lorenz / quantile MVDR wrappers, the unmasked
PSD and the fixed MVDR reference channel) against the JAX package's on
the same seeded inputs.

Tolerances:

* masks: equal entry for entry.  Each bin is compared with a threshold
  (a sorted power, or the quantile's linear interpolation, computed as
  ``jnp.quantile`` computes it); in float64 the masks must be identical,
  in float32 the share of entries that differ is asserted 0 (measured 0
  on these inputs; ties between a bin and the threshold are where the two
  packages could split);
* ``condense_mask``: equal (``jnp.median``'s ``(low + high) * 0.5`` at an
  even D, reproduced);
* the beamformed spectrograms: complex128 within 1e-10 of the peak (the
  same float64 operations; measured ~1e-15), complex64 MVDR within 1e-4
  of the peak of JAX's complex64 (float32 rounding of the solve); the
  port's GEV and LCMV compute in float64 whatever the input, so their
  complex64 outputs are held to JAX's complex128 chain on the same input
  within 1e-4 of the peak (the complex64 apply; measured ~1e-7).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops import beamform as jbf
from pb_chime5_tpu.ops import masks as jmasks
from pb_chime5_tpu_torch.ops import beamform as bf
from pb_chime5_tpu_torch.ops import masks

torch.set_num_threads(2)

D, T, F = 4, 120, 17
BF_F64_ATOL = 1e-10
BF_F32_ATOL = 1e-4
DTYPES = {'c64': np.complex64, 'c128': np.complex128}


@pytest.fixture(scope='module')
def spectrogram():
    """Y (D, T, F) complex128: noise with a loud stretch of frames, so the
    energy masks have something to find."""
    rng = np.random.default_rng(5)
    Y = rng.standard_normal((D, T, F)) + 1j * rng.standard_normal((D, T, F))
    Y[:, 40:80] *= 5
    Y[:, 100:, 3] *= 1e-3
    return Y


@pytest.fixture(scope='module')
def soft_masks():
    """Speech (D, T, F), interference (T, F) and noise (D, T, F) masks."""
    rng = np.random.default_rng(6)
    x = rng.random((D, T, F))
    return x, rng.random((T, F)), 1.0 - x


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES)
@pytest.mark.parametrize('axis', [-1, 1, 0])
def test_lorenz_mask_matches_jax(spectrogram, dtype, axis):
    Y = spectrogram.astype(dtype)
    got = masks.lorenz_mask(torch.from_numpy(Y), axis=axis)
    want = np.asarray(jmasks.lorenz_mask(jnp.asarray(Y), axis=axis))
    assert got.dtype == torch.from_numpy(Y.real).dtype
    assert got.shape == Y.shape
    assert (got.numpy() != want).mean() == 0
    assert set(np.unique(got.numpy())) <= {got.new_tensor(0.999).item(),
                                           got.new_tensor(1 - 0.999).item()}


@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES)
@pytest.mark.parametrize('quantile', [0.9, -0.3, [0.1, -0.8]],
                         ids=['loud', 'quiet', 'list'])
@pytest.mark.parametrize('sensor_axis,axis', [(None, -1), (None, -2),
                                              (0, -2), (0, 1)])
def test_quantile_mask_matches_jax(spectrogram, dtype, quantile,
                                   sensor_axis, axis):
    """Scalar and list quantiles, over time and frequency, with and
    without the sensor axis summed."""
    Y = spectrogram.astype(dtype)
    got = masks.quantile_mask(torch.from_numpy(Y), quantile,
                              sensor_axis=sensor_axis, axis=axis)
    want = jmasks.quantile_mask(jnp.asarray(Y), quantile,
                                sensor_axis=sensor_axis, axis=axis)
    if not isinstance(quantile, list):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.from_numpy(
            Y.real).dtype
        assert (g.numpy() != w).mean() == 0


@pytest.mark.parametrize('shape', [(4, T, F), (1, 4, T, F), (3, T, F),
                                   (T, F)],
                         ids=['even_D', 'leading_1', 'odd_D', '2d'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_condense_mask_matches_jax_median(shape, dtype):
    mask = np.random.default_rng(7).random(shape).astype(dtype)
    got = bf.condense_mask(torch.from_numpy(mask)).numpy()
    want = np.asarray(jbf.condense_mask(jnp.asarray(mask)))
    assert got.shape == (F, T)
    np.testing.assert_array_equal(got, want)
    if shape == (4, T, F):      # the mean of the middle two, not the lower
        s = np.sort(mask, axis=0)
        np.testing.assert_array_equal(got, ((s[1] + s[2]) * 0.5).T)
    with pytest.raises(NotImplementedError):
        bf.condense_mask(torch.zeros(5))


def _peak_error(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


FROM_MASKS = ['beamform_mvdr_souden_from_masks', 'beamform_gev_from_masks',
              'beamform_lcmv_from_masks']


@pytest.mark.parametrize('ban', [True, False], ids=['ban', 'no_ban'])
@pytest.mark.parametrize('name', FROM_MASKS)
@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES)
def test_from_masks_beamformers_match_jax(spectrogram, soft_masks, name,
                                          dtype, ban):
    x, i, n = soft_masks
    args = (x, i, n) if 'lcmv' in name else (x, n)
    Y = spectrogram.astype(dtype)
    got = getattr(bf, name)(
        torch.from_numpy(Y), *(torch.from_numpy(m.astype(Y.real.dtype))
                               for m in args), ban=ban).numpy()
    ref_Y = Y if 'mvdr' in name else Y.astype(np.complex128)
    want = np.asarray(getattr(jbf, name)(
        jnp.asarray(ref_Y), *(jnp.asarray(m.astype(ref_Y.real.dtype))
                              for m in args), ban=ban))
    assert got.shape == (T, F) and got.dtype == dtype
    assert np.isfinite(got).all()
    atol = BF_F64_ATOL if dtype == np.complex128 else BF_F32_ATOL
    assert _peak_error(got, want) <= atol, _peak_error(got, want)


@pytest.mark.parametrize('name', ['beamform_mvdr_souden_with_lorenz_mask',
                                  'beamform_mvdr_souden_with_quantile_mask'])
@pytest.mark.parametrize('dtype', DTYPES.values(), ids=DTYPES)
def test_unsupervised_mvdr_matches_jax(spectrogram, name, dtype):
    """The mask of ``X_hat`` (default Y), a (1, D, T, F) input too."""
    Y = spectrogram.astype(dtype)
    atol = BF_F64_ATOL if dtype == np.complex128 else BF_F32_ATOL
    for y in (Y, Y[None]):
        got = getattr(bf, name)(torch.from_numpy(y)).numpy()
        want = np.asarray(getattr(jbf, name)(jnp.asarray(y)))
        assert got.shape == (T, F)
        assert _peak_error(got, want) <= atol, _peak_error(got, want)
    X_hat = Y * np.linspace(0.5, 2.0, T)[None, :, None]
    got = getattr(bf, name)(torch.from_numpy(Y),
                            torch.from_numpy(X_hat.astype(dtype))).numpy()
    want = np.asarray(getattr(jbf, name)(jnp.asarray(Y),
                                         jnp.asarray(X_hat.astype(dtype))))
    assert _peak_error(got, want) <= atol


def test_psd_without_mask_and_fixed_reference_channel(spectrogram):
    """``psd_matrix(Y)`` (all ones) and ``mvdr_souden_vector``'s
    ``ref_channel``: an int, a negative int, a tensor index, and an int
    out of range (``ValueError``)."""
    Yf = spectrogram.transpose(2, 0, 1)                     # (F, D, T)
    got = bf.psd_matrix(torch.from_numpy(Yf)).numpy()
    want = np.asarray(jbf.psd_matrix(jnp.asarray(Yf)))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    mask = np.random.default_rng(8).random((F, T))
    cov_x = bf.psd_matrix(torch.from_numpy(Yf), torch.from_numpy(mask))
    cov_n = bf.psd_matrix(torch.from_numpy(Yf),
                          torch.from_numpy(1.0 - mask))
    for ref in (2, -1, torch.tensor(1)):
        w = bf.mvdr_souden_vector(cov_x, cov_n, ref_channel=ref).numpy()
        wj = np.asarray(jbf.mvdr_souden_vector(
            jnp.asarray(cov_x.numpy()), jnp.asarray(cov_n.numpy()),
            ref_channel=ref if isinstance(ref, int)
            else jnp.asarray(ref.numpy())))
        np.testing.assert_allclose(w, wj, rtol=1e-10, atol=1e-12)
    w, ch = bf.mvdr_souden_vector(cov_x, cov_n, return_ref_channel=True)
    np.testing.assert_allclose(
        bf.mvdr_souden_vector(cov_x, cov_n, ref_channel=int(ch)).numpy(),
        w.numpy())
    with pytest.raises(ValueError):
        bf.mvdr_souden_vector(cov_x, cov_n, ref_channel=D)
