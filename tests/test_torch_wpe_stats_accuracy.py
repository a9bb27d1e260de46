"""The float32 WPE statistics' T sum on a stress-like input, on the CPU.

The input is the stress scene of tests/test_torch_stress_headline.py
(seed 0, 67 s, D = 24: T = 4191 at the 1024 / 256 STFT) at the three
frequencies (12, 68, 93) where one float32 sum over all T put the second
WPE iteration's R past the 1e-4 load on the card; taps * D = 240.  On
the second iteration's inputs:

* the default route (``wpe_statistics_reference``: 256-frame tiles added
  into complex128) lies within 1.2e-6 of complex128 sums of the same
  inputs, R's and P's relative Frobenius distance per frequency: a fifth
  of the 4.75-5.97e-6 one float32 sum over all T gave on the card;
* its tiles are what it sums: the tile products, added in complex128;
* a single sequential float32 sum over all T (each frame's product added
  in turn, as one long dot accumulates; R's first 8 rows) lies past that
  bound, so the bound tells the two apart;
* it agrees with the JAX package's statistics kernel (interpret mode) at
  1e-5, the tolerance of tests/test_torch_wpe_stats.py, and with JAX's
  default statistics (the real-form staircase) at atol = rtol = 1e-4
  of the scale, the tolerance of tests/test_torch_wpe.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops.pallas.wpe_stats import (
    wpe_statistics as jax_wpe_statistics)
from pb_chime5_tpu_torch.ops import wpe as port
from pb_chime5_tpu_torch.ops.kernels import wpe_stats
from pb_chime5_tpu_torch.ops.stft import stft
from tests.test_torch_kernels_cuda import stats_errors
from tests.test_torch_stress_headline import make_production_scene

# the module: the package's ``ops`` re-exports its function ``wpe``
jax_wpe_module = importlib.import_module('pb_chime5_tpu.ops.wpe')
torch.set_num_threads(2)

FREQUENCIES = (12, 68, 93)
BOUND = 1.2e-6
TAPS, DELAY = 10, 2


@pytest.fixture(scope='module')
def scene():
    """Y (3, 24, 4191) complex64 at FREQUENCIES; the second iteration's
    stacked signal and weights."""
    obs, _, _ = make_production_scene(np.random.default_rng(0))
    bins = []
    for channel in obs.astype(np.float32):      # one channel at a time
        spec = stft(torch.from_numpy(channel), 1024, 256, fading=True)
        bins.append(spec[:, list(FREQUENCIES)])
    Y = torch.stack(bins).permute(2, 0, 1).contiguous()   # (F, D, T)
    X1 = port.wpe(Y, taps=TAPS, delay=DELAY, iterations=1)
    Y_tilde = port.build_y_tilde(Y, TAPS, DELAY).contiguous()
    return Y, Y_tilde, port.get_power_inverse(X1).contiguous()


def float64_sums(Y_tilde, Y, w):
    a = Y_tilde.to(torch.complex128)
    aw = a * w[:, None, :].double()
    return (aw @ a.conj().transpose(-2, -1),
            aw @ Y.to(torch.complex128).conj().transpose(-2, -1))


def relative(x, ref):
    return (torch.linalg.matrix_norm(x.to(torch.complex128) - ref)
            / torch.linalg.matrix_norm(ref))


def test_default_route_within_bound_of_float64_sums(scene):
    Y, Y_tilde, w = scene
    assert Y.shape == (3, 24, 4191) and Y_tilde.shape[1] == 240
    R, P = wpe_stats.wpe_statistics_reference(Y_tilde, Y, w)
    assert R.dtype == P.dtype == torch.complex64
    R64, P64 = float64_sums(Y_tilde, Y, w)
    Rh = R.to(torch.complex128)
    Rh = (Rh + Rh.conj().transpose(-2, -1)) / 2      # as the solve sees it
    err_R, err_P = relative(Rh, R64), relative(P, P64)
    assert (err_R <= BOUND).all() and (err_P <= BOUND).all(), (err_R, err_P)


def test_default_route_sums_its_tiles_in_complex128(scene):
    Y, Y_tilde, w = scene
    R, P = wpe_stats.wpe_statistics_reference(Y_tilde, Y, w)
    tile = wpe_stats.TILE
    R_sum = torch.zeros(R.shape, dtype=torch.complex128)
    P_sum = torch.zeros(P.shape, dtype=torch.complex128)
    for t0 in range(0, Y.shape[-1], tile):
        yt = Y_tilde[..., t0:t0 + tile]
        weighted = yt * w[:, None, t0:t0 + tile].to(yt.dtype)
        R_sum += weighted @ yt.conj().transpose(-2, -1)
        P_sum += weighted @ Y[..., t0:t0 + tile].conj().transpose(-2, -1)
    assert torch.equal(R, R_sum.to(torch.complex64))
    assert torch.equal(P, P_sum.to(torch.complex64))


def test_one_float32_sum_over_all_frames_misses_the_bound(scene):
    Y, Y_tilde, w = scene
    rows = 8
    R64 = float64_sums(Y_tilde, Y, w)[0][:, :rows]
    weighted = Y_tilde[:, :rows] * w[:, None, :].to(Y_tilde.dtype)
    conj = Y_tilde.conj()
    acc = torch.zeros((Y.shape[0], rows, Y_tilde.shape[1]),
                      dtype=torch.complex64)
    for t in range(Y.shape[-1]):
        acc += weighted[:, :, t, None] * conj[:, None, :, t]
    err = relative(acc, R64)
    R = wpe_stats.wpe_statistics_reference(Y_tilde, Y, w)[0][:, :rows]
    assert (relative(R, R64) <= BOUND).all()
    assert (err > BOUND).any(), err


def test_default_route_matches_jax_kernel(scene):
    Y, Y_tilde, w = scene
    R, P = wpe_stats.wpe_statistics_reference(Y_tilde, Y, w)
    R_j, P_j = jax_wpe_statistics(jnp.asarray(Y_tilde.numpy()),
                                  jnp.asarray(Y.numpy()),
                                  jnp.asarray(w.numpy()), interpret=True)
    rel_R, rel_P, _ = stats_errors(R, P, torch.from_numpy(np.array(R_j)),
                                   torch.from_numpy(np.array(P_j)))
    assert rel_R <= 1e-5 and rel_P <= 1e-5, (rel_R, rel_P)


def jax_real_form_statistics(Y, w):
    """The JAX package's default WPE statistics (``stats_backend='auto'``:
    the real-form tap-group staircase) of the same inputs."""
    Yj = jnp.asarray(Y.numpy())
    Yr, Yi = jnp.real(Yj), jnp.imag(Yj)
    groups = jax_wpe_module._tap_groups(TAPS, Y.shape[1])
    U = [jax_wpe_module._build_strip(Yr, g, DELAY) for g in groups]
    V = [jax_wpe_module._build_strip(Yi, g, DELAY) for g in groups]
    R, P = jax_wpe_module._real_form_stats(
        U, V, Yr, Yi, jnp.asarray(w.numpy()),
        jax_wpe_module._PRECISIONS['highest'])
    return np.asarray(R), np.asarray(P)


def test_default_route_matches_jax_default_statistics(scene):
    Y, Y_tilde, w = scene
    R, P = wpe_stats.wpe_statistics_reference(Y_tilde, Y, w)
    R_j, P_j = jax_real_form_statistics(Y, w)
    for got, want in ((R, R_j), (P, P_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max())
