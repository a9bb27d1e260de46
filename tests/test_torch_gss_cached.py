"""The port's cached dispatch (``_slice_cached_obs``, ``gss_enhance_cached``,
``GssPipeline.dispatch_cached``) on the CPU: the observation sliced out of
an int16 session window at per-array offsets equals JAX's slice and
leaves the window as it was; the chain on it is bit-equal to the port's
``gss_enhance`` on the equivalent zero-padded observation and within
1e-2 of the peak of JAX's ``gss_enhance_cached`` (the tolerance and the
reason of tests/test_torch_gss.py); the cached dispatch with a device
trim is bit-equal to the direct one (the twin of
tests/test_device_trim.py::test_dispatch_cached_trim_bitwise).

The scene is tests/test_gss_pipeline.py's (D = 4 as 2 arrays of 2
channels, 3 s) at a 256 / 64 STFT, which keeps the JAX interpret run of
the fused E+M kernel short.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig
from pb_chime5_tpu.models.gss import _slice_cached_obs as jax_slice
from pb_chime5_tpu.models.gss import (
    gss_enhance_cached as jax_gss_enhance_cached)
from pb_chime5_tpu_torch.models.gss import (
    GssConfig, GssPipeline, _slice_cached_obs, gss_enhance,
    gss_enhance_cached)

from tests.test_gss_pipeline import activity_to_freq, make_scene

torch.set_num_threads(2)

JAX_CONFIG = JaxGssConfig(stft_size=256, stft_shift=64, bss_iterations=3,
                          bss_em_backend='pallas')
CONFIG = GssConfig.from_dict(dataclasses.asdict(JAX_CONFIG))
A, C = 2, 2
N_PAD = 52000
OFFSETS = np.array([640, 1313], np.int32)   # per-array clock drift
W = 56000


@pytest.fixture(scope='module')
def scene():
    """(int16 PCM (4, N), activity (K, T), window (4, W) with the PCM at
    each array's offset and random samples everywhere else)."""
    rng = np.random.default_rng(0)
    obs, activity, _ = make_scene(rng)
    pcm = np.clip(obs / np.abs(obs).max() * 2 ** 14, -2 ** 15,
                  2 ** 15 - 1).astype(np.int16)
    N = pcm.shape[1]
    window = rng.integers(-2 ** 15, 2 ** 15, (A * C, W)).astype(np.int16)
    for a, off in enumerate(OFFSETS):
        window[a * C:(a + 1) * C, off:off + N] = pcm[a * C:(a + 1) * C]
    return pcm, activity_to_freq(activity, JAX_CONFIG), window


def bucket_activity(act_f):
    """(K, T) -> int8 (K, T) of the N_PAD-sample bucket."""
    T_pad = GssPipeline(CONFIG, device='cpu').frame_count(N_PAD)
    return np.pad(act_f, ((0, 0), (0, T_pad - act_f.shape[1]))).astype(
        np.int8)


def padded(pcm):
    out = np.zeros((pcm.shape[0], N_PAD), pcm.dtype)
    out[:, :pcm.shape[1]] = pcm
    return out


def test_slice_matches_jax_and_leaves_the_window(scene):
    pcm, _, window = scene
    N = pcm.shape[1]
    cache = torch.from_numpy(window.copy())
    obs = _slice_cached_obs(cache, OFFSETS, A, N_PAD, N)
    want = np.asarray(jax_slice(jnp.asarray(window), jnp.asarray(OFFSETS),
                                A, N_PAD, jnp.int32(N)))
    assert obs.dtype == torch.int16 and obs.is_contiguous()
    np.testing.assert_array_equal(obs.numpy(), want)
    np.testing.assert_array_equal(obs.numpy(), padded(pcm))
    np.testing.assert_array_equal(cache.numpy(), window)
    assert obs.untyped_storage().data_ptr() != \
        cache.untyped_storage().data_ptr()


def test_gss_enhance_cached_is_gss_enhance_on_the_padded_input(scene):
    pcm, act_f, window = scene
    N = pcm.shape[1]
    act = torch.from_numpy(bucket_activity(act_f))
    kw = dict(config=CONFIG, start_context_frames=3, end_context_frames=2,
              num_valid_samples=N, num_output_samples=N_PAD,
              output_trim_start=4000, output_trim_samples=32000)
    x, masks = gss_enhance_cached(torch.from_numpy(window), OFFSETS, act, 0,
                                  num_arrays=A, slice_samples=N_PAD, **kw)
    x_d, masks_d = gss_enhance(torch.from_numpy(padded(pcm)), act, 0, **kw)
    assert x.shape == (32000,)
    torch.testing.assert_close(x, x_d, rtol=0, atol=0)
    torch.testing.assert_close(masks, masks_d, rtol=0, atol=0)


def test_gss_enhance_cached_matches_jax(scene):
    pcm, act_f, window = scene
    N = pcm.shape[1]
    act = bucket_activity(act_f)
    x, _ = gss_enhance_cached(
        torch.from_numpy(window), OFFSETS, torch.from_numpy(act), 0,
        config=CONFIG, num_arrays=A, slice_samples=N_PAD,
        start_context_frames=3, end_context_frames=2, num_valid_samples=N,
        num_output_samples=N_PAD)
    xj, _ = jax_gss_enhance_cached(
        jnp.asarray(window), jnp.asarray(OFFSETS), jnp.asarray(act),
        jnp.int32(0), config=JAX_CONFIG, num_arrays=A, slice_samples=N_PAD,
        start_context_frames=jnp.int32(3), end_context_frames=jnp.int32(2),
        num_valid_samples=jnp.int32(N), num_output_samples=N_PAD)
    x, xj = x.numpy(), np.asarray(xj)
    assert x.shape == xj.shape == (N_PAD,)
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    np.testing.assert_allclose(x, xj, atol=1e-2 * np.abs(xj).max())


def test_dispatch_cached_trim_bitwise(scene):
    """Device trim through the cached dispatch == the direct dispatch, bit
    for bit, including the zeroing of the window's samples past the
    valid length."""
    pcm, act_f, window = scene
    pipe = GssPipeline(CONFIG, length_buckets=(N_PAD,), device='cpu')
    trim = (1500, 25000)
    kw = dict(start_context_frames=2, end_context_frames=2, trim=trim)
    cached = pipe.gather(pipe.dispatch_cached(
        torch.from_numpy(window), OFFSETS, pcm.shape[1], act_f, 1, **kw))
    direct = pipe.gather(pipe.dispatch(pcm, act_f, 1, **kw))
    assert cached.shape == (trim[1],)
    np.testing.assert_array_equal(cached, direct)
    with pytest.raises(ValueError):
        pipe.dispatch_cached(torch.from_numpy(window), OFFSETS + 4000,
                             pcm.shape[1], act_f, 1)
