"""Port GSS chain vs the JAX package on the synthetic two-speaker scene of
``tests/test_gss_pipeline.py`` (D = 4, 3 s, WPE on, 3 EM iterations,
the JAX fused-kernel EM in interpret mode), through both pipelines'
bucket padding and device trim.

Tolerance: waveforms within 1e-2 of the peak of the enhanced signal;
masks within 1e-2 in the mean and off by more than 0.1 on under 2% of
the (class, frame, bin) entries.  In complex128 the two chains agree to
5e-12 (tests/test_torch_wpe.py holds WPE there); in float32 they differ
in summation order only, but the EM amplifies input rounding (a few
bins flip their posteriors).  Measured on this scene: port vs JAX
1.8e-3 of the peak, while the JAX package's own two WPE statistics
backends ('real' vs 'xla') differ by 2.3e-3; masks 1.5e-3 mean, 0.26%
of entries off by more than 0.1.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.models import GssConfig as JaxGssConfig
from pb_chime5_tpu.models import GssPipeline as JaxGssPipeline
from pb_chime5_tpu.models import gss_enhance as jax_gss_enhance
from pb_chime5_tpu_torch.models.gss import (
    GssConfig, GssPipeline, gss_enhance)

from tests.test_gss_pipeline import activity_to_freq, make_scene, \
    sir_improvement

torch.set_num_threads(2)

JAX_CONFIG = JaxGssConfig(bss_iterations=3, bss_em_backend='pallas')
# the all-Pallas configuration (the three kernels of the JAX package),
# at a 256 / 64 STFT: F = 129 keeps the JAX interpret run of the
# statistics kernel short (~10 s against ~26 s at 1024 / 256)
JAX_ALL_PALLAS = JaxGssConfig(
    stft_size=256, stft_shift=64, bss_iterations=3, bss_em_backend='pallas',
    bss_inverse='pallas_gj', wpe_stats_backend='pallas')


@pytest.fixture(scope='module')
def scene():
    rng = np.random.default_rng(0)
    obs, activity, bounds = make_scene(rng)
    return obs, activity_to_freq(activity, JAX_CONFIG), bounds


@pytest.mark.parametrize('jax_config', [JAX_CONFIG, JAX_ALL_PALLAS],
                         ids=['fused_em', 'all_pallas'])
def test_config_carries_over_from_jax(jax_config):
    cfg = GssConfig.from_dict(dataclasses.asdict(jax_config))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_config)
    assert GssConfig.from_dict(dataclasses.asdict(JaxGssConfig())) == \
        GssConfig()
    with pytest.raises(ValueError):
        GssConfig.from_dict({'no_such_field': 1})


@pytest.mark.parametrize('field,value', [
    ('wpe_stats_backend', 'real'), ('wpe_precision', 'high'),
    ('compile_mode', 'fast_start'), ('bss_em_backend', 'xla'),
    ('bss_inverse', 'lu'), ('bf', 'mvdr'), ('wpe_precision', 'default'),
    ('wpe_stats_backend', 'x'), ('bss_em_backend', 'x'), ('postfilter', 'x'),
])
def test_config_rejects_unported_choices(field, value):
    """Every choice raises but ``bss_em_backend='xla'``, the per-frequency
    EM, and ``compile_mode='fast_start'``, the one eager chain, which the
    port runs: those cases assert the config is accepted."""
    if (field, value) == ('bss_em_backend', 'xla'):
        cfg = GssConfig(**{field: value})
        assert cfg.cacgmm_config.em_backend == 'xla'
        return
    if (field, value) == ('compile_mode', 'fast_start'):
        assert GssConfig(**{field: value}).compile_mode == 'fast_start'
        return
    with pytest.raises(NotImplementedError):
        GssConfig(**{field: value})


def test_gss_enhance_matches_jax(scene):
    obs, act_f, (b0, b1) = scene
    cfg = GssConfig.from_dict(dataclasses.asdict(JAX_CONFIG))
    x, masks = gss_enhance(torch.from_numpy(obs), torch.from_numpy(act_f),
                           0, config=cfg, start_context_frames=3,
                           end_context_frames=2)
    xj, masks_j = jax_gss_enhance(
        jnp.asarray(obs), jnp.asarray(act_f, dtype=jnp.int8), jnp.int32(0),
        config=JAX_CONFIG, start_context_frames=jnp.int32(3),
        end_context_frames=jnp.int32(2))
    x, xj = x.numpy(), np.asarray(xj)
    assert x.shape == xj.shape == (obs.shape[1],)
    assert masks.shape == masks_j.shape
    np.testing.assert_allclose(x, xj, atol=1e-2 * np.abs(xj).max())
    diff = np.abs(masks.numpy() - np.asarray(masks_j))
    assert diff.mean() < 1e-2 and (diff > 0.1).mean() < 0.02
    assert sir_improvement(obs, x, b0, b1, obs.shape[1]) > 30


def test_all_pallas_gss_enhance_matches_jax():
    """The all-Pallas chain (statistics, fused E+M and Gauss-Jordan
    kernels; their plain versions here) against the JAX all-Pallas chain
    (its three Pallas kernels in interpret mode), same tolerances.
    Measured: 3.3e-4 of the peak, masks 1e-4 mean."""
    rng = np.random.default_rng(0)
    obs, activity, (b0, b1) = make_scene(rng)
    act_f = activity_to_freq(activity, JAX_ALL_PALLAS)
    cfg = GssConfig.from_dict(dataclasses.asdict(JAX_ALL_PALLAS))
    x, masks = gss_enhance(torch.from_numpy(obs), torch.from_numpy(act_f),
                           0, config=cfg, start_context_frames=3,
                           end_context_frames=2)
    xj, masks_j = jax_gss_enhance(
        jnp.asarray(obs), jnp.asarray(act_f, dtype=jnp.int8), jnp.int32(0),
        config=JAX_ALL_PALLAS, start_context_frames=jnp.int32(3),
        end_context_frames=jnp.int32(2))
    x, xj = x.numpy(), np.asarray(xj)
    assert x.shape == xj.shape == (obs.shape[1],)
    assert masks.shape == masks_j.shape == (3, act_f.shape[1], 129)
    np.testing.assert_allclose(x, xj, atol=1e-2 * np.abs(xj).max())
    diff = np.abs(masks.numpy() - np.asarray(masks_j))
    assert diff.mean() < 1e-2 and (diff > 0.1).mean() < 0.02
    assert sir_improvement(obs, x, b0, b1, obs.shape[1]) > 30


def test_pipeline_bucket_padding_and_device_trim(scene):
    """int16 PCM through both pipelines with a length bucket and an
    output trim: the port's in-graph trim equals its host slice, and
    both match the JAX pipeline."""
    obs, act_f, _ = scene
    pcm = np.clip(obs / np.abs(obs).max() * 2 ** 14, -2 ** 15,
                  2 ** 15 - 1).astype(np.int16)
    trim = (4000, 30000)
    kw = dict(start_context_frames=5, end_context_frames=4, trim=trim)
    cfg = GssConfig.from_dict(dataclasses.asdict(JAX_CONFIG))
    outs = {}
    for device_trim in (True, False):
        pipe = GssPipeline(cfg, length_buckets=(64000,),
                           device_trim=device_trim, device='cpu')
        assert pipe._plan_trim(trim, pcm.shape[1], 64000)[2] == (
            {'output_trim_start': 4000, 'output_trim_samples': 32000}
            if device_trim else {})
        outs[device_trim] = pipe.gather(pipe.dispatch(pcm, act_f, 1, **kw))
    np.testing.assert_array_equal(outs[True], outs[False])
    jpipe = JaxGssPipeline(JAX_CONFIG, length_buckets=(64000,))
    want = jpipe.gather(jpipe.dispatch(pcm, act_f, 1, **kw))
    assert outs[True].shape == want.shape == (trim[1],)
    np.testing.assert_allclose(outs[True], want,
                               atol=1e-2 * np.abs(want).max())
