"""The chain's options in the port — WPE ``psd_context``, ``chunk_size``
and ``solve_refine``, the EM inverses 'cholesky', 'schur' and 'eigh', the
beamformers GEV (+BAN), LCMV (+BAN), 'ch2' and 'sum' — each through the
whole chain against the JAX chain (its fused-kernel EM in interpret
mode) on the two-speaker scene of ``tests/test_gss_pipeline.py``, and
their acceptance by ``GssConfig`` and ``get_enhancer``.

Tolerance, as ``tests/test_torch_gss.py``: waveforms within 1e-2 of the
peak, masks within 1e-2 in the mean and off by more than 0.1 on under 2%
of the entries.  Every option runs at a 3-iteration EM against the JAX
float32 chain; GEV and LCMV also at the 10 iterations of
``tests/test_gss_pipeline.py`` against the JAX float64 chain.  At 10
iterations the JAX float32 LCMV is rounding noise where the noise class
is near empty (its float32 and float64 chains differ by more than the
peak), which is why the port beamforms GEV and LCMV in float64
(``models/gss.py::_beamform``; measured by
``scripts_dev/diag_torch_scene_precision.py``).  The beamformer and
inverse cases run without WPE, as ``tests/test_gss_pipeline.py`` runs GEV
and LCMV, so the comparison isolates them: WPE's float32 rounding,
amplified by the EM and GEV, reaches 1e-2 of the peak on GEV (with WPE in
float64 it does not).  'schur' runs with WPE: without it, on this scene,
the float32 Schur recursion loses positive definiteness on the
rank-deficient class covariances (as the JAX ``_invert`` documents) and
the EM wanders in both packages — the JAX chain's own 'schur' and
'gauss_jordan' waveforms differ by 3.9e-2 of the peak there, the port's
by 1.0e-1; with WPE, port and JAX agree to 1.8e-3 (measured).  The
separating beamformers keep the JAX tests' SIR bounds: > 30x for GEV and
MVDR, > 10x for LCMV.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.models import GssConfig as JaxGssConfig
from pb_chime5_tpu.models import gss_enhance as jax_gss_enhance
from pb_chime5_tpu_torch.models.enhancer import get_enhancer
from pb_chime5_tpu_torch.models.gss import GssConfig, gss_enhance

from tests.test_gss_pipeline import activity_to_freq, make_scene, \
    sir_improvement

torch.set_num_threads(2)

NO_WPE = dict(wpe=False)
OPTIONS = {
    'gev_ban': dict(NO_WPE, bf='gev_ban'),
    'gev': dict(NO_WPE, bf='gev'),
    'lcmv': dict(NO_WPE, bf='lcmv'),
    'lcmv_ban': dict(NO_WPE, bf='lcmv_ban'),
    'ch2': dict(NO_WPE, bf='ch2'),
    'sum': dict(NO_WPE, bf='sum'),
    'wpe_options': dict(wpe_psd_context=1, wpe_chunk_size=64,
                        wpe_solve_refine=1),
    'cholesky': dict(NO_WPE, bss_inverse='cholesky'),
    'schur': dict(bss_inverse='schur'),
    'eigh': dict(NO_WPE, bss_inverse='eigh'),
}
SIR_BOUND = {'gev_ban': 30, 'gev': 30, 'lcmv': 10, 'lcmv_ban': 10,
             'wpe_options': 30, 'cholesky': 30, 'schur': 30, 'eigh': 30}


@pytest.fixture(scope='module')
def scene():
    return make_scene(np.random.default_rng(0))


@pytest.mark.parametrize('name', sorted(OPTIONS))
def test_option_chain_matches_jax(scene, name):
    check_chain(scene, name, JaxGssConfig(
        bss_iterations=3, bss_em_backend='pallas', **OPTIONS[name]))


@pytest.mark.parametrize('name', ['gev', 'gev_ban', 'lcmv', 'lcmv_ban'])
def test_beamformer_chain_matches_jax_float64_at_10_iterations(scene, name):
    check_chain(scene, name, JaxGssConfig(bss_iterations=10, **OPTIONS[name]),
                jax_dtype=np.float64)


def check_chain(scene, name, jax_config, jax_dtype=np.float32):
    """The port's chain (float32 input) against the JAX chain run on the
    input as ``jax_dtype``."""
    obs, activity, (b0, b1) = scene
    cfg = GssConfig.from_dict(dataclasses.asdict(jax_config))
    act_f = activity_to_freq(activity, jax_config)
    x, masks = gss_enhance(torch.from_numpy(obs), torch.from_numpy(act_f),
                           0, config=cfg, start_context_frames=3,
                           end_context_frames=2)
    xj, masks_j = jax_gss_enhance(
        jnp.asarray(obs.astype(jax_dtype)),
        jnp.asarray(act_f, dtype=jnp.int8), jnp.int32(0),
        config=jax_config, start_context_frames=jnp.int32(3),
        end_context_frames=jnp.int32(2))
    x, xj = x.numpy(), np.asarray(xj)
    assert x.shape == xj.shape == (obs.shape[1],)
    assert np.isfinite(x).all()
    np.testing.assert_allclose(x, xj, atol=1e-2 * np.abs(xj).max())
    diff = np.abs(masks.numpy() - np.asarray(masks_j))
    assert diff.mean() < 1e-2 and (diff > 0.1).mean() < 0.02
    if name in SIR_BOUND:
        assert sir_improvement(obs, x, b0, b1, obs.shape[1]) \
            > SIR_BOUND[name]


@pytest.mark.parametrize('name', sorted(OPTIONS))
def test_config_accepts_the_option(name):
    cfg = GssConfig(**OPTIONS[name])
    assert GssConfig.from_dict(dataclasses.asdict(cfg)) == cfg
    assert cfg.cacgmm_config.inverse == cfg.bss_inverse


@pytest.mark.parametrize('field,value', [
    ('wpe_psd_context', -1), ('wpe_chunk_size', 0), ('wpe_solve_refine', -1),
])
def test_config_rejects_impossible_counts(field, value):
    with pytest.raises(ValueError):
        GssConfig(**{field: value})


def test_get_enhancer_takes_the_options_and_lcmv_needs_a_garbage_class():
    enh = get_enhancer(bf='gev_ban', wpe_psd_context=2, device='cpu')
    assert (enh.gss_config.bf, enh.gss_config.wpe_psd_context) == \
        ('gev_ban', 2)
    assert get_enhancer(bf='lcmv', device='cpu').gss_config.bf == 'lcmv'
    for bf in ('lcmv', 'lcmv_ban'):
        with pytest.raises(AssertionError):
            get_enhancer(bf=bf, activity_garbage_class=False, device='cpu')
