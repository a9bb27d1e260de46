"""The port's float64 chain and its debug twin on the CPU, against the JAX
package's float64 chain (``GssPipeline(dtype=np.float64)``, JAX's
``'auto'`` EM off the TPU being the same per-frequency EM) and against the
float64 NumPy oracle of ``tests/test_full_chain_parity.py``:

* the chain through ``GssPipeline(dtype=np.float64)`` (int16 PCM scaled on
  the host, WPE with its floored complex128 solve, the per-frequency EM at
  20 + 1, MVDR + BAN) within 1e-6 of the peak of JAX's (the same float64
  operations in other orders; measured ~1e-12), masks within 1e-7 (the
  EM amplifies the chain's float64 rounding: measured up to 1.4e-8 on the
  corpus utterance);
* the chain against the oracle at 5e-5 of the peak, the JAX test's
  tolerance (reference-exact LU solve, 'eigh' conditioning);
* ``_normalize_obs`` equal to JAX's for int16, int32 and float input in
  both compute dtypes;
* the session-audio cache in float64: a float64 window (8 bytes a
  sample), WAVs byte-identical to the direct path's;
* the CLI ``run.py test_run compute_dtype=float64`` against the JAX CLI
  with the same keys: WAVs (peak-normalized int16) within one LSB;
* ``gss_enhance_debug``, ``GssPipeline.debug`` and ``Enhancer.debug_example``
  against JAX's: waveforms within 1e-6 of the peak, masks within 1e-7,
  the four statistics within 1e-7 or 1e-8 relative (the condition proxy
  reaches ~1e3 where the EM has amplified the chain's float64 rounding to
  ~2e-10 relative);
* ``Enhancer.stft`` / ``istft`` against JAX's within 1e-12;
* the complex128 WPE solve (``ops/wpe.py::_solve_G``) against JAX's on
  statistics with a zero channel, an all-zero frequency and a frequency
  where the pivot floor binds (``linalg.hermitian_solve``'s Cholesky
  raises there): no raise, within 1e-9 of each frequency's largest entry
  (the library's Cholesky against JAX's panels on systems of condition
  up to ~4e5: ~1e-10; where the floor binds both run the panels, 0).
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.database.create_json import create_database
from pb_chime5_tpu.io import dump_json, load_audio
from pb_chime5_tpu.models import enhancer as jax_enhancer
from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig
from pb_chime5_tpu.models.gss import GssPipeline as JaxGssPipeline
from pb_chime5_tpu.models.gss import gss_enhance_debug as jax_enhance_debug
from pb_chime5_tpu.scripts import run as jax_run
from pb_chime5_tpu.testing import create_synthetic_chime5
from pb_chime5_tpu.utils import activity_time_to_frequency
from pb_chime5_tpu_torch.models import enhancer as port_enhancer
from pb_chime5_tpu_torch.models.gss import (
    GssConfig, GssPipeline, gss_enhance, gss_enhance_debug)
from pb_chime5_tpu_torch.ops import linalg, wpe
from pb_chime5_tpu_torch.ops.kernels.wpe_stats import (
    wpe_statistics_reference)
from pb_chime5_tpu_torch.scripts import run

from tests.test_full_chain_parity import numpy_pipeline
from tests.test_gss_pipeline import activity_to_freq, make_scene

# the module: ``pb_chime5_tpu.ops.wpe`` is also the name of its function
jax_wpe = importlib.import_module('pb_chime5_tpu.ops.wpe')

torch.set_num_threads(2)

JAX_CONFIG = JaxGssConfig(stft_size=256, stft_shift=64)
CONFIG = GssConfig.from_dict(dataclasses.asdict(JAX_CONFIG))
N_PAD = 52000
WAVE_RTOL = 1e-6      # of the peak
MASK_ATOL = 1e-7
STATS_RTOL = 1e-8
SETTINGS = dict(context_samples=8000, bss_iterations=3,
                length_buckets=(16000 * 4,))


@pytest.fixture(scope='module')
def scene():
    """(int16 PCM (4, N), activity (K, T)): tests/test_gss_pipeline.py's
    3 s scene."""
    obs, activity, _ = make_scene(np.random.default_rng(0))
    pcm = np.clip(obs / np.abs(obs).max() * 2 ** 14, -2 ** 15,
                  2 ** 15 - 1).astype(np.int16)
    return pcm, activity_to_freq(activity, JAX_CONFIG)


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('chime5_float64')
    create_synthetic_chime5(
        root, session_ids=('S02',), duration_seconds=16.0,
        utterances_per_speaker=1, num_arrays=2, seed=11, pcm16=True)
    dump_json(create_database(root), root / 'chime5.json')
    return root / 'chime5.json'


def peak_error(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_float64_pipeline_matches_jax(scene):
    pcm, act = scene
    kw = dict(start_context_frames=4, end_context_frames=3)
    x, masks = GssPipeline(CONFIG, length_buckets=(N_PAD,),
                           dtype=np.float64, device='cpu')(
        pcm, act, 1, return_masks=True, **kw)
    xj, masks_j = JaxGssPipeline(JAX_CONFIG, length_buckets=(N_PAD,),
                                 dtype=np.float64)(
        pcm, act, 1, return_masks=True, **kw)
    xj, masks_j = np.asarray(xj), np.asarray(masks_j)
    assert x.dtype == masks.dtype == np.float64
    assert x.shape == xj.shape == (pcm.shape[1],)
    assert peak_error(x, xj) <= WAVE_RTOL, peak_error(x, xj)
    np.testing.assert_allclose(masks, masks_j, atol=MASK_ATOL, rtol=0)


def test_float64_chain_matches_numpy_oracle():
    """tests/test_full_chain_parity.py through the port's ``gss_enhance``."""
    size, shift = 512, 128
    obs, activity, _ = make_scene(np.random.default_rng(0), seconds=1.0,
                                  D=4)
    obs = obs.astype(np.float64)
    want = numpy_pipeline(obs, activity, size=size, shift=shift, taps=4,
                          delay=2, wpe_iterations=2, bss_iterations=6,
                          bss_iterations_post=1)
    config = GssConfig(stft_size=size, stft_shift=shift, wpe_taps=4,
                       wpe_delay=2, wpe_iterations=2, wpe_regularization=0.0,
                       bss_iterations=6, bss_iterations_post=1,
                       bss_inverse='eigh')
    act_f = activity_time_to_frequency(activity, size, shift,
                                       stft_fading=True, stft_pad=True)
    x, _ = gss_enhance(torch.from_numpy(obs),
                       torch.from_numpy(act_f.astype(np.int8)), 0,
                       config=config)
    got = x.numpy()
    n = min(len(got), len(want))
    scale = np.abs(want[:n]).max()
    np.testing.assert_allclose(got[:n] / scale, want[:n] / scale, atol=5e-5)


@pytest.mark.parametrize('dtype', [np.float32, np.float64, 'float64'])
@pytest.mark.parametrize('kind', ['int16', 'int32', 'float32', 'float64',
                                  '1d'])
def test_normalize_obs_matches_jax(dtype, kind):
    rng = np.random.default_rng(4)
    x = {'int16': rng.integers(-2 ** 15, 2 ** 15, (3, 50)).astype(np.int16),
         'int32': rng.integers(-2 ** 31, 2 ** 31, (3, 50)).astype(np.int32),
         'float32': rng.standard_normal((3, 50)).astype(np.float32),
         'float64': rng.standard_normal((3, 50)),
         '1d': rng.standard_normal(50)}[kind]
    got = GssPipeline(CONFIG, dtype=dtype, device='cpu')._normalize_obs(x)
    want = JaxGssPipeline(JAX_CONFIG, dtype=dtype)._normalize_obs(x)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if kind == 'int16':
        assert got.dtype == (np.int16 if np.dtype(dtype) == np.float32
                             else np.float64)


def test_float64_cache_equals_direct(corpus, tmp_path, capsys):
    """The session in float64 with the session-audio cache: its window
    follows the compute dtype through the pipeline's ``_normalize_obs``
    (8 bytes a sample), and its WAVs are byte-identical to the direct
    path's."""
    kw = dict(database_path=str(corpus), multiarray=True, device='cpu',
              compute_dtype=np.float64, **SETTINGS)
    off = port_enhancer.get_enhancer(device_audio_cache=False, **kw)
    off.enhance_session(['S02'], tmp_path / 'off', audio_dir_exist_ok=True)
    on = port_enhancer.get_enhancer(cache_window_seconds=20.0, **kw)
    on.enhance_session(['S02'], tmp_path / 'on', audio_dir_exist_ok=True)
    stats = on._audio_cache.stats
    assert stats['hits'] > 0 and stats['direct'] == 0, stats
    channels = 8                                   # 2 arrays x 4 mics
    assert stats['refill_mb'] == round(
        stats['refills'] * channels * 20 * 16000 * 8 / 1e6, 3), stats
    assert on._audio_cache._buf.dtype == torch.float64
    wavs = sorted((tmp_path / 'off' / 'dev').glob('*.wav'))
    assert len(wavs) >= 2
    for a in wavs:
        assert a.read_bytes() == (tmp_path / 'on' / 'dev' / a.name) \
            .read_bytes(), a.name


def test_cli_float64_matches_jax_cli(corpus, tmp_path):
    """``run.py test_run ... compute_dtype=float64`` against the JAX CLI
    with the same keys; the value reaches the factory as a NumPy dtype."""
    argv = ['test_run', 'with', 'multiarray', 'session_id=S02',
            f'database_path={corpus}', 'compute_dtype=float64',
            *(f'{k}={v!r}' for k, v in SETTINGS.items())]
    made = []
    factory = port_enhancer.get_enhancer

    @functools.wraps(factory)          # the CLI reads its signature
    def recording_factory(**kw):
        made.append(kw['compute_dtype'])
        return factory(**kw)
    exp = run.make_experiment(recording_factory,
                              default_storage=tmp_path / 'port')
    exp.run_commandline(argv + ['device=cpu'])
    assert made == [np.dtype(np.float64)]
    jexp = jax_run.make_experiment(default_storage=tmp_path / 'jax')
    jexp.run_commandline(argv)
    wavs = sorted((exp.run_dir / 'audio' / 'dev').glob('*.wav'))
    assert len(wavs) == 2
    for wav in wavs:
        got = load_audio(wav)
        want = load_audio(jexp.run_dir / 'audio' / 'dev' / wav.name)
        assert got.shape == want.shape and np.abs(got).max() > 0
        assert np.abs(got - want).max() <= 2.0 ** -15


def _debug_config(**kw):
    return dataclasses.replace(JAX_CONFIG, bss_iterations=6,
                               bss_iterations_post=2, **kw)


def _check_debug(got, want):
    """(x_hat, masks, stats) of the port against JAX's."""
    x, masks, stats = got
    xj, masks_j, stats_j = want
    assert peak_error(np.asarray(x), np.asarray(xj)) <= WAVE_RTOL
    np.testing.assert_allclose(np.asarray(masks), np.asarray(masks_j),
                               atol=MASK_ATOL, rtol=0)
    assert sorted(stats) == sorted(stats_j)
    for key in stats:
        np.testing.assert_allclose(np.asarray(stats[key]),
                                   np.asarray(stats_j[key]),
                                   atol=MASK_ATOL, rtol=STATS_RTOL)


@pytest.mark.parametrize('em_backend', ['auto', 'pallas'])
def test_gss_enhance_debug_matches_jax(scene, em_backend):
    """The debug twin runs the unfused EM whatever the backend (JAX's at
    its default: the twin ignores it too)."""
    pcm, act = scene
    obs = pcm.astype(np.float64) * 2.0 ** -15
    jcfg = _debug_config()
    cfg = GssConfig.from_dict(dataclasses.asdict(
        _debug_config(bss_em_backend=em_backend)))
    got = gss_enhance_debug(torch.from_numpy(obs), torch.from_numpy(act), 1,
                            config=cfg, start_context_frames=4,
                            end_context_frames=3)
    want = jax_enhance_debug(jnp.asarray(obs), jnp.asarray(act),
                             jnp.int32(1), config=jcfg,
                             start_context_frames=jnp.int32(4),
                             end_context_frames=jnp.int32(3))
    assert got[2]['weights'].shape == (1 + 5 + 1, 129, act.shape[0])
    _check_debug((got[0].numpy(), got[1].numpy(), got[2]), want)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_pipeline_debug_matches_jax(scene, dtype):
    """:meth:`GssPipeline.debug` with dispatch's bucketing and padding;
    in float32 the port's int16 upload against JAX's (waveform within
    1e-2 of the peak, the float32 tolerance of tests/test_torch_gss.py)."""
    pcm, act = scene
    jcfg = _debug_config()
    cfg = GssConfig.from_dict(dataclasses.asdict(jcfg))
    got = GssPipeline(cfg, length_buckets=(N_PAD,), dtype=dtype,
                      device='cpu').debug(pcm, act, 0,
                                          start_context_frames=2)
    want = JaxGssPipeline(jcfg, length_buckets=(N_PAD,), dtype=dtype).debug(
        pcm, act, 0, start_context_frames=2)
    assert got[0].shape == want[0].shape == (pcm.shape[1],)
    assert got[0].dtype == dtype
    if dtype == np.float64:
        _check_debug(got, want)
    else:
        assert peak_error(got[0], want[0]) <= 1e-2
        assert {k: v.shape for k, v in got[2].items()} == \
            {k: v.shape for k, v in want[2].items()}


def test_debug_example_matches_jax(corpus):
    kw = dict(database_path=str(corpus), multiarray=True,
              compute_dtype=np.float64, **SETTINGS)
    port = port_enhancer.get_enhancer(device='cpu', **kw)
    jax_ = jax_enhancer.get_enhancer(**kw)
    ex = list(port.get_iterator('S02'))[0]
    got = port.debug_example(ex)
    want = jax_.debug_example(jax_.get_iterator('S02')[ex['example_id']])
    assert sorted(got) == sorted(want) == [
        'condition', 'logdet', 'masks', 'posterior_entropy', 'weights',
        'x_hat']
    assert got['x_hat'].shape == want['x_hat'].shape == (
        ex['num_samples_orig']['observation'][ex['reference_array']],)
    assert got['weights'].shape[0] == SETTINGS['bss_iterations']
    _check_debug((got['x_hat'], got['masks'],
                  {k: got[k] for k in ('weights', 'logdet', 'condition',
                                       'posterior_entropy')}),
                 (want['x_hat'], want['masks'],
                  {k: want[k] for k in ('weights', 'logdet', 'condition',
                                        'posterior_entropy')}))
    # the twin's waveform is enhance_example's (the same chain and EM)
    np.testing.assert_allclose(got['x_hat'], port.enhance_example(ex),
                               atol=1e-12)


def test_enhancer_stft_istft_match_jax(corpus):
    port = port_enhancer.get_enhancer(database_path=str(corpus),
                                      device='cpu')
    jax_ = jax_enhancer.get_enhancer(database_path=str(corpus))
    x = np.random.default_rng(9).standard_normal((2, 8000))
    X = port.stft(x)
    np.testing.assert_allclose(X, jax_.stft(x), atol=1e-12, rtol=0)
    assert X.shape == (2, 35, 513) and X.dtype == np.complex128
    y = port.istft(X)
    np.testing.assert_allclose(y, jax_.istft(X), atol=1e-12, rtol=0)
    np.testing.assert_allclose(y[:, :8000], x, atol=1e-10)


def _wpe_statistics():
    """R (F, 40, 40), P (F, 40, 4) complex128 of a 4-channel signal with
    a zero channel and an all-zero frequency (taps 10, delay 2)."""
    rng = np.random.default_rng(0)
    Y = rng.standard_normal((4, 4, 200)) + 1j * rng.standard_normal(
        (4, 4, 200))
    Y[:, 2] = 0
    Y[3] = 0
    Y = torch.from_numpy(Y)
    R, P = wpe_statistics_reference(wpe.build_y_tilde(Y, 10, 2), Y,
                                    wpe.get_power_inverse(Y))
    return linalg.hermitize(R), P


@pytest.mark.parametrize('floor_binds', ['ones', 'negative_pivot'])
@pytest.mark.parametrize('load', [1e-4, 1e-300])
def test_complex128_wpe_solve_floors_as_jax(load, floor_binds):
    """Frequency 1 replaced by a system whose elimination reaches a zero
    (all-ones) or a negative (a rounding-negative diagonal entry) pivot:
    at the tiny load ``linalg.hermitian_solve``'s Cholesky raises there,
    the WPE solve floors the pivot at eps^2 max(diag) as JAX does."""
    R, P = _wpe_statistics()
    if floor_binds == 'ones':
        R[1] = torch.ones((40, 40), dtype=R.dtype)
    else:
        R[1] = torch.eye(40, dtype=R.dtype)
        R[1, 5, 5] = -1e-20
    if load == 1e-300:
        with pytest.raises(torch.linalg.LinAlgError):
            linalg.hermitian_solve(R, P, relative_load=load)
    got = wpe._solve_G(R, P, load).numpy()
    want = np.asarray(jax_wpe._solve_G(jnp.asarray(R.numpy()),
                                       jnp.asarray(P.numpy()), load,
                                       jnp.float64))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    # the all-zero frequency and the zero channel's rows solve to 0
    assert not got[3].any() and not got[[0, 2]][:, 2::4].any()
    for f in range(4):
        scale = max(np.abs(want[f]).max(), np.finfo(np.float64).tiny)
        assert np.abs(got[f] - want[f]).max() <= 1e-9 * scale, f
