"""The port's CLI end to end on the CPU: synthetic 2-array PCM16 corpus ->
DB JSON -> ``python -m pb_chime5_tpu_torch.scripts.run test_run`` ->
WAVs, held against the JAX ``Enhancer`` on the same corpus (its fused
kernel EM in interpret mode, uncached session audio); plus a
subprocess check that a port run (``gss_enhance`` and the CLI on a
corpus the port makes) imports neither JAX nor the JAX package.

Tolerance: the WAVs (peak-normalized int16 by ``dump_audio``) agree to
2e-2 of full scale.  Both chains run the same float32 math in another
summation order and 3 EM iterations amplify that rounding (see
tests/test_torch_gss.py); int16 quantization adds 3e-5.
"""

import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from pb_chime5_tpu.database.create_json import create_database
from pb_chime5_tpu.io import dump_json, load_audio
from pb_chime5_tpu.models.enhancer import Activity as JaxActivity
from pb_chime5_tpu.models.enhancer import Enhancer as JaxEnhancer
from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig
from pb_chime5_tpu.testing import create_synthetic_chime5
from pb_chime5_tpu_torch.models.enhancer import get_enhancer
from pb_chime5_tpu_torch.scripts.run import make_experiment

torch.set_num_threads(2)

SETTINGS = dict(context_samples=8000, bss_iterations=3,
                length_buckets=(16000 * 4,))


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('chime5_torch')
    create_synthetic_chime5(
        root, session_ids=('S02',), duration_seconds=16.0,
        utterances_per_speaker=1, num_arrays=2, seed=11, pcm16=True)
    json_path = root / 'chime5.json'
    dump_json(create_database(root), json_path)
    return json_path


def test_cli_test_run_matches_jax_enhancer(corpus, tmp_path):
    exp = make_experiment(default_storage=tmp_path / 'runs')
    exp.run_commandline([
        'test_run', 'with', 'multiarray', 'session_id=S02',
        f'database_path={corpus}', 'device=cpu',
        *(f'{k}={v!r}' for k, v in SETTINGS.items())])
    wavs = sorted((exp.run_dir / 'audio' / 'dev').glob('*.wav'))
    assert len(wavs) == 2, wavs
    import json
    assert json.loads((exp.run_dir / 'run.json').read_text())['status'] \
        == 'COMPLETED'

    jax_enhancer = JaxEnhancer(
        activity=JaxActivity(garbage_class=True, database_path=str(corpus)),
        gss_config=JaxGssConfig(bss_iterations=3, bss_em_backend='pallas'),
        context_samples=SETTINGS['context_samples'], multiarray=True,
        length_buckets=SETTINGS['length_buckets'],
        device_audio_cache=False)
    jax_enhancer.enhance_session(['S02'], tmp_path / 'jax',
                                 dataset_slice=True)
    it = jax_enhancer.get_iterator('S02')
    for wav in wavs:
        got = load_audio(wav)
        want = load_audio(tmp_path / 'jax' / 'dev' / wav.name)
        ex = it[wav.stem]
        assert got.shape == want.shape == (
            ex['num_samples_orig']['observation'][ex['reference_array']],)
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, atol=2e-2)


def test_enhancer_rejects_unported_session_cache(corpus):
    with pytest.raises(NotImplementedError):
        get_enhancer(database_path=str(corpus), device='cpu',
                     device_audio_cache=True)


def test_factory_keywords_match_jax():
    """The port's ``get_enhancer`` takes every keyword of the JAX one, in
    its order, and adds only ``device``; the CLI's config (derived from
    the signature) holds them all.  The keywords the port accepts unused
    keep the JAX defaults."""
    import inspect
    from pb_chime5_tpu.models.enhancer import get_enhancer as jax_factory
    port = inspect.signature(get_enhancer).parameters
    jax_ = inspect.signature(jax_factory).parameters
    assert list(port) == list(jax_) + ['device']
    for name in ('compute_dtype', 'cache_window_seconds', 'cache_prefetch'):
        assert port[name].default == jax_[name].default, name
    assert set(make_experiment().config) == set(port) | {'session_id'}


def test_factory_accepts_the_jax_keywords_at_their_defaults(corpus):
    enhancer = get_enhancer(database_path=str(corpus), device='cpu',
                            compute_dtype=np.float32,
                            cache_window_seconds=180.0, cache_prefetch=True)
    assert type(enhancer).__name__ == 'Enhancer'
    for dtype in (np.float64, 'float16'):
        with pytest.raises(NotImplementedError):
            get_enhancer(database_path=str(corpus), device='cpu',
                         compute_dtype=dtype)


def test_cuda_device_without_card_raises(corpus):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        get_enhancer(database_path=str(corpus), device='cuda')


def test_port_run_imports_no_jax():
    code = textwrap.dedent('''
        import sys
        import numpy as np
        import torch
        from pb_chime5_tpu_torch.models.gss import GssConfig, gss_enhance
        from pb_chime5_tpu_torch.models.enhancer import get_enhancer
        from pb_chime5_tpu_torch.scripts.run import make_experiment
        rng = np.random.default_rng(0)
        obs = torch.from_numpy(rng.standard_normal((3, 4000)).astype(
            np.float32))
        act = torch.ones((2, 66), dtype=torch.int8)
        x, masks = gss_enhance(obs, act, 0, config=GssConfig(
            stft_size=256, stft_shift=64, wpe_taps=2, bss_iterations=2))
        assert torch.isfinite(x).all() and masks.shape == (2, 66, 129)

        import tempfile
        from pathlib import Path
        from pb_chime5_tpu_torch.database.create_json import create_database
        from pb_chime5_tpu_torch.io import dump_json
        from pb_chime5_tpu_torch.testing import create_synthetic_chime5
        root = Path(tempfile.mkdtemp())
        create_synthetic_chime5(root, duration_seconds=12.0,
                                utterances_per_speaker=1, num_arrays=1)
        dump_json(create_database(root), root / 'db.json')
        exp = make_experiment(default_storage=root / 'runs')
        exp.run_commandline([
            'test_run', 'with', 'session_id=S02', 'device=cpu',
            f'database_path={root}/db.json', 'context_samples=4000',
            'bss_iterations=2', 'wpe_tabs=2', 'length_buckets=(48000,)'])
        assert len(list((exp.run_dir / 'audio' / 'dev').glob('*.wav'))) == 2
        loaded = sorted({m.split('.')[0] for m in sys.modules})
        assert 'jax' not in loaded and 'pb_chime5_tpu' not in loaded, loaded
        print('NO_JAX_OK')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'NO_JAX_OK' in proc.stdout
