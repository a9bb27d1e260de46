"""The port's CLI end to end on the CPU: synthetic 2-array PCM16 corpus ->
DB JSON -> ``python -m pb_chime5_tpu_torch.scripts.run test_run`` (the
default, cached session path) -> WAVs, held against the JAX ``Enhancer``
on the same corpus (its fused kernel EM in interpret mode, uncached
session audio); the session-audio cache against the direct path inside
the port (byte-identical WAVs) and the time-ordered dispatch against the
JAX enhancer's order; plus a subprocess check that a port run
(``gss_enhance``, and the CLIs ``run``, ``kaldi_run chime6=True`` and
``kaldi_run_rttm`` on a corpus the port makes) imports neither JAX nor the
JAX package.

Tolerance: the WAVs (peak-normalized int16 by ``dump_audio``) agree to
2e-2 of full scale.  Both chains run the same float32 math in another
summation order and 3 EM iterations amplify that rounding (see
tests/test_torch_gss.py); int16 quantization adds 3e-5.
"""

import ast
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
from pb_chime5_tpu.models.enhancer import get_enhancer as jax_get_enhancer
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


def cache_stats(out):
    """The dict of the last ``session-audio cache: {...}`` line."""
    lines = [line for line in out.splitlines()
             if line.startswith('session-audio cache: ')]
    assert lines, out
    return ast.literal_eval(lines[-1].split(': ', 1)[1])


def test_cli_test_run_matches_jax_enhancer(corpus, tmp_path, capsys):
    exp = make_experiment(default_storage=tmp_path / 'runs')
    exp.run_commandline([
        'test_run', 'with', 'multiarray', 'session_id=S02',
        f'database_path={corpus}', 'device=cpu',
        *(f'{k}={v!r}' for k, v in SETTINGS.items())])
    wavs = sorted((exp.run_dir / 'audio' / 'dev').glob('*.wav'))
    assert len(wavs) == 2, wavs
    stats = cache_stats(capsys.readouterr().out)    # the cached path ran
    assert stats['refills'] >= 1 and stats['direct'] == 0, stats
    assert stats['hits'] + stats['refills'] == 2, stats
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


def test_device_audio_cache_byte_identical(corpus, tmp_path):
    """The session with the session-audio cache writes WAVs byte-identical
    to the same session without it (the twin of the JAX test of the same
    name): the window holds the same file content, and the samples past
    the valid length are zeroed where the direct path zero-pads."""
    kw = dict(database_path=str(corpus), multiarray=True, device='cpu',
              **SETTINGS)
    off = get_enhancer(device_audio_cache=False, **kw)
    off.enhance_session(['S02'], tmp_path / 'off', audio_dir_exist_ok=True)
    on = get_enhancer(cache_window_seconds=20.0, **kw)
    on.enhance_session(['S02'], tmp_path / 'on', audio_dir_exist_ok=True)
    stats = on._audio_cache.stats
    assert stats['hits'] > 0, stats          # the cache actually served
    assert stats['refills'] == 1, stats      # 16 s session, 20 s window
    assert stats['direct'] == 0, stats
    wavs_off = sorted((tmp_path / 'off' / 'dev').glob('*.wav'))
    wavs_on = sorted((tmp_path / 'on' / 'dev').glob('*.wav'))
    assert [w.name for w in wavs_off] == [w.name for w in wavs_on]
    assert len(wavs_off) >= 2
    for a, b in zip(wavs_off, wavs_on):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_session_dispatch_is_time_ordered(tmp_path):
    """With the cache on, enhance_session reorders the static shard into
    session-time order (the speaker-grouped iterator would traverse the
    timeline once per speaker and refill the window each time), in the
    JAX enhancer's order on the same corpus."""
    from pb_chime5_tpu.testing import create_synthetic_chime5 as jax_corpus
    from pb_chime5_tpu_torch.models.enhancer import _example_start_key
    jax_corpus(tmp_path / 'c', session_ids=('S02',), duration_seconds=24.0,
               utterances_per_speaker=2, num_arrays=2, seed=5)
    json_path = tmp_path / 'chime5.json'
    dump_json(create_database(tmp_path / 'c'), json_path)
    kw = dict(database_path=str(json_path), wpe=False, multiarray=True,
              **SETTINGS)
    orders = {}
    for name, factory, extra in (
            ('port', get_enhancer, dict(device='cpu')),
            ('jax', jax_get_enhancer, dict(device_audio_cache=True))):
        enhancer = factory(**kw, **extra)
        grouped = [ex['example_id'] for ex in enhancer.get_iterator('S02')]
        order = []

        def fake_prepare(ex, use_cache=False, order=order):
            order.append(ex)
            return None, None

        # stub the device out: this tests the host loop's dispatch order
        enhancer._prepare_example = fake_prepare
        if name == 'port':
            enhancer._dispatch_loaded = \
                lambda ex, ra, obs: np.zeros(8, np.float32)
            enhancer._pipeline.gather = lambda handle: handle
        else:
            enhancer._dispatch_loaded = \
                lambda ex, ra, obs: (np.zeros(8, np.float32), None)
            enhancer._finish_dispatched = lambda handle, trim: handle
        enhancer.enhance_session(['S02'], tmp_path / name,
                                 audio_dir_exist_ok=True)
        orders[name] = [ex['example_id'] for ex in order]
        if name == 'port':
            assert len(order) == len(grouped) == 8
            starts = [_example_start_key(ex) for ex in order]
            assert starts == sorted(starts)
            assert orders[name] != grouped   # the reorder did something
    assert orders['port'] == orders['jax']


def test_factory_keywords_match_jax():
    """The port's ``get_enhancer`` takes every keyword of the JAX one, in
    its order, and adds only ``device``; the CLI's config (derived from
    the signature) holds them all.  The keywords of the compute dtype and
    of the session-audio cache keep the JAX defaults."""
    import inspect
    from pb_chime5_tpu.models.enhancer import get_enhancer as jax_factory
    port = inspect.signature(get_enhancer).parameters
    jax_ = inspect.signature(jax_factory).parameters
    assert list(port) == list(jax_) + ['device']
    for name in ('compute_dtype', 'device_audio_cache',
                 'cache_window_seconds', 'cache_prefetch'):
        assert port[name].default == jax_[name].default, name
    assert set(make_experiment().config) == set(port) | {'session_id',
                                                         'chime6'}


def test_factory_accepts_the_jax_keywords_at_their_defaults(corpus):
    enhancer = get_enhancer(database_path=str(corpus), device='cpu',
                            compute_dtype=np.float32,
                            cache_window_seconds=180.0, cache_prefetch=True)
    assert type(enhancer).__name__ == 'Enhancer'
    for dtype in (np.float64, 'float64'):
        enhancer = get_enhancer(database_path=str(corpus), device='cpu',
                                compute_dtype=dtype)
        assert enhancer._pipeline.dtype == dtype
    with pytest.raises(NotImplementedError):
        get_enhancer(database_path=str(corpus), device='cpu',
                     compute_dtype='float16')


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
        exp = make_experiment(default_storage=root / 'runs')
        exp.run_commandline([
            'test_run', 'with', 'session_id=S02', 'device=cpu',
            f'database_path={root}/db.json', 'context_samples=4000',
            'bss_iterations=2', 'wpe_tabs=2', 'length_buckets=(48000,)',
            'compute_dtype=float64'])
        assert len(list((exp.run_dir / 'audio' / 'dev').glob('*.wav'))) == 2

        from pb_chime5_tpu_torch.database.create_json import to_samples
        from pb_chime5_tpu_torch.io import load_json
        from pb_chime5_tpu_torch.scripts import kaldi_run, kaldi_run_rttm
        from pb_chime5_tpu_torch.scripts.simulate_chime6_transcriptions \
            import main as simulate
        simulate(root, root / 'CHiME6')
        dump_json(create_database(root / 'CHiME6', chime6=True),
                  root / 'chime6.json')
        lines = []
        for t in load_json(root / 'transcriptions' / 'dev' / 'S02.json'):
            s = to_samples(t['start_time']['original'])
            e = to_samples(t['end_time']['original'])
            lines.append(f"SPEAKER S02_U06 1 {s / 16000:.7f} "
                         f"{(e - s) / 16000:.7f} <NA> <NA> {t['speaker']} "
                         f"<NA>")
        (root / 'dev.rttm').write_text('\\n'.join(lines))
        cheap = ['device=cpu', 'context_samples=4000', 'bss_iterations=2',
                 'wpe=False', 'length_buckets=(48000,)']
        kaldi_run.make_experiment(default_storage=root / 'runs') \
            .run_commandline([
                'test_run', 'with', 'chime6=True', 'session_id=S02',
                f'database_path={root}/chime6.json',
                f'storage_dir={root}/kaldi', *cheap])
        kaldi_run_rttm.make_experiment(default_storage=root / 'runs') \
            .run_commandline([
                'test_run', 'with', 'session_id=S02',
                f'chime6_dir={root}/CHiME6', f'database_rttm={root}/dev.rttm',
                f'storage_dir={root}/rttm', *cheap])
        for out in ('kaldi', 'rttm'):
            assert len(list((root / out / 'audio' / 'dev').glob('*.wav'))) \
                == 2, out
        loaded = sorted({m.split('.')[0] for m in sys.modules})
        assert 'jax' not in loaded and 'pb_chime5_tpu' not in loaded, loaded
        print('NO_JAX_OK')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert 'NO_JAX_OK' in proc.stdout
