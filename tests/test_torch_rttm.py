"""The port's CHiME-6 track 2 (activity from an RTTM diarization) on the
CPU against the JAX package: the RTTM parser, the file-id normalization,
the audio globs, the RTTM database (its ``_U06.-`` example ids and its
eager, short-track-tolerant audio read), the activity's garbage class,
the RTTM enhancer and ``scripts/kaldi_run_rttm`` (ci.sh's invocation),
on the corpus of tests/test_torch_enhancer.py (2 arrays, 16 s, seed 11,
PCM16) made into a CHiME-6 tree, with ci.sh's RTTM of its annotations.
Also: the new factories and CLIs raise without a card at
``device='cuda'``.

Tolerances: the parser, the database, the audio reads and the activity
are exact host computations, compared exactly.  The RTTM enhancer's WAVs
(``multiarray='outer_array_mics'``, 3 EM iterations, WPE on) agree with
the JAX RTTM enhancer's (its fused kernel EM in interpret mode) to 2e-2
of full scale, as in tests/test_torch_enhancer.py.
"""

import inspect
import shutil

import numpy as np
import pytest
import torch

from pb_chime5_tpu.database import rttm as jax_rttm
from pb_chime5_tpu.io import dump_audio, load_audio
from pb_chime5_tpu.models import enhancer_rttm as jax_enhancer_rttm
from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig
from pb_chime5_tpu.scripts.simulate_chime6_transcriptions import (
    main as jax_simulate)
from pb_chime5_tpu.testing import create_synthetic_chime5
from pb_chime5_tpu.utils.array_interval import (
    ArrayInterval as JaxArrayInterval,
    array_intervals_from_rttm as jax_from_rttm)
from pb_chime5_tpu_torch.database import rttm
from pb_chime5_tpu_torch.database.create_json import (
    create_database, to_samples)
from pb_chime5_tpu_torch.io import dump_json, load_json
from pb_chime5_tpu_torch.io import load_audio as port_load_audio
from pb_chime5_tpu_torch.models import enhancer_chime6, enhancer_rttm
from pb_chime5_tpu_torch.scripts import kaldi_run, kaldi_run_rttm
from pb_chime5_tpu_torch.utils import ArrayInterval, array_intervals_from_rttm

torch.set_num_threads(2)


def rttm_lines(chime5_dir, file_id='S02_U06'):
    """ci.sh's RTTM of the annotations (the worn clock's times)."""
    lines = []
    for t in load_json(chime5_dir / 'transcriptions' / 'dev' / 'S02.json'):
        s = to_samples(t['start_time']['original'])
        e = to_samples(t['end_time']['original'])
        lines.append(f"SPEAKER {file_id} 1 {s / 16000:.7f} "
                     f"{(e - s) / 16000:.7f} <NA> <NA> {t['speaker']} <NA>")
    return lines


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The CHiME-6 tree of the JAX package's corpus, its CHiME-6 JSON, and
    ci.sh's RTTM of its annotations."""
    root = tmp_path_factory.mktemp('rttm_torch')
    create_synthetic_chime5(
        root / 'CHiME5', session_ids=('S02',), duration_seconds=16.0,
        utterances_per_speaker=1, num_arrays=2, seed=11, pcm16=True)
    jax_simulate(root / 'CHiME5', root / 'CHiME6')
    dump_json(create_database(root / 'CHiME6', chime6=True),
              root / 'chime6.json')
    (root / 'dev.rttm').write_text('\n'.join(rttm_lines(root / 'CHiME5')))
    return root


@pytest.mark.parametrize('shape', [None, 16000 * 20])
def test_array_intervals_from_rttm_matches_jax(corpus, tmp_path, shape):
    """ci.sh's RTTM and one with two files, overlapping and touching
    intervals and a blank line."""
    extra = tmp_path / 'extra.rttm'
    extra.write_text('\n'.join([
        'SPEAKER S03_U06.ENH 1 1.5 2.0 <NA> <NA> P09 <NA>',
        'SPEAKER S02 1 0.25 1.0 <NA> <NA> P05 <NA>',
        '',
        'SPEAKER S03_U06.ENH 1 3.0 1.0 <NA> <NA> P09 <NA>',
        'SPEAKER S03_U06.ENH 1 4.0 0.5 <NA> <NA> P10 <NA>',
        'SPEAKER S02 1 5.0 0.0625 <NA> <NA> P06 <NA>']))
    for path in (corpus / 'dev.rttm', extra):
        got = array_intervals_from_rttm(path, shape=shape)
        want = jax_from_rttm(path, shape=shape)
        assert list(got) == list(want)
        for file_id, speakers in want.items():
            assert list(got[file_id]) == list(speakers)
            for name, ai in speakers.items():
                assert got[file_id][name].shape == ai.shape
                assert got[file_id][name].normalized_intervals == \
                    ai.normalized_intervals


@pytest.mark.parametrize('shape', [None, 4000])
def test_add_intervals_matches_jax(shape):
    """Overlapping, touching, unordered and contained slices added to a
    track that already holds one interval."""
    slices = [slice(100, 200), slice(150, 300), slice(300, 350),
              slice(1000, 1200), slice(10, 20), slice(520, 540)]
    got, want = ArrayInterval(shape), JaxArrayInterval(shape)
    for track in (got, want):
        track[500:600] = 1
        track.add_intervals(slices)
    assert got.normalized_intervals == want.normalized_intervals
    np.testing.assert_array_equal(got[0:1500], want[0:1500])


def test_normalize_rttm_file_ids_matches_jax():
    data = {'S02_U06': 1, 'S03.ENH': 2, 'S09_U06.ENH': 3, 'S21': 4}
    assert rttm.normalize_rttm_file_ids(data) == \
        jax_rttm.normalize_rttm_file_ids(data) == \
        {'S02': 1, 'S03': 2, 'S09': 3, 'S21': 4}
    for fn in (rttm.normalize_rttm_file_ids,
               jax_rttm.normalize_rttm_file_ids):
        with pytest.raises(AssertionError):
            fn({'S02_U06': 1, 'S02': 2})


@pytest.mark.parametrize('worn,flat', [(False, False), (False, True),
                                       (True, False)])
def test_get_chime6_files_matches_jax(corpus, worn, flat):
    got = rttm.get_chime6_files(corpus / 'CHiME6', worn=worn, flat=flat)
    assert got == jax_rttm.get_chime6_files(corpus / 'CHiME6', worn=worn,
                                            flat=flat)
    assert list(got) == ['S02']


@pytest.mark.parametrize('multiarray', [True, 'outer_array_mics',
                                        'first_array_mics', 'chime6_dir'])
def test_rttm_database_matches_jax(corpus, multiarray):
    if multiarray == 'chime6_dir':
        got = rttm.Chime6RTTMDatabase(corpus / 'dev.rttm', corpus / 'CHiME6')
        want = jax_rttm.Chime6RTTMDatabase(corpus / 'dev.rttm',
                                           corpus / 'CHiME6')
        assert got.worn_files == want.worn_files
    else:
        got = enhancer_rttm.get_database(corpus / 'CHiME6',
                                         corpus / 'dev.rttm', multiarray)
        want = jax_enhancer_rttm.get_database(corpus / 'CHiME6',
                                              corpus / 'dev.rttm', multiarray)
    assert got.database_dict == want.database_dict
    ids = list(got.database_dict['datasets']['S02'])
    assert ids == list(want.database_dict['datasets']['S02'])
    assert len(ids) == 4 and all(i.startswith('S02_U06.-P') for i in ids)
    assert got.database_dict['alias'] == {'dev': ['S02']}


@pytest.mark.parametrize('context_samples', [0, 8000])
def test_dataset_for_session_matches_jax(corpus, context_samples):
    """The RTTM enhancer's reading of a session: the examples with their
    eager float64 audio (outer array mics: 2 arrays x 2)."""
    kw = dict(audio_read=True, context_samples=context_samples)
    got = enhancer_rttm.get_database(
        corpus / 'CHiME6', corpus / 'dev.rttm', 'outer_array_mics'
    ).get_dataset_for_session('S02', **kw)
    want = jax_enhancer_rttm.get_database(
        corpus / 'CHiME6', corpus / 'dev.rttm', 'outer_array_mics'
    ).get_dataset_for_session('S02', **kw)
    assert list(got.keys()) == list(want.keys())
    for key in want.keys():
        a, b = got[key], want[key]
        audio_a, audio_b = a.pop('audio_data'), b.pop('audio_data')
        assert a == b
        assert audio_a.shape == audio_b.shape == (4, a['end'] - a['start'])
        assert audio_a.dtype == audio_b.dtype == np.float64
        np.testing.assert_array_equal(audio_a, audio_b)


@pytest.mark.parametrize('lengths,min_num_samples,max_missing', [
    ((5000, 5000, 1000, 5000), 4000, 8),     # the short track is dropped
    ((5000, 4500, 4800, 5000), 4000, 8),     # cut to the common length
    ((5000, 1000, 1000, 5000), 4000, 1),     # too many dropped: raises
])
def test_recursive_load_audio_matches_jax(tmp_path, lengths, min_num_samples,
                                          max_missing):
    rng = np.random.default_rng(2)
    paths = []
    for i, n in enumerate(lengths):
        paths.append(str(tmp_path / f'track{i}.wav'))
        dump_audio(rng.uniform(-0.5, 0.5, n), paths[-1], normalize=False)
    kw = dict(start=200, stop=5000, min_num_samples=min_num_samples,
              max_missing=max_missing)
    dropped = sum(n - 200 < min_num_samples for n in lengths)
    if dropped > max_missing:
        with pytest.raises(ValueError):
            rttm.recursive_load_audio(paths, **kw)
        with pytest.raises(AssertionError):
            jax_rttm.recursive_load_audio(paths, **kw)
        return
    got = rttm.recursive_load_audio({'a': paths}, **kw)['a']
    want = jax_rttm.recursive_load_audio({'a': paths}, **kw)['a']
    kept = [n for n in lengths if n - 200 >= min_num_samples]
    assert got.shape == want.shape == (len(kept), min(kept) - 200)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('garbage_class', [True, False, None, 2])
def test_activity_garbage_class_matches_jax(corpus, garbage_class):
    got = enhancer_rttm.Activity(garbage_class=garbage_class,
                                 rttm=str(corpus / 'dev.rttm'))
    want = jax_enhancer_rttm.Activity(garbage_class=garbage_class,
                                      rttm=str(corpus / 'dev.rttm'))
    if garbage_class == 2:
        for activity in (got, want):
            with pytest.raises(ValueError):
                activity['S02']
        return
    got, want = got['S02'], want['S02']
    assert list(got) == list(want)
    assert ('Noise' in got) == (garbage_class is not None)
    for name, ai in want.items():
        assert got[name].normalized_intervals == ai.normalized_intervals
        for lo in (0, 10 * 3600 * 16000 - 5):    # the start, the horizon
            np.testing.assert_array_equal(got[name][lo:lo + 300000],
                                          ai[lo:lo + 300000])


def test_enhancer_rttm_matches_jax(corpus, tmp_path):
    """The RTTM enhancer at its default ``outer_array_mics`` against the
    JAX one, two utterances, on a copy of the tree whose last channel of
    U02 ends at 6 s, as U05 of a real CHiME-6 session ends early: the
    second utterance's read drops that track, so its chain runs on 3
    channels, the first's on 4."""
    shutil.copytree(corpus / 'CHiME6', tmp_path / 'CHiME6')
    short = tmp_path / 'CHiME6' / 'audio' / 'dev' / 'S02_U02.CH4.wav'
    dump_audio(port_load_audio(short, dtype=None)[:6 * 16000], short,
               normalize=False, dtype=None)
    settings = dict(bss_iterations=3, context_samples=8000,
                    length_buckets=(16000 * 4,))
    enhancer = enhancer_rttm.get_enhancer(
        database_rttm=str(corpus / 'dev.rttm'),
        activity_rttm=str(corpus / 'dev.rttm'),
        chime6_dir=str(tmp_path / 'CHiME6'), device='cpu', **settings)
    dataset = enhancer.get_dataset('S02')
    assert [dataset[k]['audio_data'].shape[0]
            for k in dataset.keys()[:2]] == [4, 3]
    enhancer.enhance_session('S02', tmp_path / 'port', dataset_slice=2)
    jax_enhancer = jax_enhancer_rttm.Enhancer(
        db=jax_enhancer_rttm.get_database(
            tmp_path / 'CHiME6', str(corpus / 'dev.rttm'),
            'outer_array_mics'),
        activity=jax_enhancer_rttm.Activity(
            garbage_class=True, rttm=str(corpus / 'dev.rttm')),
        gss_config=JaxGssConfig(bss_iterations=3, bss_em_backend='pallas'),
        context_samples=8000, length_buckets=(16000 * 4,))
    jax_enhancer.enhance_session('S02', tmp_path / 'jax', dataset_slice=2)
    wavs = sorted((tmp_path / 'port' / 'dev').glob('*.wav'))
    assert [w.name for w in wavs] == sorted(
        w.name for w in (tmp_path / 'jax' / 'dev').glob('*.wav'))
    assert len(wavs) == 2
    db = enhancer.db.database_dict['datasets']['S02']
    for wav in wavs:
        got = load_audio(wav)
        want = load_audio(tmp_path / 'jax' / 'dev' / wav.name)
        assert got.shape == want.shape == (db[wav.stem]['num_samples'],)
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, atol=2e-2)


def test_kaldi_run_rttm_test_run(corpus, tmp_path):
    """ci.sh's track-2 run through the port (``device=cpu``); the RTTM's
    '_U06' file ids resolve, ``activity_rttm`` defaults to
    ``database_rttm`` and the dataset alias 'dev' to its sessions."""
    exp = kaldi_run_rttm.make_experiment(default_storage=tmp_path / 'runs')
    exp.run_commandline([
        'test_run', 'with', 'session_id=dev', f'storage_dir={tmp_path}',
        f'chime6_dir={corpus / "CHiME6"}',
        f'database_rttm={corpus / "dev.rttm"}', 'device=cpu',
        'multiarray=first_array_mics', 'wpe=False', 'bss_iterations=2',
        'context_samples=8000', 'length_buckets=(32000, 64000)'])
    wavs = sorted((tmp_path / 'audio' / 'dev').glob('*.wav'))
    assert len(wavs) == 2
    for wav in wavs:
        x = load_audio(wav)
        assert '_U06.-' in wav.stem and x.ndim == 1
        assert np.isfinite(x).all() and np.abs(x).max() > 0
    with pytest.raises(NotImplementedError, match='no_such_key'):
        kaldi_run_rttm.make_experiment(default_storage=tmp_path / 'runs') \
            .run_commandline([
                'test_run', 'with', f'storage_dir={tmp_path}',
                f'database_rttm={corpus / "dev.rttm"}', 'no_such_key=1'])


def test_kaldi_run_rttm_float64_matches_jax(corpus, tmp_path, monkeypatch):
    """``compute_dtype=float64`` on the track-2 CLI: the eager float64
    reads upload as float64 (no cast to float32), and the WAVs equal the
    JAX RTTM enhancer's in float64 within one LSB of int16."""
    from pb_chime5_tpu_torch.models.gss import GssPipeline
    uploaded = []
    real = GssPipeline._upload

    def record(self, array):
        uploaded.append(array.dtype)
        return real(self, array)
    monkeypatch.setattr(GssPipeline, '_upload', record)
    cheap = dict(bss_iterations=2, context_samples=8000,
                 length_buckets=(16000 * 4,))
    kaldi_run_rttm.make_experiment(default_storage=tmp_path / 'runs') \
        .run_commandline([
            'test_run', 'with', 'session_id=S02',
            f'storage_dir={tmp_path / "port"}',
            f'chime6_dir={corpus / "CHiME6"}',
            f'database_rttm={corpus / "dev.rttm"}', 'device=cpu',
            'compute_dtype=float64',
            *(f'{k}={v!r}' for k, v in cheap.items())])
    assert uploaded and set(uploaded) <= {np.dtype(np.float64),
                                          np.dtype(np.int8)}
    assert np.dtype(np.float64) in uploaded
    jax_enhancer = jax_enhancer_rttm.get_enhancer(
        database_rttm=str(corpus / 'dev.rttm'),
        activity_rttm=str(corpus / 'dev.rttm'),
        chime6_dir=str(corpus / 'CHiME6'), compute_dtype=np.float64, **cheap)
    jax_enhancer.enhance_session('S02', tmp_path / 'jax', dataset_slice=2)
    wavs = sorted((tmp_path / 'port' / 'audio' / 'dev').glob('*.wav'))
    assert len(wavs) == 2
    for wav in wavs:
        got = load_audio(wav)
        want = load_audio(tmp_path / 'jax' / 'dev' / wav.name)
        assert got.shape == want.shape and np.abs(got).max() > 0
        assert np.abs(got - want).max() <= 2.0 ** -15


def test_factory_keywords_match_jax():
    port = inspect.signature(enhancer_rttm.get_enhancer).parameters
    jax_ = inspect.signature(jax_enhancer_rttm.get_enhancer).parameters
    assert list(port) == list(jax_) + ['device']
    for name, param in jax_.items():
        assert port[name].default == param.default, name


@pytest.mark.parametrize('entry', ['enhancer_chime6', 'enhancer_rttm',
                                   'kaldi_run', 'kaldi_run_rttm'])
def test_entry_points_without_card_raise(corpus, tmp_path, entry):
    """Left at ``device='cuda'``, the new factories and CLIs raise on a
    machine without a card."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    rttm_kw = dict(chime6_dir=str(corpus / 'CHiME6'),
                   database_rttm=str(corpus / 'dev.rttm'))
    calls = {
        'enhancer_chime6': lambda: enhancer_chime6.get_enhancer(
            database_path=str(corpus / 'chime6.json')),
        'enhancer_rttm': lambda: enhancer_rttm.get_enhancer(
            activity_rttm=rttm_kw['database_rttm'], **rttm_kw),
        'kaldi_run': lambda: kaldi_run.make_experiment(
            default_storage=tmp_path / 'runs').run_commandline([
                'with', 'chime6=True', f'storage_dir={tmp_path}',
                f'database_path={corpus / "chime6.json"}']),
        'kaldi_run_rttm': lambda: kaldi_run_rttm.make_experiment(
            default_storage=tmp_path / 'runs').run_commandline([
                'with', f'storage_dir={tmp_path}',
                *(f'{k}={v}' for k, v in rttm_kw.items())]),
    }
    with pytest.raises(RuntimeError, match='cuda'):
        calls[entry]()
