"""The port's host layer (corpus tables, WAV / JSON I/O, synthetic corpus,
database JSON, session iterators, activity, CLI engine) vs the JAX
package's.  These are exact host computations (integers, booleans,
file bytes), so every comparison is exact.
"""

import json

import numpy as np
import pytest

from pb_chime5_tpu import activity as jax_activity
from pb_chime5_tpu import io as jax_io
from pb_chime5_tpu import mapping as jax_mapping
from pb_chime5_tpu.database.chime5 import Chime5 as JaxChime5
from pb_chime5_tpu.database.create_json import (
    create_database as jax_create_database)
from pb_chime5_tpu.scripts.experiment import Experiment as JaxExperiment
from pb_chime5_tpu.testing import (
    create_synthetic_chime5 as jax_create_synthetic_chime5)
from pb_chime5_tpu.utils import ArrayInterval as JaxArrayInterval
from pb_chime5_tpu.utils.activity_freq import (
    activity_time_to_frequency as jax_activity_time_to_frequency)
from pb_chime5_tpu_torch import activity, io, mapping, testing, utils
from pb_chime5_tpu_torch.database.chime5 import Chime5
from pb_chime5_tpu_torch.database.create_json import create_database
from pb_chime5_tpu_torch.scripts.experiment import Experiment


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """A synthetic 3-array session and its database JSON, both made by
    the JAX package."""
    root = tmp_path_factory.mktemp('host')
    jax_create_synthetic_chime5(
        root, session_ids=('S02',), duration_seconds=20.0,
        utterances_per_speaker=2, num_arrays=3, seed=3, pcm16=True)
    jax_io.dump_json(jax_create_database(root), root / 'chime5.json')
    return {'root': root, 'db': root / 'chime5.json'}


@pytest.mark.parametrize('table', [
    'session_to_speakers', 'session_to_dataset', 'session_to_arrays',
    'session_array_to_num_samples', 'dev_session_to_reference_arrays',
    'session_ids', 'dataset_to_sessions'])
def test_mapping_tables_match_jax(table):
    assert getattr(mapping, table) == getattr(jax_mapping, table)


@pytest.mark.parametrize('pcm16', [True, False])
def test_synthetic_corpus_matches_jax(tmp_path, pcm16):
    kw = dict(session_ids=('S02',), duration_seconds=8.0,
              utterances_per_speaker=1, num_arrays=2, seed=5, pcm16=pcm16)
    want = jax_create_synthetic_chime5(tmp_path / 'jax', **kw)
    got = testing.create_synthetic_chime5(tmp_path / 'port', **kw)
    for key in ('utterances', 'arrays', 'speakers', 'drifts', 'num_samples'):
        assert got['sessions']['S02'][key] == want['sessions']['S02'][key]
    np.testing.assert_array_equal(got['sessions']['S02']['sources'],
                                  want['sessions']['S02']['sources'])
    files = sorted(p.relative_to(tmp_path / 'jax')
                   for p in (tmp_path / 'jax').rglob('*') if p.is_file())
    assert files == sorted(
        p.relative_to(tmp_path / 'port')
        for p in (tmp_path / 'port').rglob('*') if p.is_file())
    for rel in files:
        if rel.suffix == '.json':
            assert (tmp_path / 'port' / rel).read_text() == \
                (tmp_path / 'jax' / rel).read_text()
        else:
            np.testing.assert_array_equal(
                io.load_audio(tmp_path / 'port' / rel, dtype=None),
                jax_io.load_audio(tmp_path / 'jax' / rel, dtype=None))


def test_create_database_matches_jax(corpus):
    assert create_database(corpus['root']) == jax_create_database(
        corpus['root'])


@pytest.mark.parametrize('start,stop,dtype', [
    (0, None, np.float64), (1000, 5000, np.float32), (300, 301, None),
    (150000, 400000, None)])
def test_load_audio_matches_jax(corpus, start, stop, dtype):
    paths = json.loads(corpus['db'].read_text())['datasets']['S02']
    ex = next(iter(paths.values()))
    for path in (ex['audio_path']['observation']['U01'],      # 4 files
                 ex['audio_path']['worn']['P05']):            # stereo
        got = io.load_audio(path, start=start, stop=stop, dtype=dtype)
        want = jax_io.load_audio(path, start=start, stop=stop, dtype=dtype)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('dtype,normalize', [
    (np.int16, True), (np.int16, False), (None, False)])
@pytest.mark.parametrize('channels', [1, 3])
def test_dump_audio_matches_jax(tmp_path, dtype, normalize, channels):
    x = np.random.default_rng(6).standard_normal((channels, 999)).squeeze()
    x = (0.3 * x).astype(np.float32)
    io.dump_audio(x, tmp_path / 'port.wav', dtype=dtype, normalize=normalize)
    jax_io.dump_audio(x, tmp_path / 'jax.wav', dtype=dtype,
                      normalize=normalize)
    for read_dtype in (None, np.float64):
        np.testing.assert_array_equal(
            jax_io.load_audio(tmp_path / 'port.wav', dtype=read_dtype),
            jax_io.load_audio(tmp_path / 'jax.wav', dtype=read_dtype))


@pytest.mark.parametrize('context_samples', [0, 16000, 240000])
def test_session_iterator_matches_jax(corpus, context_samples):
    """The enhancer's reading of a session (the JAX enhancer's arguments,
    models/enhancer.py ``get_iterator``)."""
    got = Chime5(corpus['db']).get_iterator_for_session(
        'S02', adjust_times=True, drop_unknown_target_speaker=True,
        context_samples=context_samples, equal_start_context=True)
    want = JaxChime5(corpus['db']).get_iterator_for_session(
        'S02', adjust_times=True, drop_unknown_target_speaker=True,
        context_samples=context_samples, equal_start_context=True)
    assert len(got) == len(want) > 0
    assert list(got) == list(want)
    assert list(got[:2]) == list(want[:2])
    key = want.keys()[1]
    assert got[key] == want[key]


def test_session_iterator_rejects_bad_context(corpus):
    with pytest.raises(ValueError):
        Chime5(corpus['db']).get_iterator_for_session(
            'S02', context_samples=-1)


@pytest.mark.parametrize('garbage_class', [True, False, None, 2])
def test_array_activity_matches_jax(corpus, garbage_class):
    got = activity.get_activity(
        Chime5(corpus['db']).get_datasets('S02'),
        garbage_class=garbage_class)['S02']
    want = jax_activity.get_activity(
        JaxChime5(corpus['db']).get_datasets('S02'), perspective='array',
        garbage_class=garbage_class)['S02']
    assert list(got) == list(want)
    for array in want:
        assert list(got[array]) == list(want[array])
        for track, ai in want[array].items():
            assert got[array][track].shape == ai.shape
            assert got[array][track].intervals == ai.normalized_intervals


def test_array_interval_matches_jax():
    rng = np.random.default_rng(7)
    got, want = utils.ArrayInterval(5000), JaxArrayInterval(5000)
    for _ in range(200):
        s, e = sorted(rng.integers(0, 5001, 2))
        value = int(rng.random() < 0.6)
        got[s:e] = value
        want[s:e] = value
        assert got.intervals == want.normalized_intervals
    for _ in range(50):
        s, e = sorted(rng.integers(0, 5001, 2))
        np.testing.assert_array_equal(got[s:e], want[s:e])
    assert len(got) == 5000


@pytest.mark.parametrize('fading,pad', [(True, True), (False, True),
                                        (False, False)])
def test_activity_time_to_frequency_matches_jax(fading, pad):
    act = np.random.default_rng(8).random((3, 7001)) > 0.995
    np.testing.assert_array_equal(
        utils.activity_time_to_frequency(act, 1024, 256, fading, pad),
        jax_activity_time_to_frequency(act, 1024, 256, stft_fading=fading,
                                       stft_pad=pad))


def _cli(cls, storage, fail):
    exp = cls('host test', default_storage_dir=storage)

    def factory(alpha=1, beta='x', gamma=(1, 2)):
        pass

    exp.add_config_from_signature(factory)
    exp.named_config('big', {'alpha': 100})

    def main(e):
        if fail:
            raise ValueError('boom')
        return dict(e.config)

    exp._commands['main'] = main
    return exp


@pytest.mark.parametrize('fail', [False, True])
def test_experiment_engine_matches_jax(tmp_path, fail):
    argv = ['with', 'big', 'beta=hello', 'gamma=(3, 4)']
    results = {}
    for name, cls in (('port', Experiment), ('jax', JaxExperiment)):
        exp = _cli(cls, tmp_path / name, fail)
        if fail:
            with pytest.raises(ValueError):
                exp.run_commandline(argv)
        else:
            results[name] = exp.run_commandline(argv)
        assert exp.run_dir == tmp_path / name / '1'
        run = json.loads((exp.run_dir / 'run.json').read_text())
        assert run['status'] == ('FAILED' if fail else 'COMPLETED')
        results[name, 'config'] = (exp.run_dir / 'config.json').read_text()
    assert results['port', 'config'] == results['jax', 'config']
    if not fail:
        assert results['port'] == results['jax'] == {
            'alpha': 100, 'beta': 'hello', 'gamma': (3, 4)}
