"""The port's database layer (``database/keys.py``, ``lazy.py``, the
package's ``DictDatabase``, ``chime5.py``, ``create_json.py``) against
the JAX package's: the twins of tests/test_database.py's lazy dataset,
``to_samples``, database builder, adjust / add-context family,
``nest_broadcast``, audio reader, Kaldi ids and ``example_id_map_fn``,
each run through both packages on the same synthetic corpus (seed 3) or
seeded inputs.  Exact host computations: compared exactly.

One deviation: a negative context raises ``ValueError`` in the port,
``AssertionError`` in the JAX package (same message).
"""

import numpy as np
import pytest

from pb_chime5_tpu import database as jax_database
from pb_chime5_tpu.database import (
    chime5 as jax_chime5, create_json as jax_create_json, keys as jax_keys,
    lazy as jax_lazy)
from pb_chime5_tpu.testing import create_synthetic_chime5, samples_to_time_str
from pb_chime5_tpu_torch import database
from pb_chime5_tpu_torch.database import (
    chime5, create_json, keys as K, lazy)
from pb_chime5_tpu_torch.io import dump_json


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('chime5_torch_db')
    info = create_synthetic_chime5(root, session_ids=('S02',),
                                   duration_seconds=20.0,
                                   utterances_per_speaker=2, seed=3)
    db_dict = create_json.create_database(root)
    json_path = root / 'chime5.json'
    dump_json(db_dict, json_path)
    return info, db_dict, json_path, root


def test_keys_match_jax():
    names = [n for n in vars(jax_keys) if n.isupper()]
    assert len(names) == 25
    assert {n: getattr(K, n) for n in names} == \
        {n: getattr(jax_keys, n) for n in names}


# ------------------------------------------------------------------ lazy --

def lazy_walk(mod):
    """tests/test_database.py's lazy-dataset scenario on one package's
    ``lazy`` module -> what it observed."""
    ds = mod.from_dict({'a': {'x': 1}, 'b': {'x': 2}, 'c': {'x': 3}})
    mapped = ds.map(lambda e: {**e, 'y': e['x'] * 10})
    out = dict(len=len(ds), by_id=ds['b'], by_pos=ds[1], items=list(ds),
               keys=ds.keys(), mapped=list(mapped), untouched=ds['a'],
               repr=repr(mapped))
    out['filtered'] = list(mapped.filter(lambda e: e['x'] > 1, lazy=False))
    with pytest.raises(NotImplementedError):
        mapped.filter(lambda e: e['x'] > 1)        # lazy: len would break
    out['sliced'] = list(mapped[0:2])
    out['picked'] = list(mapped[['c', 0]]) + list(mapped[(2, 'b')])
    out['groups'] = {g: list(d) for g, d in
                     mapped.groupby(lambda e: e['x'] % 2).items()}
    out['sorted'] = list(mapped.sort(lambda e: -e['x']))
    out['cat'] = list(mod.concatenate(mod.from_dict({'a': {'v': 1}}),
                                      mod.from_dict({'b': {'v': 2}})))
    out['cat_list'] = list(mod.concatenate([mod.from_dict({'a': {}})]))
    with pytest.raises(AssertionError):           # duplicate ids
        mod.concatenate(mod.from_dict({'a': {}}), mod.from_dict({'a': {}}))
    with pytest.raises(TypeError):
        ds[1.5]
    nested = mod.from_dict({'a': {'v': [1, 2]}})
    nested['a']['v'].append(3)                     # deep-copy isolation
    out['isolated'] = nested['a']
    return out


def test_lazy_dataset_matches_jax():
    got, want = lazy_walk(lazy), lazy_walk(jax_lazy)
    assert got == want
    assert got['isolated'] == {'v': [1, 2]}
    assert got['by_pos'] == {'x': 2} and len(got['filtered']) == 2
    assert got['repr'] == 'LazyDataset(len=3, transforms=1)'
    assert database.LazyDataset is lazy.LazyDataset


# -------------------------------------------------------------- to_samples

@pytest.mark.parametrize('text', ['0:47:52.708375', '0:47:52.7083750',
                                  '0:47:54.1956875', '1000:47:54.1956875',
                                  '0:01:04.62'])
def test_to_samples_matches_jax(text):
    assert create_json.to_samples(text) == jax_create_json.to_samples(text)


def test_to_samples_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    for s in rng.integers(0, 3 * 3600 * 16000, 50):
        text = samples_to_time_str(int(s))
        assert create_json.to_samples(text) == int(s) == \
            jax_create_json.to_samples(text)


# --------------------------------------------------------------- builder --

def test_create_database_matches_jax(corpus):
    info, db_dict, json_path, root = corpus
    assert db_dict == jax_create_json.create_database(root)
    assert db_dict[K.ALIAS] == {'dev': ['S02']}
    create_json.check_audio_files_exist(db_dict)
    jax_create_json.check_audio_files_exist(db_dict)
    db = database.JsonDatabase(json_path)
    jax_db = jax_database.JsonDatabase(json_path)
    assert db.dataset_names == jax_db.dataset_names == ('S02', 'dev')
    assert db.get_lengths('dev') == jax_db.get_lengths('dev')
    assert list(db.get_datasets(['S02'], use_weakref=False)) == \
        list(jax_db.get_datasets(['S02'], use_weakref=False))
    assert db.get_datasets('S02') is db.get_datasets('S02')  # weakref cache
    for x, t in [('S02', str), (['a', 'b'], str), ((1, 2), None), (3, None)]:
        assert database.to_list(x, t) == jax_database.to_list(x, t)
    with pytest.raises(KeyError):
        db.get_datasets('S99')


def test_create_json_helpers_match_jax(corpus):
    _, _, _, root = corpus
    from pb_chime5_tpu_torch.io import load_json
    trans = load_json(root / 'transcriptions' / 'dev' / 'S02.json')
    audio = root / 'audio' / 'dev'
    for t in trans:
        for chime6 in (False,):
            assert create_json.transform_times(t['start_time'], chime6) == \
                jax_create_json.transform_times(t['start_time'], chime6)
        kw = dict(start_sample=create_json.to_samples(
            t['start_time']['original']), end_sample=create_json.to_samples(
                t['end_time']['original']), session_id=t['session_id'],
            speaker_id=t['speaker'])
        for chime6 in (False, True):
            assert create_json.get_example_id(**kw, chime6=chime6) == \
                jax_create_json.get_example_id(**kw, chime6=chime6)
        assert create_json.get_example(t, audio) == \
            jax_create_json.get_example(t, audio)
    assert create_json.transform_times('123', chime6=True) == 123
    for name in ('SAMPLE_RATE', 'NUM_MICS', 'NUM_ARRAYS', 'FEMALE_SPEAKERS',
                 'EXCLUDED_EXAMPLE_IDS', 'MISSING_ARRAYS_CHIME5',
                 'MISSING_ARRAYS_CHIME6'):
        assert getattr(create_json, name) == getattr(jax_create_json, name)


# ----------------------------------------------------------- adjust_times

def test_adjust_start_end_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        w_s = int(rng.integers(0, 100))
        w_e = w_s + int(rng.integers(1, 100))
        a_s = int(rng.integers(0, 100))
        a_e = a_s + w_e - w_s + int(rng.integers(-5, 6))
        assert chime5._adjust_start_end(w_s, w_e, a_s, a_e) == \
            jax_chime5._adjust_start_end(w_s, w_e, a_s, a_e)


@pytest.mark.parametrize('options', [
    dict(),
    dict(adjust_times=True, drop_unknown_target_speaker=True),
    dict(context_samples=100),
    dict(context_samples=10 ** 10, equal_start_context=True),
    dict(context_samples=[100, 50]),
    dict(context_samples=16000, adjust_times=True,
         drop_unknown_target_speaker=True),
], ids=['plain', 'adjust', 'context', 'equal_start', 'pair',
        'context_adjust'])
def test_session_iterator_matches_jax(corpus, options):
    _, _, json_path, _ = corpus
    got = list(chime5.Chime5(json_path).get_iterator_for_session(
        'S02', **options))
    want = list(jax_chime5.Chime5(json_path).get_iterator_for_session(
        'S02', **options))
    assert got == want and len(got) > 0


def context_example():
    return {
        K.START: {'observation': {'U01': 480, 'U05': 0}, 'original': 1000,
                  'worn': {'P05': 1000}},
        K.END: {'observation': {'U01': 1480, 'U05': 1000},
                'original': 2000, 'worn': {'P05': 2000}},
        K.NUM_SAMPLES: {'observation': {'U01': 1000, 'U05': 1000},
                        'original': 1000, 'worn': {'P05': 1000}},
    }


@pytest.mark.parametrize('samples,equal', [
    (100, False), (10 ** 10, False), (10 ** 10, True), ([100, 50], False),
    ([7], False),
    ({'observation': [100, 50], 'original': 0, 'worn': 20}, False),
    ({'observation': {'U01': 5, 'U05': [1, 2]}, 'original': [3, 4],
      'worn': 0}, False),
], ids=['int', 'huge', 'equal_start', 'pair', 'one', 'dict', 'nested'])
def test_add_context_matches_jax(samples, equal):
    got = chime5.AddContext(samples, equal_start_context=equal)(
        chime5.backup_orig_start_end(context_example()))
    want = jax_chime5.AddContext(samples, equal_start_context=equal)(
        jax_chime5.backup_orig_start_end(context_example()))
    assert got == want


def test_add_context_negative_rejected():
    for samples in (-50, [100, -50]):
        with pytest.raises(ValueError, match='Negative context'):
            chime5.AddContext(samples)
        with pytest.raises(AssertionError, match='Negative context'):
            jax_chime5.AddContext(samples)


@pytest.mark.parametrize('value', [
    10, {'a': 11, 'b': 12}, {'a': 11, 'b': [13, 14]}, {'a': 11}, (1, 2)])
@pytest.mark.parametrize('sequence_type', [(tuple, list), None])
def test_nest_broadcast_matches_jax(value, sequence_type):
    shallow = {'a': [1, 2, (3, 4)], 'b': [5, (6,)]}

    def outcome(fn):
        try:
            return fn(shallow, value, sequence_type=sequence_type)
        except (AssertionError, TypeError) as e:
            return type(e)
    assert outcome(chime5.nest_broadcast) == \
        outcome(jax_chime5.nest_broadcast)


def test_nest_map_structure_matches_jax():
    a = {'x': [1, 2, (3, 4)], 'y': 5}
    b = {'x': [10, 20, (30, 40)], 'y': 50}
    fn = lambda u, v=0: u * 2 + v   # noqa: E731
    assert chime5.nest_map_structure(fn, a, b) == \
        jax_chime5.nest_map_structure(fn, a, b) == \
        {'x': [12, 24, (36, 48)], 'y': 60}
    assert chime5.nest_map_structure(fn, a, 1) == \
        jax_chime5.nest_map_structure(fn, a, 1)


# ----------------------------------------------------------------- reader

def same_audio(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same_audio(got[k], want[k])
    else:
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_audio_reader_matches_jax(corpus):
    _, _, json_path, _ = corpus
    ex = chime5.Chime5(json_path).get_iterator_for_session(
        'S02', audio_read=True, context_samples=800)[0]
    jax_ex = jax_chime5.Chime5(json_path).get_iterator_for_session(
        'S02', audio_read=True, context_samples=800)[0]
    same_audio(ex[K.AUDIO_DATA], jax_ex[K.AUDIO_DATA])
    u01 = ex[K.AUDIO_DATA]['observation']['U01']
    assert u01.shape == (4, ex[K.NUM_SAMPLES]['observation']['U01'])
    # one key, no destination key: the tracks land in the example itself
    plain = chime5.Chime5(json_path).get_iterator_for_session('S02')[0]
    got = chime5.Chime5AudioReader(dst_key=None, audio_keys='worn')(
        dict(plain))
    want = jax_chime5.Chime5AudioReader(dst_key=None, audio_keys='worn')(
        dict(plain))
    same_audio(got['worn'], want['worn'])
    tree = chime5.recursive_audio_transform(
        lambda p, start, stop: (p[-9:], start, stop),
        plain[K.AUDIO_PATH], plain[K.START], plain[K.END])
    assert tree == jax_chime5.recursive_audio_transform(
        lambda p, start, stop: (p[-9:], start, stop),
        plain[K.AUDIO_PATH], plain[K.START], plain[K.END])


# ----------------------------------------------------------------- ids ---

@pytest.mark.parametrize('example_id', [
    'P28_S09_LIVING.R-0714562-0714764',
    'P09_S03_U01_NOLOCATION.CH1-0005948-0006038',
    'P05_S02_U02_KITCHEN.ENH-0007012-0007298', 'not-an-id'])
def test_kaldi_ids_match_jax(example_id):
    for name in ('kaldi_to_nt_example_id', 'kaldi_id_to_parts',
                 'kaldi_id_to_channel'):
        def outcome(mod):
            try:
                return getattr(mod, name)(example_id)
            except (ValueError, NotImplementedError) as e:
                return type(e)
        assert outcome(chime5) == outcome(jax_chime5), name


def test_chime5_database_properties_match_jax(corpus):
    _, _, json_path, _ = corpus
    db, jax_db = chime5.Chime5(json_path), jax_chime5.Chime5(json_path)
    for name in ('datasets_train', 'datasets_eval', 'datasets_test',
                 'map_dataset_to_sessions', 'dataset_names'):
        assert getattr(db, name) == getattr(jax_db, name), name
    for ex in [{K.EXAMPLE_ID: 'P05_S02_0004060-0004382', K.LOCATION:
                'kitchen'}, {K.EXAMPLE_ID: 'P09_S03_0005948-0006038',
                             K.LOCATION: 'unknown'}]:
        assert chime5.Chime5.example_id_map_fn(ex) == \
            jax_chime5.Chime5.example_id_map_fn(ex)
    assert chime5.Chime5.example_id_map_fn(
        {K.EXAMPLE_ID: 'P05_S02_0004060-0004382', K.LOCATION: 'kitchen'}) \
        == 'P05_S02_KITCHEN.L-0004060-0004382'
