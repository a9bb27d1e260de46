"""The port's alignment-refined activity (``activity_alignment.py``, the
whole ``activity.get_activity``) against the JAX package's, on the
synthetic corpus, with Kaldi alignments from ``testing/fake_kaldi.py``'s
stub tools.

Twins of ``tests/test_activity_alignment.py``; beside them: every
perspective with and without a refining function, as interval tracks
and dense arrays; the CLI's pickles (equal intervals, and loaded by a
process that imports neither JAX nor the JAX package); the enhancer's
``activity_type='path'`` on the annotation pickles against
``'annotation'``; and the refined chain against the JAX enhancer's.

Tolerances: activity and pickles are booleans and integers, compared
exactly; ``'path'`` on the annotation pickles is the same computation as
``'annotation'``, so its WAV is compared byte for byte.  The refined
chain's WAV agrees with the JAX enhancer's to 2e-2 of full scale, the
tolerance of ``tests/test_torch_enhancer.py``'s CLI-vs-JAX test (the same
float32 math in another summation order, amplified by 3 EM iterations).
"""

import json
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import pb_chime5_tpu.activity_alignment as jax_aa
from pb_chime5_tpu import activity as jax_activity
from pb_chime5_tpu import mapping as jax_mapping
from pb_chime5_tpu.database.chime5 import Chime5 as JaxChime5
from pb_chime5_tpu.database.create_json import (
    create_database as jax_create_database)
from pb_chime5_tpu.io import dump_json as jax_dump_json
from pb_chime5_tpu.io import load_audio
from pb_chime5_tpu.models.enhancer import Activity as JaxActivity
from pb_chime5_tpu.models.enhancer import Enhancer as JaxEnhancer
from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig
from pb_chime5_tpu.testing import (
    create_synthetic_chime5 as jax_create_synthetic_chime5)
from pb_chime5_tpu.utils import ArrayInterval as JaxArrayInterval
from pb_chime5_tpu.utils.dict_utils import Dispatcher as JaxDispatcher
import pb_chime5_tpu_torch.activity_alignment as aa
from pb_chime5_tpu_torch import activity, mapping
from pb_chime5_tpu_torch.database.chime5 import Chime5
from pb_chime5_tpu_torch.models.enhancer import Activity, get_enhancer
from pb_chime5_tpu_torch.testing.fake_kaldi import (
    kaldi_frames, make_fake_kaldi_root, write_fake_alignment)
from pb_chime5_tpu_torch.utils import ArrayInterval, Dispatcher

torch.set_num_threads(2)

SETTINGS = dict(context_samples=8000, bss_iterations=3,
                length_buckets=(16000 * 4,))


# ------------------------------------------- the JAX tests' twins

def make_fns(monkeypatch, alignment_dict):
    """The port's and the JAX package's refining functions over the same
    (faked) phone alignment."""
    monkeypatch.setattr(aa, 'get_phone_alignment',
                        lambda *a, **k: Dispatcher(alignment_dict))
    monkeypatch.setattr(jax_aa, 'get_phone_alignment',
                        lambda *a, **k: JaxDispatcher(alignment_dict))
    return (aa.get_non_sil_alignment_fn_from_kaldi('/fake/ali/dir'),
            jax_aa.get_non_sil_alignment_fn_from_kaldi('/fake/ali/dir'))


def _example(worn, observation):
    return {'example_id': 'P05_S02_0000100-0000200', 'session_id': 'S02',
            'speaker_id': 'P05',
            'num_samples': {'worn': {'P05': worn},
                            'observation': observation}}


def test_non_sil_alignment_projection(monkeypatch):
    source_len = 4000
    T = kaldi_frames(source_len)
    labels = np.array(['sil'] * 5 + ['ae_B'] * (T - 10) + ['sil'] * 5)
    fn, jax_fn = make_fns(monkeypatch, {
        'P05_S02_KITCHEN.L-0000100-0000200': labels})
    ex = _example(source_len, {'U01': source_len + 100})
    out = fn(ex, 'P05')             # worn: the alignment's own clock
    np.testing.assert_array_equal(out, jax_fn(ex, 'P05'))
    assert out.shape == (source_len,)
    assert not out[:100].any() and out[1500:2000].all()
    out_u = fn(ex, 'U01')           # array: centre-padded to its clock
    np.testing.assert_array_equal(out_u, jax_fn(ex, 'U01'))
    assert out_u.shape == (source_len + 100,) and not out_u[:50].any()


def test_non_sil_alignment_cut(monkeypatch):
    source_len = 4000
    fn, jax_fn = make_fns(monkeypatch, {
        'P05_S02_KITCHEN.L-0000100-0000200':
            np.array(['ae_B'] * kaldi_frames(source_len))})
    ex = _example(source_len - 60, {'U01': source_len - 61})
    for mic, n in (('P05', source_len - 60), ('U01', source_len - 61)):
        out = fn(ex, mic)
        assert out.shape == (n,)
        np.testing.assert_array_equal(out, jax_fn(ex, mic))


def test_missing_alignment_returns_one(monkeypatch):
    fn, jax_fn = make_fns(monkeypatch, {})
    ex = _example(1000, {})
    assert fn(ex, 'P05') == jax_fn(ex, 'P05') == 1
    with pytest.raises(NotImplementedError):
        fn(ex, 'X01')


def test_misspelled_alias():
    assert aa.get_non_sil_alignment_fn_from_kalid is \
        aa.get_non_sil_alignment_fn_from_kaldi
    with pytest.raises(NotImplementedError):
        aa.get_non_sil_alignment_fn_from_kaldi('/x', unique_alignments=False)


def test_path_activity_cached_per_session(tmp_path):
    """``Activity(type='path')`` loads a session's pickle once: it is
    deleted after the first access."""
    pkl_dir = tmp_path / 'ann'
    pkl_dir.mkdir()
    payload = {'U01': {'P05': [True]}}
    with open(pkl_dir / 'S02.pkl', 'wb') as fd:
        pickle.dump(payload, fd)
    act = Activity(type='path', path=str(pkl_dir))
    assert act['S02'] == payload
    (pkl_dir / 'S02.pkl').unlink()
    assert act['S02'] == payload


# ------------------------------------------- the corpus and its alignment

@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """A synthetic 2-array session (made by the JAX package), its DB JSON,
    a stub Kaldi and a fake alignment of every worn utterance but the last
    (one missing alignment, as a real alignment run leaves some); the
    refining functions of both packages over it."""
    root = tmp_path_factory.mktemp('aa')
    jax_create_synthetic_chime5(
        root / 'CHiME5', session_ids=('S02',), duration_seconds=20.0,
        utterances_per_speaker=2, num_arrays=2, seed=3, pcm16=True)
    db = root / 'chime5.json'
    jax_dump_json(jax_create_database(root / 'CHiME5'), db)
    examples = list(Chime5(db).get_datasets('S02'))
    write_fake_alignment(root / 'ali', examples[:-1])
    kaldi = make_fake_kaldi_root(root / 'kaldi')
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('KALDI_ROOT', str(kaldi))
        fns = (aa.get_non_sil_alignment_fn_from_kaldi(root / 'ali'),
               jax_aa.get_non_sil_alignment_fn_from_kaldi(root / 'ali'))
    return {'root': root, 'db': db, 'kaldi': kaldi, 'fns': fns,
            'n': len(examples)}


def _outcome(fn):
    try:
        return fn(), None
    except Exception as e:            # both packages must fail alike
        return None, type(e)


def _assert_same_tracks(got, want):
    assert list(got) == list(want)
    for key in want:
        if isinstance(want[key], dict):
            _assert_same_tracks(got[key], want[key])
        elif isinstance(want[key], JaxArrayInterval):
            assert isinstance(got[key], ArrayInterval)
            assert got[key].shape == want[key].shape
            assert got[key].normalized_intervals == \
                want[key].normalized_intervals
        else:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize('perspective', ['array', 'worn', 'global_worn',
                                         ['U02', 'P06']])
@pytest.mark.parametrize('refined', [False, True])
@pytest.mark.parametrize('garbage_class', [True, None, 2])
def test_get_activity_matches_jax(corpus, perspective, refined,
                                  garbage_class):
    fn, jax_fn = corpus['fns'] if refined else (None, None)
    got, error = _outcome(lambda: activity.get_activity(
        Chime5(corpus['db']).get_datasets('S02'), perspective=perspective,
        garbage_class=garbage_class, non_sil_alignment_fn=fn))
    want, jax_error = _outcome(lambda: jax_activity.get_activity(
        JaxChime5(corpus['db']).get_datasets('S02'), perspective=perspective,
        garbage_class=garbage_class, non_sil_alignment_fn=jax_fn))
    assert error is jax_error is None
    _assert_same_tracks(got, want)
    if refined:      # the refinement removed the edges' silence
        plain = activity.get_activity(
            Chime5(corpus['db']).get_datasets('S02'),
            perspective=perspective, garbage_class=garbage_class)
        p = list(got['S02'])[0]
        assert got['S02'][p]['P05'].sum() < plain['S02'][p]['P05'].sum()


@pytest.mark.parametrize('perspective', ['array', 'worn'])
def test_dense_activity_matches_jax(corpus, monkeypatch, perspective):
    """``use_ArrayIntervall=False``: dense tracks of ``dtype``, on session
    lengths cut to the synthetic corpus's (the real S02 is 2.5 h)."""
    short = {k: 16000 * 21 for k in mapping.session_array_to_num_samples}
    monkeypatch.setattr(mapping, 'session_array_to_num_samples', short)
    monkeypatch.setattr(jax_mapping, 'session_array_to_num_samples', short)
    fn, jax_fn = corpus['fns']
    for dtype in (bool, np.float32):
        kw = dict(perspective=perspective, garbage_class=True, dtype=dtype,
                  use_ArrayIntervall=False)
        got = activity.get_activity(
            Chime5(corpus['db']).get_datasets('S02'),
            non_sil_alignment_fn=fn if dtype is bool else None, **kw)
        want = jax_activity.get_activity(
            JaxChime5(corpus['db']).get_datasets('S02'),
            non_sil_alignment_fn=jax_fn if dtype is bool else None, **kw)
        _assert_same_tracks(got, want)
    with pytest.raises(AssertionError):
        activity.get_activity(Chime5(corpus['db']).get_datasets('S02'),
                              perspective='array', garbage_class=True,
                              dtype=np.float32)


def test_mostly_missing_alignment_raises_as_jax(corpus):
    """More than half the utterances without an alignment: RuntimeError
    in both packages."""
    for get, chime5 in ((activity.get_activity, Chime5),
                        (jax_activity.get_activity, JaxChime5)):
        with pytest.raises(RuntimeError, match='missing finetuned'):
            get(chime5(corpus['db']).get_datasets('S02'),
                perspective='global_worn', garbage_class=True,
                non_sil_alignment_fn=lambda ex, mic: 1)


def test_chime6_refinement_not_implemented_as_jax(corpus):
    fn, jax_fn = corpus['fns']
    with pytest.raises(NotImplementedError):
        activity.get_activity_chime6(
            Chime5(corpus['db']).get_datasets('S02'), garbage_class=True,
            non_sil_alignment_fn=fn)
    with pytest.raises(NotImplementedError):
        jax_activity.get_activity_chime6(
            JaxChime5(corpus['db']).get_datasets('S02'), garbage_class=True,
            non_sil_alignment_fn=jax_fn)


# ------------------------------------------- the CLI and the enhancer

@pytest.fixture(scope='module')
def pickles(corpus):
    """Both packages' CLIs on the corpus with the fake alignment."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('KALDI_ROOT', str(corpus['kaldi']))
        for name, main in (('port', aa.main), ('jax', jax_aa.main)):
            out[name] = corpus['root'] / f'cache_{name}'
            main(corpus['db'], out[name], sessions=['S02'],
                 worn_ali_path=corpus['root'] / 'ali')
    return out


def _load(path):
    with open(path, 'rb') as fd:
        return pickle.load(fd)


@pytest.mark.parametrize('kind', ['annotation', 'word_non_sil_alignment'])
def test_cli_pickles_match_jax(pickles, kind):
    got = _load(pickles['port'] / kind / 'S02.pkl')
    want = _load(pickles['jax'] / kind / 'S02.pkl')
    assert isinstance(got, Dispatcher) and 'Noise' in got['U01']
    _assert_same_tracks(got, want)


LOADER = '''
import json, pickle, sys
with open(sys.argv[1], 'rb') as fd:
    data = pickle.load(fd)
loaded = {name.split('.')[0] for name in sys.modules}
assert not loaded & {'jax', 'pb_chime5_tpu'}, sorted(loaded)
print(json.dumps({array: {track: [type(ai).__module__, list(ai.shape),
                                  [list(iv) for iv in ai.intervals]]
                          for track, ai in tracks.items()}
                  for array, tracks in data.items()}))
'''


@pytest.mark.parametrize('kind', ['annotation', 'word_non_sil_alignment'])
def test_cli_pickles_load_without_jax(pickles, kind):
    proc = subprocess.run(
        [sys.executable, '-c', LOADER, str(pickles['port'] / kind / 'S02.pkl')],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout)
    want = _load(pickles['jax'] / kind / 'S02.pkl')
    assert list(got) == list(want)
    for array, tracks in want.items():
        for track, ai in tracks.items():
            assert got[array][track] == [
                'pb_chime5_tpu_torch.utils.array_interval', list(ai.shape),
                [list(iv) for iv in ai.normalized_intervals]]


def _enhance(enhancer, out, n):
    enhancer.enhance_session(['S02'], out, dataset_slice=n,
                             audio_dir_exist_ok=True)
    return sorted((out / 'dev').glob('*.wav'))


def test_path_annotation_pickles_byte_identical(corpus, pickles, tmp_path):
    """``activity_type='path'`` on the CLI's annotation pickles writes the
    same bytes as ``activity_type='annotation'``."""
    kw = dict(database_path=str(corpus['db']), multiarray=True,
              device='cpu', wpe=False, bss_iterations=2,
              context_samples=8000, length_buckets=(16000 * 4,))
    want = _enhance(get_enhancer(**kw), tmp_path / 'annotation', 2)
    got = _enhance(get_enhancer(
        activity_type='path',
        activity_path=str(pickles['port'] / 'annotation'), **kw),
        tmp_path / 'path', 2)
    assert [w.name for w in got] == [w.name for w in want] and len(got) == 2
    for a, b in zip(got, want):
        assert a.read_bytes() == b.read_bytes(), a.name


def test_refined_chain_matches_jax(corpus, pickles, tmp_path):
    """The refined activity through both enhancers (the JAX one with its
    fused kernel EM in interpret mode): WAVs within 2e-2 of full scale,
    and other than the annotation chain's."""
    refined = 'word_non_sil_alignment'
    port = get_enhancer(
        database_path=str(corpus['db']), multiarray=True, device='cpu',
        activity_type='path', activity_path=str(pickles['port'] / refined),
        device_audio_cache=False, **SETTINGS)
    got, = _enhance(port, tmp_path / 'port', 1)
    jax_enhancer = JaxEnhancer(
        activity=JaxActivity(type='path', path=str(pickles['jax'] / refined),
                             garbage_class=True,
                             database_path=str(corpus['db'])),
        gss_config=JaxGssConfig(bss_iterations=3, bss_em_backend='pallas'),
        context_samples=SETTINGS['context_samples'], multiarray=True,
        length_buckets=SETTINGS['length_buckets'], device_audio_cache=False)
    jax_enhancer.enhance_session(['S02'], tmp_path / 'jax', dataset_slice=1)
    x, want = load_audio(got), load_audio(tmp_path / 'jax' / 'dev' / got.name)
    assert x.shape == want.shape
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    np.testing.assert_allclose(x, want, atol=2e-2)

    plain, = _enhance(get_enhancer(
        database_path=str(corpus['db']), multiarray=True, device='cpu',
        device_audio_cache=False, **SETTINGS), tmp_path / 'plain', 1)
    assert plain.name == got.name
    assert np.abs(load_audio(plain) - x).max() > 1e-3
