"""The port's NumPy host modules against the JAX package's: the twins of
tests/test_utils_misc.py from ``morph`` through ``stable_solve``, the
iterator transforms and ``limit_audio_length``, the cross-talk builder,
``overlap_statistics``, ``plot_activity``, ``stack_context``, the complex
split and merge and ``add_context``; plus ``database/helper.py``.  Each
runs through both packages on the same seeded inputs; exact host
computations are compared exactly.
"""

import numpy as np
import pytest

from pb_chime5_tpu import math as jax_math, visualization as jax_vis
from pb_chime5_tpu.database import (
    get_speaker_activity as jax_gsa, helper as jax_helper,
    iterator as jax_iterator)
from pb_chime5_tpu.utils import numpy_utils as jax_nu
from pb_chime5_tpu_torch import math as port_math, visualization as vis
from pb_chime5_tpu_torch.database import (
    get_speaker_activity as gsa, helper, iterator)
from pb_chime5_tpu_torch.utils import numpy_utils as nu


def same(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            same(got[k], want[k])
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ morph

@pytest.mark.parametrize('pattern,shape,kw', [
    ('ACTF->A*CTF', (2, 3, 4, 5), {}),
    ('A*CTF->ACTF', (6, 4, 5), {'A': 2}),
    ('DTF->FT', (3, 4, 5), {'reduce': np.median}),
    ('TF->FT', (4, 5), {}),
    ('1DTF->FDT', (1, 3, 4, 5), {}),
    ('1DTF->FT', (1, 3, 4, 5), {'reduce': np.median}),
    ('ab*c->cab', (2, 12), {'b': 3}),
])
def test_morph_matches_jax(pattern, shape, kw):
    x = np.random.default_rng(0).random(shape)
    same(nu.morph(pattern, x, **kw), jax_nu.morph(pattern, x, **kw))


def test_morph_requires_reduce():
    for mod in (nu, jax_nu):
        with pytest.raises(AssertionError, match='reduce'):
            mod.morph('DT->T', np.zeros((2, 3)))


# ------------------------------------------------------- numpy utilities

def test_numpy_utilities_match_jax():
    x = np.random.default_rng(1).random((2, 3))
    for pad, axis in (((1, 2), -1), (1, 0)):
        same(nu.pad_axis(x, pad, axis=axis), jax_nu.pad_axis(x, pad,
                                                              axis=axis))
    a = np.arange(1, 9).reshape(2, 4)
    for shift in (2, -1, 0, 5):
        for axis in (0, 1, None):
            same(nu.roll_zeropad(a, shift, axis=axis),
                 jax_nu.roll_zeropad(a, shift, axis=axis))
    labels = np.array([0, 2, 1])
    for axis in (0, -1):
        same(nu.labels_to_one_hot(labels, 3, axis=axis),
             jax_nu.labels_to_one_hot(labels, 3, axis=axis))
    mask = np.random.default_rng(2).random((4, 10))
    for kw in ({'low_cut': 2, 'high_cut': 8}, {'low_cut': 0},
               {'high_cut': 5}):
        same(nu.Cutter(**kw)(mask), jax_nu.Cutter(**kw)(mask))
        same(nu.Cutter(**kw).overwrite(mask, 0.5),
             jax_nu.Cutter(**kw).overwrite(mask, 0.5))


def test_stable_solve_matches_jax():
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 3, 3))
    A[1] = 0.0                                      # singular: lstsq
    B = rng.standard_normal((4, 3, 2))
    X = port_math.stable_solve(A, B)
    same(X, jax_math.stable_solve(A, B))
    np.testing.assert_allclose(A[0] @ X[0], B[0], atol=1e-10)
    same(port_math.stable_solve(A[0], B[0]), jax_math.stable_solve(A[0],
                                                                   B[0]))


# ------------------------------------------------- iterator transforms

def test_iterator_transforms_match_jax():
    assert iterator.IdFilter(['a'])({'example_id': 'a'})
    assert not iterator.IdFilter(['a'])({'example_id': 'b'})
    w2id = {'hello': 1, 'world': 2, 'x': 3}.__getitem__
    ex = {'example_id': 'x', 'transcription': 'hello world',
          'kaldi_transcription': ['x hello', 'world']}
    same(iterator.Word2Id(w2id)(dict(ex))['kaldi_transcription_ids'][0],
         jax_iterator.Word2Id(w2id)(dict(ex))['kaldi_transcription_ids'][0])
    same(iterator.Word2Id(w2id)(dict(ex))['transcription_ids'],
         np.array([1, 2], np.int32))
    with pytest.raises(ValueError):
        iterator.Word2Id(w2id)({'example_id': 'y'})
    for example in ({'example_id': 'y', 'num_samples': 5},
                    {'example_id': 'y', 'num_samples': 0},
                    {'example_id': 'y', 'num_samples': {'observation': 0}},
                    {'example_id': 'y',
                     'audio_data': {'observation': np.zeros(3)}}):
        assert iterator.remove_zero_length_example(example) == \
            jax_iterator.remove_zero_length_example(example)
    tree = {'a': [1, 2], 'b': {'c': 3}}
    fn = lambda v: v * 10   # noqa: E731
    same(iterator.recursive_transform(fn, tree, list2array=True),
         jax_iterator.recursive_transform(fn, tree, list2array=True))
    assert iterator.to_list('a') == jax_iterator.to_list('a') == ['a']


def test_audio_reader_matches_jax(tmp_path):
    from pb_chime5_tpu_torch.io import dump_audio
    rng = np.random.default_rng(4)
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f'{i}.wav'))
        dump_audio(rng.integers(-99, 99, 50).astype(np.int16), paths[-1],
                   normalize=False)
    ex = {'audio_path': {'observation': paths[:2], 'worn': paths[2]}}
    for kw in ({}, {'audio_keys': None}, {'audio_keys': ['worn'],
                                          'dst_key': None}):
        got = iterator.AudioReader(**kw)(dict(ex))
        want = jax_iterator.AudioReader(**kw)(dict(ex))
        key = 'audio_data' if kw.get('dst_key', 1) else 'worn'
        same(got[key], want[key])


@pytest.mark.parametrize('alignment', [None, 'full', 'lfr'])
def test_limit_audio_length_matches_jax(alignment):
    def example():
        ex = {'example_id': 'z', 'num_samples': 5000,
              'audio_data': {'observation': np.arange(10000.).reshape(2,
                                                                      5000)}}
        if alignment:
            frames = (5000 - 400 + 160) // 160
            n = frames if alignment == 'full' else (frames + 2) // 3
            ex['alignment'] = np.arange(n)
        return ex
    np.random.seed(7)
    got = iterator.LimitAudioLength(max_lengths=400)(example())
    np.random.seed(7)
    want = jax_iterator.LimitAudioLength(max_lengths=400)(example())
    assert got['num_samples'] == want['num_samples'] == 400
    same(got['audio_data'], want['audio_data'])
    assert got['audio_data']['observation'].shape == (2, 400)
    if alignment:
        same(got['alignment'], want['alignment'])
        assert got['num_alignment_frames'] == want['num_alignment_frames']
    short = {'example_id': 's', 'num_samples': 10}
    assert iterator.LimitAudioLength(400)(dict(short)) == short


# ------------------------------------------------- cross-talk builder

def test_cross_talk_builder_matches_jax(tmp_path):
    from pb_chime5_tpu.testing import create_synthetic_chime5
    from pb_chime5_tpu_torch.io import load_json
    create_synthetic_chime5(tmp_path / 'c', session_ids=('S02',),
                            duration_seconds=12.0,
                            utterances_per_speaker=2, seed=1)
    gsa.create_cross_talk_database(tmp_path / 'c', tmp_path / 'port',
                                   datasets=('dev',))
    jax_gsa.create_cross_talk_database(tmp_path / 'c', tmp_path / 'jax',
                                       datasets=('dev',))
    data = load_json(tmp_path / 'port' / 'S02.json')
    assert data == load_json(tmp_path / 'jax' / 'S02.json')
    assert set(data) == {'P05', 'P06', 'P07', 'P08', 'cross_talk'}
    for step in (1, 4):
        got = gsa.get_active_speaker(0, 16000, 'S02', 'P05',
                                     json_path=tmp_path / 'port',
                                     sample_step=step)
        want = jax_gsa.get_active_speaker(0, 16000, 'S02', 'P05',
                                          json_path=tmp_path / 'jax',
                                          sample_step=step)
        same(got, want)
    gsa.main(['--database-path', str(tmp_path / 'c'), '--json-path',
              str(tmp_path / 'cli'), '--datasets', 'dev'])
    assert load_json(tmp_path / 'cli' / 'S02.json') == data


# --------------------------------------------------------- db helpers

def test_database_helpers_match_jax(tmp_path):
    tree = {'audio_path': {'a': ['x.wav', 'y.wav'], 'b': 'z.wav'}, 'n': 3}
    assert helper.flatten_with_key_paths(tree) == \
        jax_helper.flatten_with_key_paths(tree)
    with pytest.raises(AssertionError, match='missing audio files'):
        helper.check_audio_files_exist(tree)
    (tmp_path / 'x.wav').write_bytes(b'')
    ok = {'audio_path': {'a': [str(tmp_path / 'x.wav')]}}
    helper.check_audio_files_exist(ok)
    helper.check_audio_files_exist(ok, speedup=None)
    helper.dump_database_as_json(tmp_path / 'p.json', tree)
    jax_helper.dump_database_as_json(tmp_path / 'j.json', tree)
    assert (tmp_path / 'p.json').read_text() == \
        (tmp_path / 'j.json').read_text()


# ------------------------------------------------------ visualization

def activity_tracks(kind):
    rng = np.random.default_rng(5)
    dense = {f'P0{i}': rng.random(64000) < 0.5 for i in range(1, 4)}
    dense['noise'] = np.ones(64000, bool)
    if kind == 'dense':
        return dense
    from pb_chime5_tpu.utils import ArrayInterval
    from pb_chime5_tpu_torch.utils import ArrayInterval as PortInterval
    cls = PortInterval if kind == 'port' else ArrayInterval
    out = {}
    for name, track in dense.items():
        ai = cls(64000)
        ai[1000:17000] = 1
        ai[30000:30000 + 600 * int(track[:50].sum())] = 1
        out[name] = ai
    return out


@pytest.mark.parametrize('kind', ['dense', 'intervals'])
@pytest.mark.parametrize('chunk', [16000, 4000])
def test_overlap_statistics_matches_jax(kind, chunk):
    port_tracks = activity_tracks('dense' if kind == 'dense' else 'port')
    jax_tracks = activity_tracks('dense' if kind == 'dense' else 'jax')
    got = vis.overlap_statistics(port_tracks, chunk=chunk)
    assert got == jax_vis.overlap_statistics(jax_tracks, chunk=chunk)
    two = {'P01': np.r_[np.ones(32000, bool), np.zeros(32000, bool)],
           'P02': np.r_[np.zeros(16000, bool), np.ones(32000, bool),
                        np.zeros(16000, bool)]}
    stats = vis.overlap_statistics(two)
    assert stats['chunks'] == 4 and stats['overlap'] == 0.25


def test_plot_activity_matches_jax():
    matplotlib = pytest.importorskip('matplotlib')
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    bars = {}
    for name, mod, kind in (('port', vis, 'port'), ('jax', jax_vis, 'jax')):
        ax = mod.plot_activity(activity_tracks(kind), resolution=4000)
        bars[name] = [(p.get_x(), p.get_y(), p.get_width())
                      for p in ax.patches]
        labels = [t.get_text() for t in ax.get_yticklabels()]
        plt.close(ax.figure)
    assert bars['port'] == bars['jax'] and len(bars['port']) > 0
    assert labels == ['P01', 'P02', 'P03', 'noise']


# ------------------------------------------------------------ contexts

@pytest.mark.parametrize('left,right,step', [(1, 1, 1), (2, 0, 1),
                                             (0, 3, 2), (1, 2, 3)])
def test_stack_context_matches_jax(left, right, step):
    T, B, F = 7, 2, 3
    X = np.random.default_rng(6).random((T, B, F))
    S = nu.stack_context(X, left, right, step)
    same(S, jax_nu.stack_context(X, left, right, step))
    same(nu.unstack_context(S, 'center', left, right),
         jax_nu.unstack_context(S, 'center', left, right))
    with pytest.raises(NotImplementedError):
        nu.unstack_context(S, 'overlap', left, right)
    same(nu.tbf_to_tbchw(X, left, right, step),
         jax_nu.tbf_to_tbchw(X, left, right, step))
    same(nu.tbf_to_tbchw(X, left, right, step, pad_mode='constant'),
         jax_nu.tbf_to_tbchw(X, left, right, step, pad_mode='constant'))


def test_split_merge_complex_features_match_jax():
    rng = np.random.default_rng(0)
    X = rng.standard_normal((3, 2, 5)) + 1j * rng.standard_normal((3, 2, 5))
    S = nu.split_complex_features(X)
    same(S, jax_nu.split_complex_features(X))
    same(nu.merge_complex_features(S), jax_nu.merge_complex_features(S))
    same(nu.merge_complex_features(S), X)


@pytest.mark.parametrize('kw', [
    {}, {'sequence_output': False}, {'cnn_features': True},
    {'cnn_features': True, 'deltas_as_channel': True, 'num_deltas': 2},
    {'step': 2}, {'cnn_features': True, 'sequence_output': False}])
def test_add_context_matches_jax(kw):
    T, B, F = 5, 2, 6
    X = np.arange(T * B * F, dtype=float).reshape(T, B, F)
    same(nu.add_context(X, 1, 1, **kw), jax_nu.add_context(X, 1, 1, **kw))
