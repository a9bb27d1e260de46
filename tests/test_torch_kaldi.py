"""The port's Kaldi bridge (``pb_chime5_tpu_torch.kaldi``, the Kaldi ids
of ``database/chime5.py``, ``utils/alignment.py``,
``utils/process_caller.py``) against the JAX package's, with no Kaldi
installed: ``testing/fake_kaldi.py`` writes a ``KALDI_ROOT`` of stub
tools that speak the real ones' protocol (the fixture of
``tests/test_kaldi_golden.py``), and both bridges run on the same stubs.

Twins of ``tests/test_kaldi_golden.py`` and of the Kaldi tests of
``tests/test_utils_misc.py``.  Everything here is text, integers and
label arrays: every comparison is exact.
"""

import gzip
import os
import pickle
import shutil
import subprocess

import numpy as np
import pytest

from pb_chime5_tpu.database import chime5 as jax_chime5
from pb_chime5_tpu.kaldi import alignment as jax_alignment
from pb_chime5_tpu.kaldi import decode as jax_decode
from pb_chime5_tpu.kaldi import fst as jax_fst
from pb_chime5_tpu.kaldi import helper as jax_helper
from pb_chime5_tpu.kaldi import io as jax_kio
from pb_chime5_tpu.utils import alignment as jax_ualign
from pb_chime5_tpu.utils.process_caller import run_process as jax_run
from pb_chime5_tpu_torch.database import chime5
from pb_chime5_tpu_torch.kaldi import alignment, decode, fst, helper
from pb_chime5_tpu_torch.kaldi import io as kio
from pb_chime5_tpu_torch.testing.fake_kaldi import (
    make_fake_kaldi_root, write_fake_alignment)
from pb_chime5_tpu_torch.utils import alignment as ualign
from pb_chime5_tpu_torch.utils.process_caller import run_process


@pytest.fixture
def kaldi_root(tmp_path, monkeypatch):
    root = make_fake_kaldi_root(tmp_path / 'kaldi')
    monkeypatch.setenv('KALDI_ROOT', str(root))
    return root


def _ali_dir(tmp_path, files, model='final.alimdl'):
    ali_dir = tmp_path / 'ali'
    ali_dir.mkdir()
    for name, text in files.items():
        with gzip.open(ali_dir / name, 'wt') as fd:
            fd.write(text)
    (ali_dir / model).write_text('fake model\n')
    return ali_dir


def _same(got, want):
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


def test_import_alignment_data_golden(kaldi_root, tmp_path):
    ali_dir = _ali_dir(tmp_path, {'ali.1.gz': 'utt1 1 2 7 8 13\n',
                                  'ali.2.gz': 'utt2 1 1 2\n'})
    pdf = alignment.import_alignment_data(ali_dir)
    np.testing.assert_array_equal(pdf['utt1'], [0, 0, 2, 2, 4])
    np.testing.assert_array_equal(pdf['utt2'], [0, 0, 0])
    _same(pdf, jax_alignment.import_alignment_data(ali_dir))

    for per_frame, golden in ((True, ([1, 1, 2, 2, 3], [1, 1, 1])),
                              (False, ([1, 2, 3], [1]))):
        got = alignment.import_alignment_data(
            ali_dir, import_fn=alignment.import_phone_alignment_from_file,
            per_frame=per_frame)
        np.testing.assert_array_equal(got['utt1'], golden[0])
        np.testing.assert_array_equal(got['utt2'], golden[1])
        _same(got, jax_alignment.import_alignment_data(
            ali_dir,
            import_fn=jax_alignment.import_phone_alignment_from_file,
            per_frame=per_frame))


@pytest.mark.parametrize('bridge', ['port', 'jax'])
def test_import_alignment_count_mismatch_raises(kaldi_root, tmp_path,
                                                bridge):
    # the stub reports one utterance too many: the bridge's stderr count
    # cross-check must notice
    tool = kaldi_root / 'src/bin/ali-to-pdf'
    tool.write_text(tool.read_text().replace('{n} alignments',
                                             '{n + 1} alignments'))
    ali_dir = _ali_dir(tmp_path, {'ali.1.gz': 'utt1 1 2\n'})
    module = alignment if bridge == 'port' else jax_alignment
    with pytest.raises(AssertionError):
        module.import_alignment_data(ali_dir)


def _decode_tree(root):
    decode_dir, hclg_dir = root / 'decode', root / 'hclg'
    (decode_dir / 'lats').mkdir(parents=True)
    hclg_dir.mkdir()
    (hclg_dir / 'words.txt').write_text(
        'a 1\nb 2\nc 3\nd 4\ne 5\nf 6\ng 7\n<UNK> 8\n')
    (root / 'ref.txt').write_text('utt1 a b c d\nutt2 e f\n')
    # acoustic arm: utt1 perfect, utt2 one sub -> 1/6 errors;
    # LM arm: utt1 one sub + one del, utt2 perfect -> 2/6 errors
    (decode_dir / 'lats' / 'utt1.lat').write_text('utt1 1 2 3 4 | 1 2 7\n')
    (decode_dir / 'lats' / 'utt2.lat').write_text('utt2 5 7 | 5 6\n')
    return decode_dir, hclg_dir, root / 'ref.txt'


def test_compute_scores_golden(kaldi_root, tmp_path):
    results = {}
    for name, module in (('port', decode), ('jax', jax_decode)):
        decode_dir, hclg_dir, ref = _decode_tree(tmp_path / name)
        result = module.compute_scores(decode_dir, hclg_dir, ref,
                                       min_lmwt=8, max_lmwt=12,
                                       ignore_return_codes=False)
        with open(decode_dir / 'result.pkl', 'rb') as fd:
            assert len(pickle.load(fd)['wer']) == 5
        assert module.parse_wer_file(decode_dir / 'wer_8')[0] == 16.67
        # a re-run finds every tra file complete: no rescale, same result
        again = module.compute_scores(decode_dir, hclg_dir, ref,
                                      min_lmwt=8, max_lmwt=12,
                                      ignore_return_codes=False)
        assert again['wer'] == result['wer']
        results[name] = {k: v for k, v in result.items()
                         if k != 'decode_dir'}
    got = results['port']
    assert got == results['jax']
    assert got['lmwt'] == [8, 9, 10, 11, 12]
    np.testing.assert_allclose(got['wer'],
                               [16.67, 16.67, 16.67, 33.33, 33.33])
    assert got['errors'] == [1, 1, 1, 2, 2]
    assert got['del'] == [0, 0, 0, 1, 1]
    assert got['sub'] == [1] * 5 and got['ins'] == [0] * 5
    assert got['words'] == [6] * 5


def test_get_phone_alignment_matches_jax(kaldi_root, tmp_path):
    """The whole read of an alignment directory (phones.txt, the
    per-frame phones, the channel merge, the label table) on
    ``write_fake_alignment``'s directory."""
    examples = [
        {'example_id': 'P05_S02_0000100-0000300',
         'num_samples': {'worn': {'P05': 32000}}},
        {'example_id': 'P06_S02_0000200-0000250',
         'num_samples': {'worn': {'P06': 8000}}},
    ]
    phones = write_fake_alignment(tmp_path / 'ali', examples)
    for use_kaldi_id in (False, True):
        got = ualign.get_phone_alignment(tmp_path / 'ali',
                                         use_kaldi_id=use_kaldi_id)
        want = jax_ualign.get_phone_alignment(tmp_path / 'ali',
                                              use_kaldi_id=use_kaldi_id)
        _same(got, want)
    kaldi_id = 'P05_S02_KITCHEN.L-0000100-0000300'
    labels = np.array(['', 'sil', 'ae_B'])[phones[kaldi_id]]
    np.testing.assert_array_equal(
        ualign.get_phone_alignment(tmp_path / 'ali', use_kaldi_id=True)[
            kaldi_id], labels)
    assert (labels == 'sil').sum() == 2 * round(0.1 * len(labels))


@pytest.mark.parametrize('line', [
    '%WER 60.89 [ 35000 / 58881, 2518 ins, 22449 del, 10033 sub ]',
    'no wer here'])
def test_parse_wer_lines(line):
    got = decode._parse_wer_lines([line])
    want = jax_decode._parse_wer_lines([line])
    np.testing.assert_equal(got, want)
    if line.startswith('%WER'):
        assert got == (60.89, 35000, 58881, 2518, 22449, 10033)
    else:
        assert np.isnan(got[0])


def test_parse_kaldi_wer_file(tmp_path):
    f = tmp_path / 'wer_15'
    f.write_text(
        'compute-wer --text --mode=present ark:test ark,p:-\n'
        '%WER 45.11 [ 1830 / 4057, 36 ins, 638 del, 1156 sub ]\n'
        '%SER 97.57 [ 241 / 247 ]\n'
        'Scored 247 sentences, 0 not present in hyp.\n')
    got = kio.parse_kaldi_wer_file(f)
    assert got == jax_kio.parse_kaldi_wer_file(f)
    assert (got['wer'], got['word_errors'], got['ser'], got['missing']) \
        == (45.11, 1830, 97.57, 0)
    # a best_wer pointer file names the real wer file
    pointer = tmp_path / 'best_wer'
    pointer.write_text(f'%WER 45.11 [ 1830 / 4057, 36 ins, 638 del, '
                       f'1156 sub ] {f}\n')
    assert kio.parse_kaldi_wer_file(pointer) == got
    assert kio.parse_kaldi_wer_file(pointer, allow_best_wer=True) == \
        jax_kio.parse_kaldi_wer_file(pointer, allow_best_wer=True)


def test_parse_best_wer_text():
    text = ('%WER 72.78 [ 42853 / 58881, 2518 ins, 22449 del, 17886 sub ] '
            '/some/decode/dir/wer_8_0.5')
    got = kio._parse_kaldi_best_wer_text(text)
    assert got == jax_kio._parse_kaldi_best_wer_text(text)
    assert got['wer'] == 72.78 and got['file'] == '/some/decode/dir/wer_8_0.5'


def test_keyed_text_file(tmp_path):
    for name, module in (('port', kio), ('jax', jax_kio)):
        d = tmp_path / name
        d.mkdir()
        module.write_keyed_text_file(d / 'text', {'utt2': ['b', 'c'],
                                                  'utt1': 'a'})
        module.write_keyed_text_file(d / 'spk2gender', {'s': 'female'})
        module.write_keyed_text_file(d / 'utt2dur', {'u': '1.5'})
        with pytest.raises(ValueError):
            module.write_keyed_text_file(d / 'utt2dur', {'u': 'abc'})
        with pytest.raises(AssertionError):
            module.write_keyed_text_file(d / 'utt2dur', {'u': '5000'})
        (d / 'words.txt').write_text('<eps> 0\nhello 1\nworld 2')
    for name in ('text', 'spk2gender', 'utt2dur'):
        assert (tmp_path / 'port' / name).read_text() == \
            (tmp_path / 'jax' / name).read_text()
    assert (tmp_path / 'port' / 'text').read_text() == 'utt1 a\nutt2 b c'
    f = tmp_path / 'port' / 'text'
    for to_list in (True, False):
        assert kio.read_keyed_text_file(f, to_list=to_list) == \
            jax_kio.read_keyed_text_file(f, to_list=to_list)
    w = tmp_path / 'port' / 'words.txt'
    assert kio.word2id(w) == jax_kio.word2id(w) == {'hello': 1, 'world': 2,
                                                    '<eps>': 0}
    assert kio.id2word(w) == jax_kio.id2word(w)


@pytest.mark.parametrize('symbols,weight', [([3, 7], None), ([3, 7, 7], None),
                                            ([], None), ([5], 0.5)])
def test_fst_linear_acceptor(symbols, weight):
    got = fst.linear_acceptor_text(symbols, weight=weight)
    assert got == jax_fst.linear_acceptor_text(symbols, weight=weight)
    if symbols == [3, 7]:
        assert got == '0 1 3 3\n1 2 7 7\n2'


@pytest.mark.parametrize('kw', [{}, dict(isymbols='w.txt', osymbols='p.txt'),
                                dict(determinize=True, minimize=True)])
def test_fst_compile_command(kw):
    assert fst.build_fst_compile_command('a.txt', 'a.fst', **kw) == \
        jax_fst.build_fst_compile_command('a.txt', 'a.fst', **kw)


ALIGNMENTS = {
    'P28_S09_LIVING.R-0714562-0714764': [1],
    'P28_S09_LIVING.L-0714562-0714764': [2],
    'P09_S03_NOLOCATION.L-0007974-0008116': [3],
    'P09_S03_NOLOCATION.R-0008255-0008300': [4],
}


@pytest.mark.parametrize('kw', [
    dict(channel_preference=['R', 'L']),
    dict(channel_preference=['L', 'R']),
    dict(channel_preference=['L', 'R'], use_kaldi_id=True),
    dict(channel_preference=None, use_kaldi_id=True, unique_per_utt=False),
])
def test_alignment_helper_golden(kw):
    got = ualign._helper(ALIGNMENTS, **kw)
    assert got == jax_ualign._helper(ALIGNMENTS, **kw)
    if kw == dict(channel_preference=['R', 'L']):
        assert got == {'P09_S03_0007974-0008116': [3],
                       'P09_S03_0008255-0008300': [4],
                       'P28_S09_0714562-0714764': [1]}


@pytest.mark.parametrize('kw,match', [
    (dict(channel_preference=['L']), 'Expect channels'),
    (dict(channel_preference=None, use_kaldi_id=True), None)])
def test_alignment_helper_raises(kw, match):
    for helper_fn in (ualign._helper, jax_ualign._helper):
        with pytest.raises(AssertionError, match=match):
            helper_fn(ALIGNMENTS, **kw)


def test_alignment_id2phone():
    ali = {'utt1': np.array([1, 1, 2], np.int32),
           'utt2': np.array([3, 0], np.int32)}
    table = {1: 'sil', 2: 'ae_B', 3: 'b_E'}
    got = ualign.alignment_id2phone(ali, table)
    _same(got, jax_ualign.alignment_id2phone(ali, table))
    np.testing.assert_array_equal(got['utt1'], ['sil', 'sil', 'ae_B'])


@pytest.mark.parametrize('name', ['kaldi_to_nt_example_id',
                                  'kaldi_id_to_parts', 'kaldi_id_to_channel'])
@pytest.mark.parametrize('kaldi_id', [
    'P28_S09_LIVING.R-0714562-0714764', 'P05_S02_U01_KITCHEN.L-0000001-0000002',
    'P09_S03_NOLOCATION.L-0007974-0008116', 'not-a-kaldi-id'])
def test_kaldi_ids_match_jax(name, kaldi_id):
    port, jax = getattr(chime5, name), getattr(jax_chime5, name)
    try:
        want = jax(kaldi_id)
    except (ValueError, NotImplementedError) as e:
        with pytest.raises(type(e)):
            port(kaldi_id)
        return
    assert port(kaldi_id) == want


def test_run_process_matches_jax(tmp_path):
    for cmd in ('echo out; echo err >&2', ['echo', 'a b']):
        got, want = run_process(cmd), jax_run(cmd)
        assert (got.stdout, got.stderr, got.returncode) == \
            (want.stdout, want.stderr, want.returncode)
    messages = []
    for fn in (run_process, jax_run):
        with pytest.raises(subprocess.CalledProcessError) as e:
            fn('echo visible; echo trouble >&2; exit 3')
        assert e.value.returncode == 3
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert 'visible' in messages[0] and 'trouble' in messages[0]


def test_kaldi_env_matches_jax(kaldi_root, monkeypatch):
    monkeypatch.setenv('LD_LIBRARY_PATH', '/x')
    assert helper.get_kaldi_env() == jax_helper.get_kaldi_env()
    assert helper.INT2SYM() == jax_helper.INT2SYM()
    out, err, codes = helper.execute_kaldi_commands(
        ['pwd', 'echo oops >&2; exit 4'], ignore_return_code=True)
    assert out[0].strip() == os.path.realpath(kaldi_root / 'egs/wsj/s5')
    assert err[1] == 'oops\n' and codes == [0, 4]
    with pytest.raises(ValueError, match='Kaldi error'):
        helper.execute_kaldi_commands('exit 1', name='failing')


def test_without_kaldi_root_raises_as_jax(tmp_path, monkeypatch):
    monkeypatch.delenv('KALDI_ROOT', raising=False)
    ali_dir = _ali_dir(tmp_path, {'ali.1.gz': 'utt1 1 2\n'})
    for module, h in ((alignment, helper), (jax_alignment, jax_helper)):
        with pytest.raises(EnvironmentError, match='KALDI_ROOT'):
            h.kaldi_root()
        with pytest.raises(EnvironmentError, match='KALDI_ROOT'):
            module.import_alignment_data(ali_dir)
    assert shutil.which('ali-to-pdf') is None    # no fallback to PATH
