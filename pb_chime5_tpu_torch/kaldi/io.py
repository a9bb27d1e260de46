"""Kaldi text-format I/O: words.txt maps, keyed text files, WER parsers —
the port of ``pb_chime5_tpu/kaldi/io.py`` (reference pb_chime5/kaldi/io.py)."""

import ast
import re
from pathlib import Path

from pb_chime5_tpu_torch.utils.dict_utils import Dispatcher

__all__ = ['word2id', 'id2word', 'read_keyed_text_file',
           'write_keyed_text_file', 'parse_kaldi_wer_file']


def word2id(words_txt):
    with open(words_txt) as fid:
        return {
            line.strip().split(' ')[0]: int(line.split(' ')[1])
            for line in fid if len(line.split(' ')) == 2
        }


def id2word(words_txt):
    with open(words_txt) as fid:
        return {
            int(line.strip().split(' ')[1]): line.split(' ')[0]
            for line in fid if len(line.split(' ')) == 2
        }


def read_keyed_text_file(text_file, to_list=True):
    """Read Kaldi 'text' / 'wav.scp' / 'spk2utt' style files."""
    text_file = Path(text_file).expanduser().resolve()
    with text_file.open() as f:
        if to_list:
            return {line.strip().split()[0]: line.strip().split()[1:]
                    for line in f}
        return {line.strip().split()[0]:
                line.split(' ', maxsplit=1)[1].strip()
                for line in f.readlines()}


def write_keyed_text_file(text_file, data_dict):
    """Write a keyed text file sorted by utterance id, with the reference's
    sanity checks for utt2dur (numeric, sane range) and spk2gender
    (normalized to m/f) (reference io.py:49-86)."""
    text_file = Path(text_file)
    data = []
    for k, text in sorted(data_dict.items()):
        if isinstance(text, list):
            text = ' '.join(map(str, text))
        if text_file.name == 'utt2dur':
            try:
                number = float(text)
            except Exception:
                raise ValueError(
                    f'The text "{text}" for {k} that should be written to '
                    f'{text_file} does not represent a number.')
            assert 0. < number < 1000., \
                f'Strange duration: {k}: {number} s'
        elif text_file.name == 'spk2gender':
            text = Dispatcher(male='m', female='f', m='m', f='f')[text]
        data.append(f'{k} {text}')
    text_file.write_text('\n'.join(data))


_BEST_WER_RE = re.compile(
    r'%WER (?P<wer>\d*\.\d*) \[ (?P<word_errors>\d*) '
    r'/ (?P<words>\d*), (?P<ins>\d*) ins, '
    r'(?P<del>\d*) del, (?P<sub>\d*) sub ]'
    r' ?(?P<flags>[^\n]*) (?P<file>[^\n]+)')

_WER_FILE_RE = re.compile(
    r'%WER (?P<wer>\d*\.\d*) \[ (?P<word_errors>\d*) '
    r'/ (?P<words>\d*), (?P<ins>\d*) ins, '
    r'(?P<del>\d*) del, (?P<sub>\d*) sub ]'
    r' ?(?P<flags>[^\n]*)\n%SER '
    r'(?P<ser>\d*\.\d*) \[ (?P<sentence_errors>\d*) '
    r'/ (?P<sentences>\d*) ]\n'
    r'Scored \d+ sentences, (?P<missing>\d*) not present in hyp.')


def _literal(match: dict):
    for k in match:
        try:
            match[k] = ast.literal_eval(match[k])
        except (SyntaxError, ValueError):
            pass
    return match


def _parse_kaldi_best_wer_text(text):
    return _literal(_BEST_WER_RE.search(text.strip()).groupdict())


def parse_kaldi_wer_file(path, *, allow_best_wer=False,
                         ignore_missing=False):
    """Parse a compute-wer output file (or a scoring_kaldi/best_wer
    pointer file, which contains the path of the real wer file)."""
    content = Path(path).read_text()
    if len(content.strip().split('\n')) == 1:
        if allow_best_wer:
            return _parse_kaldi_best_wer_text(content)
        content = Path(
            content.split(']', maxsplit=1)[-1].strip()).read_text()
    match = _literal(_WER_FILE_RE.search(content).groupdict())
    if not ignore_missing and match['missing']:
        raise RuntimeError(match)
    return match
