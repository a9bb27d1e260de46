"""Transcription word->int mapping via Kaldi sym2int.pl — the port of
``pb_chime5_tpu/kaldi/transcription.py`` (reference
pb_chime5/kaldi/transcription.py)."""

import logging
from pathlib import Path

from pb_chime5_tpu_torch.kaldi import helper as kaldi_helper

LOG = logging.getLogger('Kaldi')

__all__ = ['write_transcription_file']


def write_transcription_file(
        out_of_vocabulary_mapping_file: Path,
        word_mapping_file: Path,
        word_transcription_file: Path,
        mapped_transcription_file: Path,
):
    """Map a word transcription file to integer ids with OOV handling
    ('011c0201 THE SALE ...' -> '011c0201 110920 96431 ...')."""
    sym2int = (kaldi_helper.kaldi_root() / 'egs' / 'wsj' / 's5' / 'utils'
               / 'sym2int.pl')
    for file in (sym2int, out_of_vocabulary_mapping_file,
                 word_mapping_file, word_transcription_file):
        assert Path(file).is_file(), file
    assert Path(mapped_transcription_file).parent.is_dir(), \
        mapped_transcription_file

    oov = Path(out_of_vocabulary_mapping_file).read_text().strip()
    command = (
        f'{Path(sym2int).resolve()} --map-oov {oov} -f 2- '
        f'{Path(word_mapping_file).resolve()} '
        f'{Path(word_transcription_file).resolve()} '
        f'> {Path(mapped_transcription_file).resolve()}'
    )
    _, stderrs, _ = kaldi_helper.execute_kaldi_commands(command)
    for line in stderrs[0].split('\n'):
        LOG.info(line)
