"""Kaldi alignment import / forced alignment — the port of
``pb_chime5_tpu/kaldi/alignment.py`` (reference pb_chime5/kaldi/alignment.py).

Alignments are read by piping the (undocumented, version-dependent) binary
ark files through the Kaldi tools ``ali-to-phones`` / ``ali-to-pdf`` into
text form, then parsing.
"""

import logging
from pathlib import Path
from tempfile import NamedTemporaryFile

import numpy as np

from pb_chime5_tpu_torch.kaldi.helper import (
    get_kaldi_env, execute_kaldi_commands)
from pb_chime5_tpu_torch.utils.process_caller import run_process

LOG = logging.getLogger('Kaldi')

__all__ = [
    'import_pdf_alignment_from_file', 'import_phone_alignment_from_file',
    'import_alignment_data', 'import_occs', 'write_occs',
    'compile_train_graphs', 'forced_alignment',
]


def _import_alignment(ark, model_file, extract_cmd, extract_cmd_finish,
                      is_zipped=True, import_options=None):
    """ark + model -> {utt_id: np.int32 array} via a Kaldi extract tool.

    The tool reports 'Done <N>' / 'Converted <N>' on stderr; the count is
    cross-checked against the parsed utterances (reference
    alignment.py:12-56)."""
    src_param = (f'ark:gunzip -c {ark} |' if is_zipped else f'ark:{ark}')
    completed = run_process(
        [extract_cmd, *(import_options or []), str(model_file), src_param,
         'ark,t:-'],
        environment=get_kaldi_env())
    out, err = completed.stdout, completed.stderr
    pos = err.find(extract_cmd_finish) + 1 + len(extract_cmd_finish)
    matrix_number = int(err[pos:].split()[0])

    data = {}
    for line in out.split('\n'):
        split = line.split()
        if split:
            data[split[0]] = np.asarray(split[1:], dtype=np.int32)
    assert len(data) == matrix_number, \
        (extract_cmd, matrix_number, len(data))
    return data


def import_pdf_alignment_from_file(ark, model_file, is_zipped=True):
    return _import_alignment(
        str(ark), str(model_file), 'ali-to-pdf', 'Converted', is_zipped)


def import_phone_alignment_from_file(ark, model_file, is_zipped=True,
                                     per_frame=False):
    return _import_alignment(
        str(ark), str(model_file), 'ali-to-phones', 'Done', is_zipped,
        ['--per-frame'] if per_frame else [])


def import_alignment_data(ali_dir, model_name='final.alimdl',
                          import_fn=import_pdf_alignment_from_file,
                          **import_kwargs):
    """Merge all ali* files of a Kaldi alignment directory into one dict
    (reference alignment.py:96-128)."""
    ali_dir = Path(ali_dir).resolve()
    data = {}
    for file in sorted(ali_dir.glob('*')):
        if file.name.startswith('ali'):
            data.update(import_fn(
                ali_dir / file,
                ali_dir / model_name,
                is_zipped=file.name.endswith('.gz'),
                **import_kwargs))
    return data


def import_occs(occs_file):
    """Read a Kaldi occupancy-counts file (text or binary via copy-vector,
    reference alignment.py:131-148)."""
    try:
        occs = Path(occs_file).read_text().splitlines()[0].strip()
    except UnicodeDecodeError:
        with NamedTemporaryFile() as tmpfile:
            execute_kaldi_commands(
                [f'copy-vector --binary=false {occs_file} {tmpfile.name}'],
                'convert occs')
            occs = Path(tmpfile.name).read_text().splitlines()[0].strip()
    occs = occs.replace('[', '').replace(']', '').split()
    return np.array([occ.split('.')[0] for occ in occs], dtype=np.int32)


def write_occs(occs, occs_file):
    Path(occs_file).write_text('[' + ' '.join(map(str, occs)) + ']')


def compile_train_graphs(tree_file, model_file, lexicon_fst_file,
                         integer_transcription_file, output_graphs_file):
    """Prepare decoding graphs for forced alignment
    (reference alignment.py:160-198)."""
    command = (
        f'compile-train-graphs '
        f'{Path(tree_file).resolve()} '
        f'{Path(model_file).resolve()} '
        f'{Path(lexicon_fst_file).resolve()} '
        f'ark:{Path(integer_transcription_file).resolve()} '
        f'ark:{Path(output_graphs_file).resolve()}'
    )
    _, stderrs, _ = execute_kaldi_commands(
        command, name='compile_train_graphs')
    for line in stderrs[0].split('\n'):
        LOG.info(line)


def forced_alignment(log_posteriors_ark_file, graphs_file, model_file,
                     alignment_dir, beam=200, retry_beam=400, part=1):
    """align-compiled-mapped forced alignment
    (reference alignment.py:201-249)."""
    if part != 1:
        raise NotImplementedError(
            'chunk log_posteriors/graphs before using parallel parts')
    command = (
        f'align-compiled-mapped '
        f'--beam={beam} --retry-beam={retry_beam} '
        f'{model_file} ark:{graphs_file} ark:{log_posteriors_ark_file} '
        f'ark,t:|gzip -c > {alignment_dir}/ali.{part}.gz'
    )
    _, stderrs, _ = execute_kaldi_commands(
        command, name='forced_alignment')
    for line in stderrs[0].split('\n'):
        LOG.info(line)
