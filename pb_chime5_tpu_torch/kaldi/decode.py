"""Lattice rescoring + WER scoring sweep — the port of
``pb_chime5_tpu/kaldi/decode.py`` (reference pb_chime5/kaldi/decode.py).

``compute_scores`` rescales decoded lattices over a language-model-weight
sweep (lmwt 8..18 by default), computes WER per weight with Kaldi's
``compute-wer``, and collects the results into a pandas DataFrame pickle
— the offline evaluation path of the front-end.
"""

import glob
import logging
import os
import pickle
import re
import warnings
from collections import defaultdict
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.kaldi import helper

__all__ = ['parse_wer_file', 'compute_scores']

_WER_RE = re.compile(
    r'%WER\s([0-9]*\.?[0-9]*) \[ ([0-9]*) / ([0-9]*), ([0-9]*) ins, '
    r'([0-9]*) del, ([0-9]*) sub.*')


def _build_rescale_lattice_cmd(decode_dir, hclg_dir, lmwt,
                               word_insertion_penalty=0):
    return (
        f'lattice-scale --inv-acoustic-scale={lmwt} '
        f'ark:"cat {decode_dir}/lats/*.lat|" ark:- | '
        f'lattice-add-penalty '
        f'--word-ins-penalty={word_insertion_penalty} ark:- ark:- | '
        f'lattice-best-path --word-symbol-table={hclg_dir}/words.txt '
        f'ark:- ark,t:{decode_dir}/scoring/{lmwt}.tra'
    )


def _build_compute_wer_command(decode_dir, hclg_dir, lmwt, strict=False):
    mode = '--mode=strict' if strict else '--mode=present'
    return (
        f'cat {decode_dir}/scoring/{lmwt}.tra | sort -u -k1,1 | '
        f'{helper.INT2SYM()} -f 2- {hclg_dir}/words.txt | '
        f"sed 's:<UNK>::g' | "
        f'compute-wer --text {mode} '
        f'ark:{decode_dir}/scoring/test_filt.txt ark,p:- '
        f'> {decode_dir}/wer_{lmwt}'
    )


def _parse_wer_lines(lines):
    """'%WER 60.89 [ a / b, i ins, d del, s sub ]' ->
    (wer, errors, words, ins, del, sub)."""
    if isinstance(lines, str):
        lines = [lines]
    for line in lines:
        if line.startswith('%WER'):
            m = _WER_RE.match(line)
            if m:
                wer, errors, words, ins, del_, sub = m.groups()
                return (float(wer), int(errors), int(words), int(ins),
                        int(del_), int(sub))
    return np.nan, 0, 0, 0, 0, 0


def parse_wer_file(wer_file):
    try:
        return _parse_wer_lines(Path(wer_file).read_text().splitlines())
    except Exception as e:
        warnings.warn(f'Exception during parsing of WER file: {e}')
    return np.nan, 0, 0, 0, 0, 0


def _tra_complete(tra_file, ref_file):
    if not os.path.exists(tra_file):
        return False
    tra = {l.split()[0] for l in Path(tra_file).read_text().splitlines()
           if l.split()}
    ref = {l.split()[0] for l in Path(ref_file).read_text().splitlines()
           if l.split()}
    missing = ref - tra
    if missing:
        logging.getLogger('_tra_complete').warning(
            f'{tra_file} is missing {len(missing)} utts. '
            f'Samples: {sorted(missing)[:5]}')
    return not missing


def _lattices_exist(ref_file, lat_dir):
    ref = {l.split()[0] for l in Path(ref_file).read_text().splitlines()
           if l.split()}
    lat_files = {Path(l).stem for l in glob.glob(f'{lat_dir}/*.lat')}
    missing = ref - lat_files
    if missing:
        logging.getLogger('_lattices_exist').warning(
            f'{lat_dir} is missing {len(missing)} utts. '
            f'Samples: {sorted(missing)[:5]}')
    return not missing


def compute_scores(decode_dir, hclg_dir, ref_text, min_lmwt=8, max_lmwt=18,
                   force_scoring=False, build_tra=True, strict=True,
                   ignore_return_codes=True):
    """Sweep lmwt, score, persist ``result.pkl`` (reference
    decode.py:102-169).  Returns a dict of per-lmwt result lists."""
    LOG = logging.getLogger('compute_scores')
    decode_dir = os.path.abspath(str(decode_dir))
    hclg_dir = str(hclg_dir)
    os.makedirs(os.path.join(decode_dir, 'scoring'), exist_ok=True)
    ref_file = f'{decode_dir}/scoring/test_filt.txt'
    helper.execute_kaldi_commands(
        [f"cat {ref_text} | sed 's:<NOISE>::g' "
         f"| sed 's:<SPOKEN_NOISE>::g' > {ref_file}"],
        'copying reference transcription', log_dir=decode_dir + '/logs',
        ignore_return_code=ignore_return_codes)

    cmds, tra_written = [], {}
    for lmwt in range(min_lmwt, max_lmwt + 1):
        tra_file = f'{decode_dir}/scoring/{lmwt}.tra'
        rescale = not os.path.exists(tra_file)
        rescale &= not _tra_complete(tra_file, ref_file)
        rescale &= _lattices_exist(ref_file, f'{decode_dir}/lats')
        rescale &= build_tra
        rescale |= force_scoring
        if rescale:
            LOG.info(f'Rescaling lattice for lmwt {lmwt}')
            cmds.append(_build_rescale_lattice_cmd(decode_dir, hclg_dir,
                                                   lmwt))
            tra_written[lmwt] = True
    if cmds:
        helper.execute_kaldi_commands(
            cmds, 'rescaling lattice', log_dir=decode_dir + '/logs',
            ignore_return_code=ignore_return_codes)
    else:
        LOG.info('All utts already rescaled - skipping')

    cmds = [
        _build_compute_wer_command(decode_dir, hclg_dir, lmwt,
                                   strict=strict)
        for lmwt in range(min_lmwt, max_lmwt + 1) if lmwt in tra_written
    ]
    if cmds:
        helper.execute_kaldi_commands(
            cmds, 'computing WER', log_dir=decode_dir + '/logs',
            ignore_return_code=ignore_return_codes)

    result = defaultdict(list)
    for lmwt in range(min_lmwt, max_lmwt + 1):
        wer, errors, words, ins, del_, sub = parse_wer_file(
            f'{decode_dir}/wer_{lmwt}')
        result['wer'].append(float(wer))
        result['errors'].append(int(errors))
        result['words'].append(int(words))
        result['ins'].append(int(ins))
        result['del'].append(int(del_))
        result['sub'].append(int(sub))
        result['decode_dir'].append(decode_dir)
        result['lmwt'].append(int(lmwt))
    try:
        import pandas
        with open(decode_dir + '/result.pkl', 'wb') as fid:
            pickle.dump(pandas.DataFrame(result), fid)
    except ImportError:
        with open(decode_dir + '/result.pkl', 'wb') as fid:
            pickle.dump(dict(result), fid)
    return dict(result)
