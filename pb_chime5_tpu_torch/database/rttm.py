"""RTTM-driven database (CHiME-6 track 2: diarization output in place of
the transcriptions) — port of ``pb_chime5_tpu/database/rttm.py``
(reference pb_chime5/database/chime5/rttm.py).

Examples come straight from the RTTM's intervals, with flat integer
start / end on the global CHiME-6 clock; the audio paths come from
globbing the corpus tree, the dataset aliases (train / dev / eval) from
its directory layout.
"""

import collections
import itertools
import weakref
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.database import DictDatabase
from pb_chime5_tpu_torch.database.chime5 import (
    AddContext, adjust_start_end, backup_orig_start_end)
from pb_chime5_tpu_torch.io import load_audio
from pb_chime5_tpu_torch.utils import array_intervals_from_rttm

__all__ = ['groupby', 'get_chime6_files', 'RTTMDatabase',
           'Chime6RTTMDatabase', 'load_example_audio', 'recursive_load_audio',
           'normalize_rttm_file_ids', 'load_rttm']


def groupby(iterable, group_fn, map_fn=None):
    """``itertools.groupby`` -> dict of lists (reference rttm.py:11-18)."""
    groups = collections.defaultdict(list)
    for k, g in itertools.groupby(iterable, group_fn):
        groups[k].extend(g if map_fn is None else map(map_fn, g))
    return dict(groups)


def get_chime6_files(chime6_dir, worn=False, flat=False):
    """The CHiME-6 audio tree's files (reference rttm.py:21-117):
    ``worn`` -> {session: {speaker: path}}; else {session: {array: [its
    channels' paths]}}, or with ``flat`` {session: [every array channel's
    path]}."""
    chime6_dir = Path(chime6_dir)
    out = {}
    if worn:
        assert flat is False, flat
        for p in sorted(chime6_dir.glob('audio/*/*_P*.wav')):
            session, rest = p.name.split('_', 1)
            out.setdefault(session, {})[rest.split('.')[0]] = str(p)
    else:
        for p in sorted(chime6_dir.glob('audio/*/*_U*.wav')):
            session, rest = p.name.split('_', 1)
            if flat:
                out.setdefault(session, []).append(str(p))
            else:
                out.setdefault(session, {}).setdefault(
                    rest.split('.')[0], []).append(str(p))
    assert len(out) > 0, (chime6_dir, 'no audio files found')
    return out


def normalize_rttm_file_ids(data: dict) -> dict:
    """Strip the Kaldi recipe's '_U06' / '.ENH' file-id postfixes
    (reference rttm.py:418-430)."""
    out = {k.replace('_U06', '').replace('.ENH', ''): v
           for k, v in data.items()}
    assert len(out) == len(data), (out.keys(), data.keys())
    return out


def load_rttm(paths):
    """One or more RTTM files -> {session: {speaker: ArrayInterval}}."""
    if isinstance(paths, (str, Path)):
        paths = [paths]
    data = {}
    for p in paths:
        for file_id, speakers in array_intervals_from_rttm(p).items():
            data.setdefault(file_id, {}).update(speakers)
    return normalize_rttm_file_ids(data)


class RTTMDatabase(DictDatabase):
    """Examples from RTTM intervals and a per-session list of audio paths
    (reference rttm.py:285-547)."""

    def __init__(self, rttm_path, audio_paths, alias=None):
        self._rttm_path = rttm_path
        self._audio_paths = audio_paths
        self._alias = alias or {}
        self._database_dict_cache = None
        self._dataset_cache = weakref.WeakValueDictionary()

    def __repr__(self):
        return f'{type(self).__name__}({self._rttm_path!r})'

    @property
    def rttm(self):
        return load_rttm(self._rttm_path)

    @staticmethod
    def example_id(file_id, speaker_id, start, end):
        """'S02_U06.-P05-000000100_000000200': the CHiME-6 Kaldi baseline
        needs the 'U06' token in the utterance id whatever arrays are
        used (reference rttm.py:434-458)."""
        max_digits = len(str(16000 * 60 * 60 * 10))
        return (f'{file_id}_U06.-{speaker_id}-'
                f'{str(start).zfill(max_digits)}_'
                f'{str(end).zfill(max_digits)}')

    @property
    def database_dict(self):
        if self._database_dict_cache is None:
            datasets = {}
            for session_id, session in self.rttm.items():
                examples = {}
                for speaker_id, interval in session.items():
                    for start, end in interval.normalized_intervals:
                        example_id = self.example_id(
                            session_id, speaker_id, start, end)
                        examples[example_id] = {
                            'example_id': example_id,
                            'start': start,
                            'end': end,
                            'num_samples': end - start,
                            'session_id': session_id,
                            'speaker_id': speaker_id,
                            'audio_path': self._audio_paths[session_id],
                        }
                datasets[session_id] = examples
            self._database_dict_cache = {
                'datasets': datasets, 'alias': self._alias}
        return self._database_dict_cache

    def get_dataset_for_session(
            self,
            session,
            *,
            audio_read=False,
            adjust_times=False,
            context_samples=0,
            equal_start_context=False,
    ):
        """The examples of the session(s), with context; ``audio_read``
        reads each one's tracks into ``audio_data`` through
        :func:`recursive_load_audio` (float64, short tracks dropped)."""
        if isinstance(session, str):
            session = (session,)
        it = self.get_datasets(session)
        if context_samples != 0 or adjust_times:
            it = it.map(backup_orig_start_end)
        if adjust_times:
            assert adjust_times is True, adjust_times
            it = it.map(adjust_start_end)
        if context_samples != 0:
            it = it.map(AddContext(context_samples,
                                   equal_start_context=equal_start_context))
        if audio_read is True:
            def load(example):
                example['audio_data'] = load_example_audio(example)
                return example
            it = it.map(load)
        elif audio_read is not False:
            raise TypeError(audio_read)
        return it


class Chime6RTTMDatabase(RTTMDatabase):
    """An :class:`RTTMDatabase` that takes its audio paths (every array
    channel of a session) and dataset aliases (the audio tree's
    directories) from a CHiME-6 corpus dir (reference rttm.py:120-282)."""

    def __init__(self, rttm_path, chime6_dir):
        chime6_dir = Path(chime6_dir)
        alias = {}
        for p in sorted(chime6_dir.glob('audio/*/*.wav')):
            alias.setdefault(p.parts[-2], set()).add(p.name.split('_')[0])
        super().__init__(
            rttm_path, get_chime6_files(chime6_dir, worn=False, flat=True),
            alias={k: sorted(v) for k, v in alias.items()})
        self._chime6_dir = chime6_dir

    @property
    def worn_files(self):
        return get_chime6_files(self._chime6_dir, worn=True)


def load_example_audio(example):
    """An example's tracks over its (context-extended) span, through
    :func:`recursive_load_audio`: float64; a track that ends before the
    utterance does is dropped."""
    return recursive_load_audio(
        example['audio_path'],
        start=example['start'],
        stop=example['end'],
        min_num_samples=(example.get('end_orig', example['end'])
                         - example['start']),
    )


def recursive_load_audio(path, *, start=0, stop=None, min_num_samples=1,
                         max_missing=8, **kwargs):
    """Load a nested path structure of tracks, tolerating missing and
    short ones (reference rttm.py:550-632): a track shorter than
    ``min_num_samples`` at this offset is dropped (in real CHiME-6 U05 of
    one session loses its last 15 minutes); at most ``max_missing`` of a
    list may be dropped; the rest are cut to their common length and
    stacked."""
    if isinstance(path, (tuple, list)):
        data = [recursive_load_audio(
            p, start=start, stop=stop, min_num_samples=min_num_samples,
            max_missing=max_missing, **kwargs) for p in path]
        n = len(data)
        data = [d for d in data if d is not None]
        if len(data) < n - max_missing:
            raise ValueError(f'{n - len(data)} of {n} tracks are shorter '
                             f'than {min_num_samples} samples at {start}; '
                             f'at most {max_missing} may be')
        lengths = {d.shape[-1] for d in data}
        if len(lengths) > 1:
            num_samples = min(lengths)
            assert num_samples >= min_num_samples, \
                (num_samples, min_num_samples, lengths)
            data = [d[..., :num_samples] for d in data]
        return np.array(data)
    if isinstance(path, dict):
        return {k: recursive_load_audio(
            v, start=start, stop=stop, min_num_samples=min_num_samples,
            max_missing=max_missing, **kwargs) for k, v in path.items()}
    data = load_audio(path, start=start, stop=stop, **kwargs)
    if data.shape[-1] < min_num_samples:
        return None
    return data
