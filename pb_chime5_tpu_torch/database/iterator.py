"""Generic example-dict transforms
(reference: pb_chime5/database/iterator.py).

The port's copy of ``pb_chime5_tpu/database/iterator.py``.
"""

import logging

import numpy as np

from pb_chime5_tpu_torch.database import keys
from pb_chime5_tpu_torch.io import load_audio

LOG = logging.getLogger('iterator')

ALIGNMENT = 'alignment'
NUM_ALIGNMENT_FRAMES = 'num_alignment_frames'

__all__ = ['recursive_transform', 'AudioReader', 'IdFilter',
           'remove_zero_length_example', 'LimitAudioLength', 'Word2Id']


def recursive_transform(func, tree, list2array=False):
    """Apply ``func`` to every leaf of a nested dict/list; optionally
    stack lists into arrays."""
    if isinstance(tree, dict):
        return {k: recursive_transform(func, v, list2array)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = type(tree)(
            recursive_transform(func, v, list2array) for v in tree)
        return np.array(out) if list2array else out
    return func(tree)


def to_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


class AudioReader:
    """Recursively read audio paths into ``example[dst_key]``."""

    def __init__(self, src_key='audio_path', dst_key='audio_data',
                 audio_keys='observation', read_fn=load_audio):
        self.src_key = src_key
        self.dst_key = dst_key
        self.audio_keys = None if audio_keys is None else to_list(audio_keys)
        self._read_fn = read_fn

    def __call__(self, example):
        if self.audio_keys is not None:
            data = {
                key: recursive_transform(
                    self._read_fn, example[self.src_key][key],
                    list2array=True)
                for key in self.audio_keys
            }
        else:
            data = recursive_transform(
                self._read_fn, example[self.src_key], list2array=True)
        if self.dst_key is not None:
            example[self.dst_key] = data
        else:
            example.update(data)
        return example


class IdFilter:
    """Keep only examples whose id is in ``id_list``."""

    def __init__(self, id_list):
        self.id_list = id_list

    def __call__(self, example):
        return example[keys.EXAMPLE_ID] in self.id_list


def remove_zero_length_example(example, audio_key='observation',
                               dst_key='audio_data'):
    if keys.NUM_SAMPLES in example:
        num_samples = example[keys.NUM_SAMPLES]
        if isinstance(num_samples, dict):
            num_samples = num_samples[keys.OBSERVATION]
        valid = num_samples > 0
    else:
        valid = len(example[dst_key][audio_key]) > 0
    if not valid:
        LOG.warning(f'Skipping: Audio length of example '
                    f'{example[keys.EXAMPLE_ID]} is 0')
        return False
    return True


class LimitAudioLength:
    """Random-crop long examples to ``max_lengths`` samples, resyncing an
    attached frame alignment (incl. low-frame-rate models, reference
    iterator.py:154-215)."""

    def __init__(self, max_lengths=160000, audio_keys=('observation',),
                 dst_key='audio_data', frame_length=400, frame_step=160):
        self.max_lengths = max_lengths
        self.audio_keys = audio_keys
        self.dst_key = dst_key
        self.frame_length = frame_length
        self.frame_step = frame_step
        if self.max_lengths:
            LOG.info(f'Will limit audio length to {self.max_lengths}')

    def _sample_to_frame(self, s):
        return max(0, (s - self.frame_length + self.frame_step)
                   // self.frame_step)

    @staticmethod
    def _frame_to_lfr_frame(f):
        return (f + (-f) % 3) // 3

    def __call__(self, example):
        if keys.NUM_SAMPLES in example and \
                example[keys.NUM_SAMPLES] <= self.max_lengths:
            return example

        delta = max(1, (example[keys.NUM_SAMPLES] - self.max_lengths) // 2)
        start = int(np.random.choice(delta, 1)[0])

        def cut_fn(x):
            return x[..., start:start + self.max_lengths]

        if self.audio_keys is not None:
            example[keys.AUDIO_DATA] = {
                key: recursive_transform(
                    cut_fn, example[keys.AUDIO_DATA][key], list2array=True)
                for key in self.audio_keys
            }
        else:
            example[keys.AUDIO_DATA] = recursive_transform(
                cut_fn, example[keys.AUDIO_DATA], list2array=True)
        example[keys.NUM_SAMPLES] = self.max_lengths

        if ALIGNMENT in example:
            frames_start = self._sample_to_frame(start)
            frames_length = self._sample_to_frame(self.max_lengths)
            num_frames = (example[keys.NUM_SAMPLES]
                          - self.frame_length + self.frame_step) \
                // self.frame_step
            if len(example[ALIGNMENT]) == self._frame_to_lfr_frame(
                    num_frames):
                frames_start = self._frame_to_lfr_frame(frames_start)
                frames_length = self._frame_to_lfr_frame(frames_length)
            example[ALIGNMENT] = example[ALIGNMENT][
                frames_start:frames_start + frames_length]
            example[NUM_ALIGNMENT_FRAMES] = frames_length

        LOG.warning(f'Cutting example to length {self.max_lengths}: '
                    f'{example[keys.EXAMPLE_ID]}')
        return example


class Word2Id:
    """Add integer-id transcriptions via a word->id function."""

    def __init__(self, word2id_fn):
        self._word2id_fn = word2id_fn

    def __call__(self, example):
        def _w2id(s):
            return np.array([self._word2id_fn(w) for w in s.split()],
                            np.int32)

        if not (keys.TRANSCRIPTION in example
                or keys.KALDI_TRANSCRIPTION in example):
            raise ValueError(
                'Could not find transcription for example id '
                f'{example[keys.EXAMPLE_ID]}')
        if keys.TRANSCRIPTION in example:
            example[keys.TRANSCRIPTION + '_ids'] = recursive_transform(
                _w2id, example[keys.TRANSCRIPTION])
        if keys.KALDI_TRANSCRIPTION in example:
            example[keys.KALDI_TRANSCRIPTION + '_ids'] = \
                recursive_transform(_w2id,
                                    example[keys.KALDI_TRANSCRIPTION])
        return example
