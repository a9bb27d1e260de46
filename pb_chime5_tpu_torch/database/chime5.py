"""CHiME-5 database: session iterators, clock-drift correction, context
windows, segmented audio reading.

Behavioural rebuild of pb_chime5/database/chime5/database.py (file:line
citations inline).  The host-side example dicts have the nested shape

    start / end / num_samples:
        {'observation': {'U01': int, ...},
         'worn': {'P05': int, ...}}         (+ 'original': int after
                                             backup_orig_start_end)
    audio_path: same nesting -> wav paths

CHiME-6 examples carry flat ints for start / end / num_samples (one
global clock); the context window treats both alike.

The port's copy of ``pb_chime5_tpu/database/chime5.py``; a negative
context raises ``ValueError`` here (``AssertionError`` there).
"""

import numbers

import numpy as np

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.database import JsonDatabase, keys as K
from pb_chime5_tpu_torch.io import load_audio
from pb_chime5_tpu_torch.utils.activity_freq import (  # noqa: F401 re-export
    activity_time_to_frequency, activity_frequency_to_time)

__all__ = [
    'Chime5', 'Chime5AudioReader', 'backup_orig_start_end',
    'adjust_start_end', 'AddContext', 'nest_map_structure',
    'nest_broadcast', 'kaldi_to_nt_example_id', 'kaldi_id_to_parts',
    'kaldi_id_to_channel', 'activity_time_to_frequency',
    'activity_frequency_to_time', 'recursive_audio_transform',
]


class Chime5(JsonDatabase):
    """CHiME-5 example database (reference database.py:27-130)."""

    @property
    def datasets_train(self):
        return ['train']

    @property
    def datasets_eval(self):
        return ['dev']

    @property
    def datasets_test(self):
        return ['test']

    @property
    def map_dataset_to_sessions(self):
        return {k: list(v) for k, v in mapping.dataset_to_sessions.items()}

    @staticmethod
    def example_id_map_fn(example):
        """nt id -> kaldi id (reference database.py:57-79).

        'P05_S02_0004060-0004382' + location 'kitchen'
        -> 'P05_S02_KITCHEN.L-0004060-0004382'
        """
        speaker, session, time = example[K.EXAMPLE_ID].split('_')
        location = example[K.LOCATION]
        loc = 'NOLOCATION' if location == 'unknown' else location.upper()
        return f'{speaker}_{session}_{loc}.L-{time}'

    def get_iterator_for_session(
            self,
            session,
            *,
            audio_read=False,
            drop_unknown_target_speaker=False,
            adjust_times=False,
            context_samples=0,
            equal_start_context=False,
    ):
        if isinstance(session, str):
            session = (session,)
        it = self.get_datasets(session)

        if drop_unknown_target_speaker:
            it = it.filter(
                lambda ex: ex[K.TRANSCRIPTION] != '[redacted]', lazy=False)

        if context_samples != 0 or adjust_times:
            it = it.map(backup_orig_start_end)

        if adjust_times:
            assert adjust_times is True, adjust_times
            assert drop_unknown_target_speaker, (
                'adjust_times is undefined for '
                'ex["target_speaker"] == "unknown". '
                'Set drop_unknown_target_speaker to True.')
            it = it.map(adjust_start_end)

        if context_samples != 0:
            it = it.map(AddContext(
                context_samples, equal_start_context=equal_start_context))

        if audio_read is False:
            pass
        elif audio_read is True:
            it = it.map(Chime5AudioReader(audio_keys=None))
        else:
            raise TypeError(audio_read)
        return it


# --------------------------------------------------------------------------
# example-dict transforms
# --------------------------------------------------------------------------

def backup_orig_start_end(ex):
    """Keep pristine copies before adjust/context mutate them
    (reference database.py:706-710)."""
    ex['start_orig'] = ex[K.START]
    ex['end_orig'] = ex[K.END]
    ex['num_samples_orig'] = ex[K.NUM_SAMPLES]
    return ex


def _adjust_start_end(worn_start, worn_end, array_start, array_end):
    """Equalize an array-clock interval's duration to the worn-clock
    duration, splitting the delta between both ends (reference
    database.py:475-538; behaviour pinned by its randomized doctest)."""
    worn_duration = worn_end - worn_start
    array_duration = array_end - array_start
    delta = abs(worn_duration - array_duration)
    delta_start = delta // 2
    delta_end = (delta + 1) // 2
    if worn_duration > array_duration:
        new = (array_start - delta_start, array_end + delta_end)
    elif worn_duration < array_duration:
        new = (array_start + delta_start, array_end - delta_end)
    else:
        new = (array_start, array_end)
    assert new[1] - new[0] == worn_duration, \
        (worn_start, worn_end, array_start, array_end, new)
    return new


def adjust_start_end(ex):
    """Apply the clock-drift duration correction to every observation and
    worn track (reference database.py:540-570)."""
    worn_start = ex[K.START]['original']
    worn_end = ex[K.END]['original']
    for group in ('observation', 'worn_microphone'):
        if group == 'observation':
            ids = ex[K.AUDIO_PATH]['observation'].keys()
        else:
            ids = ex[K.AUDIO_PATH].get('worn_microphone', {}).keys()
        for track_id in ids:
            s, e = _adjust_start_end(
                worn_start, worn_end,
                ex[K.START][group][track_id],
                ex[K.END][group][track_id])
            ex[K.START][group][track_id] = s
            ex[K.END][group][track_id] = e
            ex[K.NUM_SAMPLES][group][track_id] = e - s
    return ex


def nest_map_structure(fn, *structures):
    """Apply ``fn`` leaf-wise over parallel nested dict/list structures."""
    first = structures[0]
    if isinstance(first, dict):
        return {
            k: nest_map_structure(
                fn, *[s[k] if isinstance(s, dict) else s
                      for s in structures])
            for k in first
        }
    if isinstance(first, (list, tuple)):
        return type(first)(
            nest_map_structure(
                fn, *[s[i] if isinstance(s, (list, tuple)) else s
                      for s in structures])
            for i, _ in enumerate(first))
    return fn(*structures)


def nest_broadcast(shallow_tree, input_tree, mapping_type=dict,
                   sequence_type=(tuple, list)):
    """Broadcast ``input_tree`` against the shape of ``shallow_tree``
    (reference database.py:572-699, behaviour pinned by its doctests)."""
    def inner(shallow, inp):
        if mapping_type is not None and isinstance(shallow, mapping_type):
            if isinstance(inp, mapping_type):
                assert set(inp.keys()) == set(shallow.keys()), \
                    (inp, shallow)
                return {k: inner(v, inp[k]) for k, v in shallow.items()}
            if sequence_type is not None and isinstance(inp, sequence_type):
                raise TypeError(type(inp), inp, shallow)
            return {k: inner(v, inp) for k, v in shallow.items()}
        if sequence_type is not None and isinstance(shallow, sequence_type):
            if isinstance(inp, sequence_type):
                assert type(inp) == type(shallow), \
                    (type(inp), type(shallow), inp, shallow)
                assert len(inp) == len(shallow), (inp, shallow)
                return type(shallow)(
                    inner(s, i) for s, i in zip(shallow, inp))
            if mapping_type is not None and isinstance(inp, mapping_type):
                raise TypeError(type(inp), inp, shallow)
            return type(shallow)(inner(s, inp) for s in shallow)
        if isinstance(inp, (mapping_type or ()) if mapping_type else ()):
            raise TypeError(type(inp), inp, shallow)
        if sequence_type is not None and isinstance(inp, sequence_type):
            raise TypeError(type(inp), inp, shallow)
        return inp
    return inner(shallow_tree, input_tree)


def _non_negative(context):
    """A negative context raises ``ValueError`` (the JAX package asserts)."""
    if context < 0:
        raise ValueError(
            f'Negative context value ({context}) is not supported')


def AddContext(samples, equal_start_context=False):
    """Expand every start/end by an acoustic context window (reference
    database.py:713-1053; doctest-pinned behaviour).

    ``samples`` may be an int (symmetric), ``[start, end]``, or a dict
    broadcast over the start/end nesting.  ``equal_start_context`` aligns
    the *achieved* start context across all tracks (clock drift makes
    ``max(t - ctx, 0)`` clip differently per track near session start,
    reference database.py:978-995).
    """
    def split(spec):
        if isinstance(spec, dict):
            items = [(k, *split(v)) for k, v in spec.items()]
            keys = [i[0] for i in items]
            return (dict(zip(keys, (i[1] for i in items))),
                    dict(zip(keys, (i[2] for i in items))),
                    dict(zip(keys, (i[3] for i in items))))
        if isinstance(spec, (tuple, list)):
            if len(spec) == 1 and isinstance(spec[0], int):
                spec = spec[0]
            elif len(spec) == 2 and isinstance(spec[0], int):
                s, e = spec
                _non_negative(s)
                _non_negative(e)
                return s, e, s + e
            else:
                raise NotImplementedError(spec)
        if isinstance(spec, int):
            _non_negative(spec)
            return spec, spec, 2 * spec
        raise ValueError(spec, type(spec))

    start_context, end_context, _ = split(samples)

    def add_context(ex):
        assert 'start_orig' in ex, ex
        assert 'end_orig' in ex, ex
        assert 'num_samples_orig' in ex, ex

        if isinstance(start_context, int):
            bc_start = start_context
            bc_end = end_context
        else:
            bc_start = nest_broadcast(ex[K.START], start_context)
            bc_end = nest_broadcast(ex[K.END], end_context)

        ex[K.START] = nest_map_structure(
            lambda t, c: max(t - c, 0), ex[K.START], bc_start)

        if equal_start_context:
            assert isinstance(start_context, int), start_context
            deltas = []
            nest_map_structure(
                lambda s, so: deltas.append(so - s),
                ex[K.START], ex['start_orig'])
            smallest = min(deltas)
            ex[K.START] = nest_map_structure(
                lambda so: max(so - smallest, 0), ex['start_orig'])

        ex[K.END] = nest_map_structure(
            lambda t, c: t + c, ex[K.END], bc_end)
        ex[K.NUM_SAMPLES] = nest_map_structure(
            lambda s, e: e - s, ex[K.START], ex[K.END])
        return ex

    return add_context


# --------------------------------------------------------------------------
# audio reading
# --------------------------------------------------------------------------

def recursive_audio_transform(fn, tree, start, end, list2array=False):
    """Apply an audio loader over a nested path tree with parallel
    start/end trees (reference database.py:260-325)."""
    if isinstance(tree, dict):
        return {
            k: recursive_audio_transform(
                fn, v, start[k], end[k], list2array)
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        assert isinstance(start, numbers.Integral) and \
            isinstance(end, numbers.Integral), (start, end)
        out = [recursive_audio_transform(fn, v, start, end, list2array)
               for v in tree]
        return np.array(out) if list2array else out
    return fn(tree, start=start, stop=end)


class Chime5AudioReader:
    """Segmented audio reader transform (reference database.py:133-175)."""

    def __init__(self, src_key=K.AUDIO_PATH, dst_key=K.AUDIO_DATA,
                 audio_keys='observation', read_fn=load_audio):
        self.src_key = src_key
        self.dst_key = dst_key
        self.audio_keys = (
            [audio_keys] if isinstance(audio_keys, str) else audio_keys)
        self._read_fn = read_fn

    def __call__(self, example):
        if self.audio_keys is not None:
            try:
                data = {
                    key: recursive_audio_transform(
                        self._read_fn, example[self.src_key][key],
                        example[K.START][key], example[K.END][key],
                        list2array=True)
                    for key in self.audio_keys
                }
            except KeyError as e:
                raise KeyError(
                    f'{e} not in {example[self.src_key].keys()}') from e
        else:
            data = recursive_audio_transform(
                self._read_fn, example[self.src_key],
                example[K.START], example[K.END], list2array=True)
        if self.dst_key is not None:
            example[self.dst_key] = data
        else:
            example.update(data)
        return example


# --------------------------------------------------------------------------
# kaldi id conversions (reference database.py:178-257)
# --------------------------------------------------------------------------

def kaldi_to_nt_example_id(example_id: str):
    """'P28_S09_LIVING.R-0714562-0714764' -> 'P28_S09_0714562-0714764'."""
    try:
        split = example_id.split('_')
        if len(split) == 4:
            raise NotImplementedError(
                f'Array IDs like "{example_id}" are currently unsupported, '
                f'because they have different timestamps.')
        P, S, remaining = split
        _, start, end = remaining.split('-')
        return f'{P}_{S}_{start}-{end}'
    except NotImplementedError:
        raise
    except Exception as e:
        raise ValueError(example_id) from e


def kaldi_id_to_parts(example_id: str):
    try:
        pre, post = example_id.split('.')
        speaker_id, session_id, *array, location = pre.split('_')
        channel, start, end = post.split('-')
        assert len(array) <= 1, (array, example_id)
        return {
            'speaker_id': speaker_id,
            'session_id': session_id,
            'array_id': speaker_id,
            'location': location,
            'channel': channel,
        }
    except Exception as e:
        raise ValueError(example_id) from e


def kaldi_id_to_channel(example_id: str):
    try:
        _, post = example_id.split('.')
        channel, _, _ = post.split('-')
        return channel
    except Exception as e:
        raise ValueError(example_id) from e
