"""Rasterize utterance annotations into speaker activity — the array
perspective of ``pb_chime5_tpu.activity.get_activity`` (reference
pb_chime5/activity.py:8-225), which is what the CHiME-5 enhancer uses,
and ``get_activity_chime6`` (reference activity.py:228-404), CHiME-6's
one global clock.

``get_activity`` returns ``{session: {array: {speaker: ArrayInterval}}}``
on each array's (drift-adjusted) clock, ``get_activity_chime6``
``{session: {speaker: ArrayInterval}}`` of ``CHIME6_MAX_NUM_SAMPLES``
(long enough for any session; the caller slices).  Both add a noise
class: ``garbage_class`` True -> an always-on 'Noise' track, False -> an
always-off one, None -> none, int n -> n always-on 'Noise<i>' tracks.
"""

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.utils import ArrayInterval, Dispatcher

__all__ = ['get_activity', 'get_activity_chime6', 'CHIME6_MAX_NUM_SAMPLES']

# 10 h at 16 kHz (reference activity.py:344)
CHIME6_MAX_NUM_SAMPLES = 60 * 60 * 16000 * 10


def _track(num_samples, on):
    track = ArrayInterval(num_samples)
    if on:
        track[:] = 1
    return track


def _add_garbage_class(tracks, garbage_class, num_samples):
    if garbage_class is None:
        pass
    elif garbage_class is True or garbage_class is False:
        tracks['Noise'] = _track(num_samples, garbage_class)
    elif isinstance(garbage_class, int) and garbage_class > 0:
        for i in range(garbage_class):
            tracks[f'Noise{i}'] = _track(num_samples, True)
    else:
        raise ValueError(garbage_class)


def get_activity(iterator, *, garbage_class):
    activity = Dispatcher()
    for session_id, examples in iterator.groupby(
            lambda ex: ex['session_id']).items():
        speakers = mapping.session_to_speakers[session_id]
        arrays = mapping.session_to_arrays[session_id]
        per_array = activity[session_id] = Dispatcher()
        for array in arrays:
            n = mapping.session_array_to_num_samples[f'{session_id}_{array}']
            tracks = per_array[array] = Dispatcher(
                {s: ArrayInterval(n) for s in speakers})
            _add_garbage_class(tracks, garbage_class, n)
        for ex in examples:
            if ex['transcription'] == '[redacted]':
                continue
            for array in arrays:
                if array in ex['audio_path']['observation']:
                    per_array[array][ex['speaker_id']][
                        ex['start']['observation'][array]:
                        ex['end']['observation'][array]] = 1
    return activity


def get_activity_chime6(iterator, *, garbage_class):
    activity = Dispatcher()
    for session_id, examples in iterator.groupby(
            lambda ex: ex['session_id']).items():
        tracks = activity[session_id] = Dispatcher({
            s: ArrayInterval(CHIME6_MAX_NUM_SAMPLES)
            for s in mapping.session_to_speakers[session_id]})
        _add_garbage_class(tracks, garbage_class, CHIME6_MAX_NUM_SAMPLES)
        for ex in examples:
            if ex['transcription'] != '[redacted]':
                tracks[ex['speaker_id']][ex['start']:ex['end']] = 1
    return activity
