"""CHiME-5 / CHiME-6 database: per-session example iterators with the
clock-drift correction, the acoustic context window and the segmented
audio read of ``pb_chime5_tpu.database.chime5`` (reference
pb_chime5/database/chime5/database.py).

CHiME-5 example dicts have the nested shape

    start / end / num_samples:
        {'observation': {'U01': int, ...}, 'worn': {'P05': int, ...},
         'original': int}
    audio_path: {'observation': {'U01': [4 wav paths]}, 'worn': {...}}

CHiME-6 ones carry flat ints for start / end / num_samples (one global
clock); the context window treats both alike.
"""

from pb_chime5_tpu_torch.database import JsonDatabase
from pb_chime5_tpu_torch.io import load_audio

__all__ = ['Chime5', 'backup_orig_start_end', 'adjust_start_end',
           'AddContext', 'read_audio']


class Chime5(JsonDatabase):

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
        """The examples of one or more sessions: redacted utterances
        dropped (``drop_unknown_target_speaker``), array times
        drift-corrected (``adjust_times``, CHiME-5 only), ``context_samples``
        of context on both sides (``equal_start_context``: the same
        achieved start context on every track), the audio of every track
        read into ``audio_data`` (``audio_read``)."""
        if isinstance(session, str):
            session = (session,)
        it = self.get_datasets(session)
        if drop_unknown_target_speaker:
            it = it.filter(lambda ex: ex['transcription'] != '[redacted]')
        if context_samples != 0 or adjust_times:
            it = it.map(backup_orig_start_end)
        if adjust_times:
            assert adjust_times is True, adjust_times
            assert drop_unknown_target_speaker, (
                'adjust_times is undefined for an unknown target speaker: '
                'set drop_unknown_target_speaker=True')
            it = it.map(adjust_start_end)
        if context_samples != 0:
            it = it.map(AddContext(context_samples,
                                   equal_start_context=equal_start_context))
        if audio_read is True:
            it = it.map(read_audio)
        elif audio_read is not False:
            raise TypeError(audio_read)
        return it


def backup_orig_start_end(ex):
    """Keep pristine copies before the adjustment and the context edit
    them (reference database.py:706-710)."""
    ex['start_orig'] = ex['start']
    ex['end_orig'] = ex['end']
    ex['num_samples_orig'] = ex['num_samples']
    return ex


def _adjust_start_end(worn_start, worn_end, array_start, array_end):
    """Make an array-clock interval as long as the worn-clock one,
    splitting the difference between both ends (reference
    database.py:475-538)."""
    worn_duration = worn_end - worn_start
    array_duration = array_end - array_start
    delta = abs(worn_duration - array_duration)
    delta_start, delta_end = delta // 2, (delta + 1) // 2
    if worn_duration > array_duration:
        return array_start - delta_start, array_end + delta_end
    if worn_duration < array_duration:
        return array_start + delta_start, array_end - delta_end
    return array_start, array_end


def adjust_start_end(ex):
    """The clock-drift duration correction of every observation and worn
    track (reference database.py:540-570)."""
    worn_start, worn_end = ex['start']['original'], ex['end']['original']
    for group in ('observation', 'worn_microphone'):
        for track in ex['audio_path'].get(group, {}):
            s, e = _adjust_start_end(worn_start, worn_end,
                                     ex['start'][group][track],
                                     ex['end'][group][track])
            ex['start'][group][track] = s
            ex['end'][group][track] = e
            ex['num_samples'][group][track] = e - s
    return ex


def _nest_map(fn, *trees):
    """``fn`` applied leaf-wise over parallel nested dicts (an int is a
    leaf: CHiME-6's flat times)."""
    if isinstance(trees[0], dict):
        return {k: _nest_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def AddContext(samples: int, equal_start_context=False):
    """Widen every start / end by ``samples`` of acoustic context (start
    clipped at 0).  ``equal_start_context`` gives every track the same
    achieved start context: clock drift makes ``max(t - samples, 0)``
    clip differently per track near the session start (reference
    database.py:713-1053)."""
    if not isinstance(samples, int) or samples < 0:
        raise ValueError(f'context must be a non-negative int: {samples!r}')

    def add(ex):
        ex['start'] = _nest_map(lambda t: max(t - samples, 0), ex['start'])
        if equal_start_context:
            deltas = []
            _nest_map(lambda s, so: deltas.append(so - s), ex['start'],
                      ex['start_orig'])
            smallest = min(deltas)
            ex['start'] = _nest_map(lambda so: max(so - smallest, 0),
                                    ex['start_orig'])
        ex['end'] = _nest_map(lambda t: t + samples, ex['end'])
        ex['num_samples'] = _nest_map(lambda s, e: e - s, ex['start'],
                                      ex['end'])
        return ex

    return add


def _read_tree(paths, start, end):
    if isinstance(paths, dict):
        return {k: _read_tree(v, start[k], end[k]) for k, v in paths.items()}
    return load_audio(paths, start=start, stop=end)


def read_audio(ex):
    """Every track of ``audio_path`` over its own [start, end) into
    ``audio_data``, float64 (reference database.py:133-175)."""
    ex['audio_data'] = _read_tree(ex['audio_path'], ex['start'], ex['end'])
    return ex
