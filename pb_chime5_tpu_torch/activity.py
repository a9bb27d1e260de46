"""Rasterize utterance annotations into speaker activity — the port of
``pb_chime5_tpu/activity.py`` (reference pb_chime5/activity.py:8-404).

``get_activity`` returns ``{session: {perspective: {speaker: track}}}``,
where a perspective is

* ``'array'`` (the enhancer's): one per microphone array ('U01', ...) on
  that array's (drift-adjusted) clock,
* ``'worn'``: one per worn mic ('P05', ...),
* ``'global_worn'``: a single 'P' perspective on each utterance's own
  speaker's worn-mic clock,
* or an explicit perspective name or list of them.

``get_activity_chime6`` returns ``{session: {speaker: track}}`` of
``CHIME6_MAX_NUM_SAMPLES`` on CHiME-6's one global clock (long enough for
any session; the caller slices).  A track is an ``ArrayInterval``
(``use_ArrayIntervall``, the default) or a dense array of ``dtype``.  Both
add a noise class: ``garbage_class`` True -> an always-on 'Noise' track,
False -> an always-off one, None -> none, int n -> n always-on 'Noise<i>'
tracks.

``non_sil_alignment_fn(ex, perspective_mic_array)`` refines an
utterance's span with a sample-level non-silence mask (Kaldi alignments,
``activity_alignment.py``); where it returns scalar 1 the alignment was
missing, and more than half the utterances of a session missing raises
(reference activity.py:201-221).
"""

import functools

import numpy as np

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.utils import ArrayInterval, Dispatcher

__all__ = ['get_activity', 'get_activity_chime6', 'CHIME6_MAX_NUM_SAMPLES']

# 10 h at 16 kHz (reference activity.py:344)
CHIME6_MAX_NUM_SAMPLES = 60 * 60 * 16000 * 10


def _zeros_ones(use_array_interval, dtype):
    if not use_array_interval:
        return (functools.partial(np.zeros, dtype=dtype),
                functools.partial(np.ones, dtype=dtype))
    assert dtype == bool, dtype

    def ones(shape):
        track = ArrayInterval(shape)
        track[:] = 1
        return track
    return ArrayInterval, ones


def _add_garbage_class(tracks, garbage_class, num_samples, zeros, ones):
    if garbage_class is True:
        tracks['Noise'] = ones([num_samples])
    elif garbage_class is False:
        tracks['Noise'] = zeros([num_samples])
    elif garbage_class is None:
        pass
    elif isinstance(garbage_class, int) and garbage_class > 0:
        for i in range(garbage_class):
            tracks[f'Noise{i}'] = ones([num_samples])
    else:
        raise ValueError(garbage_class)


def _perspectives(perspective, session_id):
    if perspective == 'worn':
        return mapping.session_to_speakers[session_id]
    if perspective == 'global_worn':
        return ['P']
    if perspective == 'array':
        # the table already leaves out missing arrays
        return mapping.session_to_arrays[session_id]
    if isinstance(perspective, (tuple, list)):
        return perspective
    return [perspective]


def get_activity(iterator, *, perspective='array', garbage_class,
                 dtype=bool, non_sil_alignment_fn=None, debug=False,
                 use_ArrayIntervall=True):
    """``debug`` is accepted for the reference's signature and unused."""
    zeros, ones = _zeros_ones(use_ArrayIntervall, dtype)
    activity = Dispatcher()
    for session_id, examples in iterator.groupby(
            lambda ex: ex['session_id']).items():
        speakers = mapping.session_to_speakers[session_id]
        perspectives = _perspectives(perspective, session_id)
        per_view = activity[session_id] = Dispatcher()
        for p in perspectives:
            n = mapping.session_array_to_num_samples[f'{session_id}_{p}']
            tracks = per_view[p] = Dispatcher(
                {s: zeros([n]) for s in speakers})
            _add_garbage_class(tracks, garbage_class, n, zeros, ones)

        missing = 0
        for ex in examples:
            if ex['transcription'] == '[redacted]':
                continue
            speaker = ex['speaker_id']
            for p in perspectives:
                mic = speaker if p == 'P' else p
                if mic.startswith('P'):
                    start, end = ex['start']['worn'][mic], \
                        ex['end']['worn'][mic]
                elif mic in ex['audio_path']['observation']:
                    start, end = ex['start']['observation'][mic], \
                        ex['end']['observation'][mic]
                else:
                    continue
                value = 1
                if non_sil_alignment_fn is not None:
                    value = non_sil_alignment_fn(ex, mic)
                    if np.isscalar(value) and value == 1:
                        missing += 1
                per_view[p][speaker][start:end] = value

        if missing > len(examples) // 2:
            raise RuntimeError(
                f'Expected at most {len(examples) // 2} missing finetuned '
                f'annotations for session {session_id}, got {missing} — '
                f'assume something went wrong.')
    return activity


def get_activity_chime6(iterator, *, garbage_class, dtype=bool,
                        non_sil_alignment_fn=None, debug=False,
                        use_ArrayIntervall=True):
    """No alignment refinement on CHiME-6's clock (as in the JAX package):
    a ``non_sil_alignment_fn`` raises ``NotImplementedError``."""
    zeros, ones = _zeros_ones(use_ArrayIntervall, dtype)
    activity = Dispatcher()
    for session_id, examples in iterator.groupby(
            lambda ex: ex['session_id']).items():
        tracks = activity[session_id] = Dispatcher({
            s: zeros([CHIME6_MAX_NUM_SAMPLES])
            for s in mapping.session_to_speakers[session_id]})
        _add_garbage_class(tracks, garbage_class, CHIME6_MAX_NUM_SAMPLES,
                           zeros, ones)
        for ex in examples:
            if ex['transcription'] == '[redacted]':
                continue
            if non_sil_alignment_fn is not None:
                raise NotImplementedError(non_sil_alignment_fn)
            tracks[ex['speaker_id']][ex['start']:ex['end']] = 1
    return activity
