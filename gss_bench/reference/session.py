"""What the reference's readings of a session share, whatever the
corpus's layout and clock: an utterance as the reference reads it
(:class:`Utterance`), exact time strings, utterance ids, STFT frame
counts and the class activity of an utterance's frames.  Each deployment
reads its own corpus into them (``gss_bench/deployments/<name>.py``'s
``load_session``), with no code of the program under test.
"""

import dataclasses
from decimal import Decimal

import numpy as np

__all__ = ['SAMPLE_RATE', 'Utterance', 'to_samples', 'example_id',
           'stft_frames', 'frame_activity']

SAMPLE_RATE = 16000


def to_samples(time):
    """'H:MM:SS.fffffff' -> samples at 16 kHz, exactly."""
    hours, minutes, seconds = time.split(':')
    samples = Decimal(seconds) * SAMPLE_RATE
    if samples != int(samples):
        raise ValueError(f'{time} is not a whole sample')
    return (int(hours) * 3600 + int(minutes) * 60) * SAMPLE_RATE \
        + int(samples)


def example_id(speaker, session_id, start, end):
    return (f'{speaker}_{session_id}_{start * 100 // SAMPLE_RATE:07d}-'
            f'{end * 100 // SAMPLE_RATE:07d}')


def stft_frames(samples, size, shift):
    """Frames of a ``samples`` span with ``size - shift`` samples of fading
    at both ends and the tail padded to a whole frame."""
    return max(1, -(-(samples + 2 * (size - shift) - size + shift) // shift))


@dataclasses.dataclass
class Utterance:
    example_id: str
    speaker: str
    target: int                  # index of the speaker among the classes
    spans: list                  # [(array, start, stop)] in stacking order
    paths: dict                  # array -> [channel WAV paths]
    num_samples: int             # observation length (shortest array)
    activity_span: tuple         # (start, stop) on the reference array
    trim: tuple                  # (start, samples) of the emitted span
    context_frames: tuple        # (start, end) frames of context
    emitted_seconds: float


def frame_activity(utt, intervals, config):
    """(K, T) bool class activity of the utterance's frames: each speaker's
    intervals on the reference array inside its span, then the noise class
    (active everywhere); a frame is active where any sample under its
    window is."""
    session, enhancer = config['session'], config['enhancer']
    size, shift = enhancer['stft_size'], enhancer['stft_shift']
    lo, hi = utt.activity_span
    per_speaker = intervals[session['reference_array']]
    rows = []
    for speaker in session['speakers']:
        row = np.zeros(hi - lo, bool)
        for s, e in per_speaker[speaker]:
            if e > lo and s < hi:
                row[max(s, lo) - lo:min(e, hi) - lo] = True
        rows.append(row)
    if enhancer['activity_garbage_class'] is not True:
        raise NotImplementedError('the reference has an always-active '
                                  'noise class only')
    rows.append(np.ones(hi - lo, bool))
    samples = np.pad(np.array(rows), [(0, 0), (size - shift, size - shift)])
    frames = stft_frames(hi - lo, size, shift)
    full = (frames - 1) * shift + size
    samples = np.pad(samples, [(0, 0), (0, max(0, full - samples.shape[1]))])
    windows = np.lib.stride_tricks.sliding_window_view(
        samples, size, axis=1)[:, ::shift][:, :frames]
    return windows.any(axis=-1)
