"""The reference's own reading of a CHiME-5 session: from the
transcription JSON and the array WAVs to, per utterance, the observation
spans, the class activity, the context frames and the output trim.

Written from the upstream recipe (pb_chime5 ``database.py``: the array
clock's duration equalized to the worn clock's, ``AddContext`` with equal
start context; ``activity.py``: per-speaker activity on each array's clock
from the transcription's times, plus an always-active noise class;
``core.py``: multi-array stacking in array order, the shortest array
sets the length), with no code of the program under test.
"""

import dataclasses
from decimal import Decimal
from pathlib import Path

import numpy as np

from gss_bench.reference import wav

__all__ = ['Utterance', 'load_session', 'to_samples', 'example_id',
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


def _adjust(worn, array):
    """The array span's duration set to the worn span's, the difference
    split over both ends."""
    (ws, we), (s, e) = worn, array
    worn_duration, array_duration = we - ws, e - s
    delta = abs(worn_duration - array_duration)
    if worn_duration > array_duration:
        return s - delta // 2, e + (delta + 1) // 2
    if worn_duration < array_duration:
        return s + delta // 2, e - (delta + 1) // 2
    return s, e


def load_session(corpus_root, config):
    """{example_id: :class:`Utterance`} and the per-speaker activity
    intervals {array: {speaker: [(start, stop)]}} of the configuration's
    session."""
    session = config['session']
    enhancer = config['enhancer']
    sid, dataset = session['session_id'], session['dataset']
    speakers = session['speakers']
    ref = session['reference_array']
    context = enhancer['context_samples']
    size, shift = enhancer['stft_size'], enhancer['stft_shift']
    audio_dir = Path(corpus_root) / 'audio' / dataset
    present = sorted(a for a in session['arrays']
                     if (audio_dir / f'{sid}_{a}.CH1.wav').exists())
    stacked = present if enhancer['multiarray'] else [ref]
    paths = {a: [audio_dir / f'{sid}_{a}.CH{m + 1}.wav'
                 for m in range(session['mics_per_array'])] for a in present}
    file_length = {a: min(wav.num_frames(p) for p in ps)
                   for a, ps in paths.items()}

    import json
    trans = json.loads((Path(corpus_root) / 'transcriptions' / dataset
                        / f'{sid}.json').read_text())
    intervals = {a: {s: [] for s in speakers} for a in present}
    utterances = {}
    for entry in trans:
        if entry['words'] == '[redacted]':
            continue
        start = {k: to_samples(v) for k, v in entry['start_time'].items()}
        end = {k: to_samples(v) for k, v in entry['end_time'].items()}
        speaker = entry['speaker']
        for a in present:
            intervals[a][speaker].append((start[a], end[a]))
        worn = (start['original'], end['original'])
        # every track of the example: the arrays (clock-equalized), the
        # worn microphones and the original times
        tracks = {a: _adjust(worn, (start[a], end[a])) for a in present}
        tracks.update({p: (start[p], end[p]) for p in speakers})
        tracks['original'] = worn
        # equal start context: the context every track achieves
        achieved = min(s - max(s - context, 0) for s, _ in tracks.values())
        spans = [(a, max(tracks[a][0] - achieved, 0), tracks[a][1] + context)
                 for a in stacked]
        n = min(min(stop, file_length[a]) - begin for a, begin, stop in spans)
        ref_start = max(tracks[ref][0] - achieved, 0)
        eid = example_id(speaker, sid, *worn)
        utterances[eid] = Utterance(
            example_id=eid, speaker=speaker, target=speakers.index(speaker),
            spans=spans, paths={a: paths[a] for a in stacked},
            num_samples=n,
            activity_span=(ref_start, tracks[ref][1] + context),
            trim=(tracks[ref][0] - ref_start, worn[1] - worn[0]),
            context_frames=(stft_frames(worn[0] - max(worn[0] - achieved, 0),
                                        size, shift),
                            stft_frames(context, size, shift)),
            emitted_seconds=(worn[1] - worn[0]) / SAMPLE_RATE)
    return utterances, intervals


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
