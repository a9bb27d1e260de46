"""The CHiME-5 deployment: upstream's ``pb_chime5`` recipe on a CHiME-5
corpus (``scripts/kaldi_run.py``, ``get_enhancer`` in ``core.py``), read
through the port's ``models/enhancer.py::get_enhancer``.

The corpus: ``<root>/audio/<dataset>/<S>_<U>.CH<m>.wav`` for the arrays
the configuration reads and ``<root>/transcriptions/<dataset>/<S>.json``.
Each array's clock runs ahead of the worn clock by its own drift and the
transcription's array times carry a few samples of jitter, so the
database's clock correction and equal start context have work to do.
The transcription is the same for every configuration.

The reference's reading, written from the upstream recipe (pb_chime5
``database.py``: the array clock's duration equalized to the worn clock's,
``AddContext`` with equal start context; ``activity.py``: per-speaker
activity on each array's clock from the transcription's times, plus an
always-active noise class; ``core.py``: multi-array stacking in array
order, the shortest array sets the length), with no code of the program
under test.
"""

import json
from pathlib import Path

import numpy as np

from gss_bench import corpus
from gss_bench.deployments import enhancer_kwargs
from gss_bench.reference import wav
from gss_bench.reference.session import (
    SAMPLE_RATE, Utterance, example_id, stft_frames, to_samples)

__all__ = ['corpus_dir', 'write_corpus', 'load_session', 'open_enhancer',
           'session_time']

corpus_dir = 'CHiME5'
JITTER = 3               # samples, each array time of the transcription
DRIFT = (100, 500)       # samples, each array's clock ahead of the worn


def write_corpus(root, config, traffic, seed, device):
    """Write the session's array WAVs and its transcription under
    ``root``."""
    session = config['session']
    sid, dataset = session['session_id'], session['dataset']
    speakers, arrays = session['speakers'], session['arrays']
    read = (arrays if config['enhancer']['multiarray']
            else [session['reference_array']])
    rng = np.random.default_rng([seed, 0])
    turns = corpus.session_turns(config, traffic, rng)
    drifts = {a: int(rng.integers(*DRIFT)) for a in arrays}
    jitter = rng.integers(-JITTER, JITTER + 1, (len(turns), len(arrays), 2))

    root = Path(root)
    audio_dir = root / 'audio' / dataset
    trans_dir = root / 'transcriptions' / dataset
    audio_dir.mkdir(parents=True, exist_ok=True)
    trans_dir.mkdir(parents=True, exist_ok=True)
    for array, pcm in corpus.array_pcm16(config, turns, seed, device,
                                         {a: drifts[a] for a in read}):
        for m in range(len(pcm)):
            corpus.write_pcm16(audio_dir / f'{sid}_{array}.CH{m + 1}.wav',
                               pcm[m])

    trans = []
    for i, (k, start, end) in enumerate(turns):
        speaker = speakers[k]
        times = [{'original': corpus.samples_to_time_str(t)}
                 for t in (start, end)]
        for side, t in enumerate((start, end)):
            for p in speakers:
                times[side][p] = corpus.samples_to_time_str(t)
            for a, array in enumerate(arrays):
                times[side][array] = corpus.samples_to_time_str(
                    t + drifts[array] + int(jitter[i, a, side]))
        trans.append({'session_id': sid, 'speaker': speaker,
                      'words': f'utterance {i}', 'start_time': times[0],
                      'end_time': times[1], 'location': session['location'],
                      'ref': session['reference_array']})
    (trans_dir / f'{sid}.json').write_text(json.dumps(trans, indent=1))


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


def load_session(root, config):
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
    audio_dir = Path(root) / 'audio' / dataset
    present = sorted(a for a in session['arrays']
                     if (audio_dir / f'{sid}_{a}.CH1.wav').exists())
    stacked = present if enhancer['multiarray'] else [ref]
    paths = {a: [audio_dir / f'{sid}_{a}.CH{m + 1}.wav'
                 for m in range(session['mics_per_array'])] for a in present}
    file_length = {a: min(wav.num_frames(p) for p in ps)
                   for a, ps in paths.items()}

    trans = json.loads((Path(root) / 'transcriptions' / dataset
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


def open_enhancer(workdir, root, config, device):
    """The program's CHiME-5 database of ``root`` in
    ``workdir/chime5.json`` and ``get_enhancer`` on it."""
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    database = Path(workdir) / 'chime5.json'
    dump_json(create_database(root), database)
    return get_enhancer(database_path=str(database), device=device,
                        **enhancer_kwargs(config))


def session_time(ex):
    """An utterance's position on the session timeline (its earliest
    array start), the order the session-audio cache is filled in."""
    return min(ex['start']['observation'].values())
