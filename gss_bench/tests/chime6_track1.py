"""A CHiME-6 track-1 deployment, added as a file as a later change would
add one: ``harness_util.tiny_copy`` writes it into a copy's
``gss_bench/deployments/``, and the copy's ``tiny_chime6`` configuration
names it.

Upstream's CHiME-6 use of pb_chime5 (Kaldi's
``egs/chime6/s5_track1/local/run_gss.sh``: ``pb_chime5.scripts.kaldi_run
with chime6=True multiarray=outer_array_mics``), read through the port's
``models/enhancer_chime6.py::get_enhancer`` on ``create_database(...,
chime6=True)``.

The corpus: every array's four channels
(``<root>/audio/<dataset>/<S>_<U>.CH<m>.wav``), synchronized to one
global clock (no drift), and ``<root>/transcriptions/<dataset>/<S>.json``
with one flat integer start and end (samples on the global clock) an
utterance.

The reference's reading (upstream's ``core_chime6.py``): each array's
outer microphones, CH1 and CH4, stacked in array order over
``[start - context, end + context]`` (clipped at 0; the shortest array
sets the length), no clock equalization and no equal start context; the
activity on the global clock.
"""

import json
from pathlib import Path

import numpy as np

from gss_bench import corpus
from gss_bench.deployments import enhancer_kwargs
from gss_bench.reference import wav
from gss_bench.reference.session import SAMPLE_RATE, Utterance, stft_frames

__all__ = ['corpus_dir', 'write_corpus', 'load_session', 'open_enhancer',
           'session_time']

corpus_dir = 'CHiME6'
OUTER_MICS = (0, -1)     # the channels of each array that are stacked


def write_corpus(root, config, traffic, seed, device):
    """Write every array's WAVs and the session's transcription under
    ``root``."""
    session = config['session']
    sid, dataset = session['session_id'], session['dataset']
    rng = np.random.default_rng([seed, 0])
    turns = corpus.session_turns(config, traffic, rng)
    root = Path(root)
    audio_dir = root / 'audio' / dataset
    trans_dir = root / 'transcriptions' / dataset
    audio_dir.mkdir(parents=True, exist_ok=True)
    trans_dir.mkdir(parents=True, exist_ok=True)
    for array, pcm in corpus.array_pcm16(
            config, turns, seed, device, {a: 0 for a in session['arrays']}):
        for m in range(len(pcm)):
            corpus.write_pcm16(audio_dir / f'{sid}_{array}.CH{m + 1}.wav',
                               pcm[m])
    trans = [{'session_id': sid, 'speaker': session['speakers'][k],
              'words': f'utterance {i}', 'start_time': start,
              'end_time': end, 'location': session['location'],
              'ref': session['reference_array']}
             for i, (k, start, end) in enumerate(turns)]
    (trans_dir / f'{sid}.json').write_text(json.dumps(trans, indent=1))


def _example_id(speaker, session_id, start, end):
    return (f'{speaker}_{session_id}-{start * 100 // SAMPLE_RATE:07d}-'
            f'{end * 100 // SAMPLE_RATE:07d}')


def load_session(root, config):
    """{example_id: :class:`Utterance`} and the per-speaker activity
    intervals, the same for every array: {array: {speaker: [(start,
    stop)]}}."""
    session, enhancer = config['session'], config['enhancer']
    if enhancer['multiarray'] != 'outer_array_mics':
        raise NotImplementedError('the CHiME-6 track-1 reading stacks the '
                                  'outer microphones only')
    sid, dataset = session['session_id'], session['dataset']
    speakers = session['speakers']
    context = enhancer['context_samples']
    size, shift = enhancer['stft_size'], enhancer['stft_shift']
    audio_dir = Path(root) / 'audio' / dataset
    arrays = sorted(a for a in session['arrays']
                    if (audio_dir / f'{sid}_{a}.CH1.wav').exists())
    mics = range(1, session['mics_per_array'] + 1)
    paths = {a: [audio_dir / f'{sid}_{a}.CH{mics[m]}.wav'
                 for m in OUTER_MICS] for a in arrays}
    file_length = {a: min(wav.num_frames(p) for p in ps)
                   for a, ps in paths.items()}
    trans = json.loads((Path(root) / 'transcriptions' / dataset
                        / f'{sid}.json').read_text())
    per_speaker = {s: [] for s in speakers}
    utterances = {}
    for entry in trans:
        if entry['words'] == '[redacted]':
            continue
        speaker, start, end = (entry['speaker'], int(entry['start_time']),
                               int(entry['end_time']))
        per_speaker[speaker].append((start, end))
        begin = max(start - context, 0)
        spans = [(a, begin, end + context) for a in arrays]
        eid = _example_id(speaker, sid, start, end)
        utterances[eid] = Utterance(
            example_id=eid, speaker=speaker, target=speakers.index(speaker),
            spans=spans, paths=paths,
            num_samples=min(min(stop, file_length[a]) - b
                            for a, b, stop in spans),
            activity_span=(begin, end + context),
            trim=(start - begin, end - start),
            context_frames=(stft_frames(start - begin, size, shift),
                            stft_frames(context, size, shift)),
            emitted_seconds=(end - start) / SAMPLE_RATE)
    return utterances, {a: per_speaker for a in arrays}


def open_enhancer(workdir, root, config, device):
    """The program's CHiME-6 database of ``root`` in
    ``workdir/chime6.json`` and the CHiME-6 ``get_enhancer`` on it (which
    takes no ``device_trim``: the enhancer trims on the device)."""
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    from pb_chime5_tpu_torch.models.enhancer_chime6 import get_enhancer
    kwargs = enhancer_kwargs(config)
    if kwargs.pop('device_trim', True) is not True:
        raise NotImplementedError('the CHiME-6 factory trims on the device')
    database = Path(workdir) / 'chime6.json'
    dump_json(create_database(root, chime6=True), database)
    return get_enhancer(database_path=str(database), device=device,
                        **kwargs)


def session_time(ex):
    """An utterance's start on the global clock."""
    return ex['start']
