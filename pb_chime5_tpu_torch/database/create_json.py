"""Build the database JSON from a CHiME-5 or CHiME-6 corpus tree —
``pb_chime5_tpu.database.create_json`` (reference
pb_chime5/database/chime5/create_json.py).

Walks ``<db>/transcriptions/<dataset>/<session>.json`` and returns
``{datasets: {session_id: {example_id: example}}, alias: {dataset:
[session_ids]}}``.  CHiME-5 times are 'H:MM:SS.f' strings per track,
converted to 16 kHz samples exactly into the nested start / end /
num_samples trees; CHiME-6 times are integer samples on one global clock
and stay flat ints (``chime6=True``, ids 'P05_S02-0004060-0004382').

    python -m pb_chime5_tpu_torch.database.create_json \
        --database-path CHiME5 --json-path cache/chime5.json [--chime6]
"""

import argparse
from decimal import Decimal
from pathlib import Path

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.io import dump_json, load_json

__all__ = ['create_database', 'to_samples']

SAMPLE_RATE = 16000
NUM_MICS = 4
NUM_ARRAYS = 6
# the one utterance of negative length, in either corpus's id style
# (reference create_json.py:290-295)
EXCLUDED_EXAMPLE_IDS = frozenset({'P45_S21_0356170-0356149',
                                  'P45_S21-0356170-0356149'})
# arrays missing from the corpus (reference create_json.py:374-394 and the
# CHiME-6 synchronization's known issues)
MISSING_ARRAYS_CHIME5 = {'S05': ['U03'], 'S22': ['U03'], 'S09': ['U05']}
MISSING_ARRAYS_CHIME6 = {'S01': ['U03'], 'S05': ['U03', 'U04'],
                         'S22': ['U03'], 'S09': ['U05']}


def to_samples(time: str) -> int:
    """'H:MM:SS.fffffff' -> samples at 16 kHz, exactly."""
    hours, minutes, seconds = time.split(':')
    seconds_samples = Decimal(seconds) * SAMPLE_RATE
    assert seconds_samples == int(seconds_samples), (time, seconds_samples)
    return (int(hours) * 3600 + int(minutes) * 60) * SAMPLE_RATE \
        + int(seconds_samples)


def _example(transcription, audio_dir, available_arrays, chime6):
    session_id = transcription['session_id']
    dataset = mapping.session_to_dataset[session_id]
    speaker_ids = mapping.session_to_speakers[session_id]
    speaker_id = transcription.get('speaker', 'unknown')
    notes = ['target_speaker_id is missing'] if speaker_id == 'unknown' \
        else []
    if chime6:
        start = int(transcription['start_time'])
        end = int(transcription['end_time'])
        start_sample, end_sample = start, end
    else:
        start = {k: to_samples(v)
                 for k, v in transcription['start_time'].items()}
        end = {k: to_samples(v) for k, v in transcription['end_time'].items()}
        start_sample, end_sample = start['original'], end['original']
    example_id = '{}_{}{}{}-{}'.format(
        speaker_id, session_id, '-' if chime6 else '_',
        f'{start_sample * 100 // SAMPLE_RATE}'.zfill(7),
        f'{end_sample * 100 // SAMPLE_RATE}'.zfill(7))

    missing = (MISSING_ARRAYS_CHIME6 if chime6
               else MISSING_ARRAYS_CHIME5).get(session_id, [])
    notes += [f'Array {a} is missing, this is expected' for a in missing]
    arrays = [f'U0{i + 1}' for i in range(NUM_ARRAYS)
              if f'U0{i + 1}' not in missing]
    if available_arrays is not None:
        arrays = [a for a in arrays if a in available_arrays]
    if not chime6:
        for a in arrays:
            if a not in start:
                notes.append(f'Array {a} is missing, this may be expected')
        arrays = [a for a in arrays if a in start]

    audio_path = {'observation': {
        a: [str(audio_dir / f'{session_id}_{a}.CH{m}.wav')
            for m in range(1, 1 + NUM_MICS)]
        for a in arrays}}
    if dataset != 'eval':
        audio_path['worn'] = {s: str(audio_dir / f'{session_id}_{s}.wav')
                              for s in speaker_ids}

    def project(times):
        tree = {'observation': {a: times[a] for a in arrays}}
        if dataset != 'eval':
            tree['worn'] = {s: times[s] for s in speaker_ids if s in times}
        tree['original'] = times['original']
        return tree

    def duration(end, start):
        if isinstance(end, dict):
            return {k: duration(end[k], start[k]) for k in end}
        return end - start

    if not chime6:
        start, end = project(start), project(end)
    example = {
        'session_id': session_id,
        'num_samples': duration(end, start),
        'audio_path': audio_path,
        'notes': notes,
        'start': start,
        'end': end,
        'transcription': transcription['words'],
    }
    if speaker_id != 'unknown':
        example['speaker_id'] = speaker_id
        example['gender'] = 'male'
    for key, name in (('location', 'location'), ('ref', 'reference_array')):
        if transcription.get(key, 'unknown') != 'unknown':
            example[name] = transcription[key]
    return example_id, example


def create_database(database_path, chime6=False):
    """Walk the corpus tree -> database dict (``chime6``: a CHiME-6 tree,
    flat integer times)."""
    database_path = Path(database_path)
    datasets, alias = {}, {}
    for dataset_dir in sorted((database_path / 'transcriptions').glob('*')):
        audio_dir = database_path / 'audio' / dataset_dir.name
        alias[dataset_dir.name] = []
        for session_path in sorted(dataset_dir.glob('*.json')):
            session_id = session_path.name.split('.')[0]
            transcriptions = load_json(session_path)
            assert transcriptions, session_path
            available_arrays = {
                p.name.split('.')[0].split('_')[1]
                for p in audio_dir.glob(f'{session_id}_U*.CH1.wav')} or None
            examples = {}
            for t in transcriptions:
                example_id, example = _example(t, audio_dir, available_arrays,
                                               chime6)
                if example_id not in EXCLUDED_EXAMPLE_IDS:
                    examples[example_id] = example
            datasets[session_id] = examples
            alias[dataset_dir.name].append(session_id)
    return {'datasets': datasets, 'alias': alias}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', type=Path, required=True)
    parser.add_argument('--json-path', type=Path, required=True)
    parser.add_argument('--chime6', action='store_true')
    args = parser.parse_args(argv)
    dump_json(create_database(args.database_path, chime6=args.chime6),
              args.json_path)


if __name__ == '__main__':
    main()
