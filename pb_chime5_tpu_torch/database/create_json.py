"""Build the database JSON from a CHiME-5/6 corpus tree.

Behavioural rebuild of pb_chime5/database/chime5/create_json.py: walks
``<db>/transcriptions/<dataset>/<session>.json``, converts 'H:MM:SS.f'
times to samples exactly (Decimal, reference get_speaker_activity.py:
80-135), and emits ``{datasets: {session_id: {example_id: example}},
alias: {train/dev/eval: [session_ids]}}``.

Example dicts carry the nested start/end/num_samples trees
({'observation': {U: int}, 'worn': {P: int}, 'original': int} for CHiME-5,
flat ints for CHiME-6), per-array channel wav path lists, speaker/gender/
location/reference-array metadata, and notes about known missing arrays
(reference create_json.py:306-475).

CLI:  python -m pb_chime5_tpu_torch.database.create_json \
          --database-path CHiME5 --json-path cache/chime5.json [--chime6]

The port's copy of ``pb_chime5_tpu/database/create_json.py``.
"""

import argparse
import concurrent.futures
import logging
import os
from decimal import Decimal
from pathlib import Path

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.database import keys
from pb_chime5_tpu_torch.io import dump_json, load_json

LOG = logging.getLogger('create_json')

SAMPLE_RATE = 16000
NUM_MICS = 4
NUM_ARRAYS = 6

# One CHiME-5 utterance has negative length and is excluded at build time
# (reference create_json.py:290-295).
EXCLUDED_EXAMPLE_IDS = frozenset({
    'P45_S21_0356170-0356149',     # CHiME-5 id style
    'P45_S21-0356170-0356149',     # CHiME-6 id style
})

FEMALE_SPEAKERS = frozenset({
    # gender metadata is cosmetic for the front-end; the reference keeps a
    # hand-curated list (create_json.py FEMALE_SPEAKER) — absent here, all
    # speakers default to 'male' unless listed.
})

# Arrays missing from the corpus, per session (reference
# create_json.py:374-394 + known-issues of the chime6 synchronization).
MISSING_ARRAYS_CHIME5 = {
    'S05': ['U03'], 'S22': ['U03'], 'S09': ['U05'],
}
MISSING_ARRAYS_CHIME6 = {
    'S01': ['U03'], 'S05': ['U03', 'U04'], 'S22': ['U03'], 'S09': ['U05'],
}


def to_samples(time: str) -> int:
    """'H:MM:SS.fffffff' -> samples at 16 kHz, exact (Decimal)."""
    hours, minutes, seconds = time.split(':')
    seconds_samples = Decimal(seconds) * SAMPLE_RATE
    assert seconds_samples == int(seconds_samples), (time, seconds_samples)
    return (int(hours) * 3600 * SAMPLE_RATE
            + int(minutes) * 60 * SAMPLE_RATE
            + int(seconds_samples))


def transform_times(tree, chime6=False):
    """Recursively convert every time string in a transcription entry."""
    if chime6:
        return int(tree)
    if isinstance(tree, dict):
        return {k: transform_times(v) for k, v in tree.items()}
    return to_samples(tree)


def get_example_id(*, start_sample, end_sample, session_id, speaker_id,
                   chime6):
    """Utterance id with start/end in hundredths of seconds, zfilled to 7
    ('P05_S02_0004060-0004382'; CHiME-6 uses 'P05_S02-0004060-0004382')."""
    s = f'{start_sample * 100 // SAMPLE_RATE}'.zfill(7)
    e = f'{end_sample * 100 // SAMPLE_RATE}'.zfill(7)
    if chime6:
        return f'{speaker_id}_{session_id}-{s}-{e}'
    return f'{speaker_id}_{session_id}_{s}-{e}'


def _arrays_for_session(session_id, chime6):
    arrays = [f'U0{i + 1}' for i in range(NUM_ARRAYS)]
    missing = (MISSING_ARRAYS_CHIME6 if chime6
               else MISSING_ARRAYS_CHIME5).get(session_id, [])
    return [a for a in arrays if a not in missing], missing


def get_example(transcription, audio_path, chime6=False,
                available_arrays=None):
    session_id = transcription['session_id']
    dataset = mapping.session_to_dataset[session_id]
    notes = []

    speaker_ids = mapping.session_to_speakers[session_id]
    speaker_id = transcription.get('speaker', 'unknown')
    if speaker_id == 'unknown':
        notes.append('target_speaker_id is missing')

    start_time = transform_times(transcription['start_time'], chime6)
    end_time = transform_times(transcription['end_time'], chime6)

    if chime6:
        start_sample, end_sample = start_time, end_time
    else:
        start_sample = start_time['original']
        end_sample = end_time['original']

    example_id = get_example_id(
        start_sample=start_sample, end_sample=end_sample,
        session_id=session_id, speaker_id=speaker_id, chime6=chime6)

    arrays, missing = _arrays_for_session(session_id, chime6)
    for a in missing:
        notes.append(f'Array {a} is missing, this is expected')
    if available_arrays is not None:
        arrays = [a for a in arrays if a in available_arrays]

    audio_dir = Path(audio_path)
    audio_path_dict = {
        keys.OBSERVATION: {
            array: [str(audio_dir / f'{session_id}_{array}.CH{m}.wav')
                    for m in range(1, 1 + NUM_MICS)]
            for array in arrays
        },
    }
    worn = {} if dataset == 'eval' else {
        'worn': {spk: str(audio_dir / f'{session_id}_{spk}.wav')
                 for spk in speaker_ids}
    }
    audio_path_dict.update(worn)

    if chime6:
        start_dict = start_time
        end_dict = end_time
        num_samples = end_time - start_time
    else:
        def project(time_tree):
            d = {keys.OBSERVATION: {a: time_tree[a] for a in arrays
                                    if a in time_tree}}
            if dataset != 'eval':
                d['worn'] = {s: time_tree[s] for s in speaker_ids
                             if s in time_tree}
            d['original'] = time_tree['original']
            return d

        start_dict = project(start_time)
        end_dict = project(end_time)
        # arrays present in the mapping but absent from this utterance's
        # transcription are dropped for this example
        present = sorted(start_dict[keys.OBSERVATION].keys())
        for a in arrays:
            if a not in present:
                del audio_path_dict[keys.OBSERVATION][a]
                notes.append(f'Array {a} is missing, this may be expected')
        num_samples = _tree_sub(end_dict, start_dict)

    gender = 'female' if speaker_id in FEMALE_SPEAKERS else 'male'

    example = {
        'session_id': session_id,
        keys.NUM_SAMPLES: num_samples,
        keys.AUDIO_PATH: audio_path_dict,
        'notes': notes,
        keys.START: start_dict,
        keys.END: end_dict,
        keys.TRANSCRIPTION: transcription['words'],
    }
    if speaker_id != 'unknown':
        example[keys.SPEAKER_ID] = speaker_id
        example[keys.GENDER] = gender
    location = transcription.get('location', 'unknown')
    if location != 'unknown':
        example['location'] = location
    ref_array = transcription.get('ref', 'unknown')
    if ref_array != 'unknown':
        example['reference_array'] = ref_array
    return example_id, example


def _tree_sub(end, start):
    if isinstance(end, dict):
        return {k: _tree_sub(end[k], start[k]) for k in end}
    return end - start


def create_database(database_path, chime6=False, num_workers=None):
    """Walk the corpus tree -> database dict."""
    database_path = Path(database_path)
    datasets = {}
    alias = {}
    for dataset_dir in sorted(
            (database_path / 'transcriptions').glob('*')):
        dataset = dataset_dir.name
        audio_dir = database_path / 'audio' / dataset
        session_ids = []
        for session_path in sorted(dataset_dir.glob('*.json')):
            session_id = session_path.name.split('.')[0]
            transcriptions = load_json(session_path)
            assert len(transcriptions) > 0, session_path
            available_arrays = {
                p.name.split('.')[0].split('_')[1]
                for p in audio_dir.glob(f'{session_id}_U*.CH1.wav')
            } or None
            examples = {}
            with concurrent.futures.ThreadPoolExecutor(
                    num_workers or os.cpu_count()) as pool:
                for example_id, example in pool.map(
                        lambda t: get_example(
                            t, audio_dir, chime6,
                            available_arrays=available_arrays),
                        transcriptions):
                    if example_id in EXCLUDED_EXAMPLE_IDS:
                        continue
                    examples[example_id] = example
            datasets[session_id] = examples
            session_ids.append(session_id)
        alias[dataset] = session_ids
    return {keys.DATASETS: datasets, keys.ALIAS: alias}


def check_audio_files_exist(database_dict):
    """Assert every referenced audio file exists (reference
    database/helper.py:53-125)."""
    missing = []

    def visit(tree):
        if isinstance(tree, dict):
            for v in tree.values():
                visit(v)
        elif isinstance(tree, (list, tuple)):
            for v in tree:
                visit(v)
        elif isinstance(tree, str) and tree.endswith('.wav'):
            if not Path(tree).exists():
                missing.append(tree)

    for session in database_dict[keys.DATASETS].values():
        for example in session.values():
            visit(example.get(keys.AUDIO_PATH, {}))
    assert not missing, f'missing audio files: {missing[:10]}'


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', type=Path, required=True)
    parser.add_argument('--json-path', type=Path, required=True)
    parser.add_argument('--chime6', action='store_true')
    parser.add_argument('--skip-check', action='store_true')
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    db = create_database(args.database_path, chime6=args.chime6)
    if not args.skip_check:
        check_audio_files_exist(db)
    dump_json(db, args.json_path)
    n = sum(len(v) for v in db[keys.DATASETS].values())
    LOG.info('wrote %s (%d sessions, %d examples)', args.json_path,
             len(db[keys.DATASETS]), n)


if __name__ == '__main__':
    main()
