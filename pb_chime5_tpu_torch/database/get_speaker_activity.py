"""Per-session speaker-activity + cross-talk interval JSON builder
(reference: pb_chime5/database/chime5/get_speaker_activity.py).

For every session this CLI collects, per speaker and per worn-mic
perspective, the utterance start/end sample lists, derives the pairwise
cross-talk (overlap) intervals, and dumps one JSON per session:

    {P05: {P05: {start: [...], end: [...]}, P06: {...}, ...},
     ...,
     cross_talk: {P05: {start: [...], end: [...]}, ...}}

    python -m pb_chime5_tpu_torch.database.get_speaker_activity \
        --database-path CHiME5 --json-path cache/speech_activity

The port's copy of ``pb_chime5_tpu/database/get_speaker_activity.py``.
"""

import argparse
import logging
from itertools import combinations
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.database.create_json import to_samples
from pb_chime5_tpu_torch.io import dump_json, load_json

LOG = logging.getLogger('get_speaker_activity')

__all__ = ['create_cross_talk_database', 'get_cross_talk_per_mic',
           'get_active_speaker', 'to_numpy']


def _speaker_time_dict(example, speaker_ids):
    return {
        speaker: dict(
            start=to_samples(example['start_time'][speaker]),
            end=to_samples(example['end_time'][speaker]))
        for speaker in speaker_ids
    }


def get_cross_talk(database_path, dataset, json_path):
    transcription_dir = Path(database_path) / 'transcriptions' / dataset
    for session_path in sorted(transcription_dir.glob('*.json')):
        trans = load_json(session_path)
        session_id = trans[0]['session_id']
        speaker_ids = [k for k in trans[0]['start_time'] if 'P' in k]
        out_dict = {
            speaker: {s: dict(start=[], end=[]) for s in speaker_ids}
            for speaker in speaker_ids
        }
        for example in trans:
            speaker_id = example.get('speaker')
            if speaker_id is None:
                continue
            times = _speaker_time_dict(example, speaker_ids)
            for mic, t in times.items():
                out_dict[speaker_id][mic]['start'].append(t['start'])
                out_dict[speaker_id][mic]['end'].append(t['end'])
        out_dict['cross_talk'] = get_cross_talk_per_mic(out_dict)
        dump_json(out_dict, Path(json_path) / f'{session_id}.json')
        LOG.info('wrote %s', Path(json_path) / f'{session_id}.json')


def get_cross_talk_per_mic(speaker_dict):
    """Pairwise overlap intervals, projected to every worn-mic clock
    (reference get_speaker_activity.py:153-184)."""
    cross_talk = {s: dict(start=[], end=[]) for s in speaker_dict}
    pairs = [list(map(str, c)) for c in combinations(speaker_dict, 2)]
    pairs += [c[::-1] for c in pairs]
    for active, second in pairs:
        active_mics = speaker_dict[active]
        second_mics = speaker_dict[second]
        for idx in range(len(active_mics[active]['start'])):
            s1 = active_mics[active]['start'][idx]
            e1 = active_mics[active]['end'][idx]
            second_on_active = second_mics[active]
            for idy in range(len(second_on_active['start'])):
                s2 = second_on_active['start'][idy]
                e2 = second_on_active['end'][idy]
                if s1 <= e2 and e1 >= s2:
                    for mic in speaker_dict:
                        cross_talk[mic]['start'].append(
                            active_mics[mic]['start'][idx] if s1 > s2
                            else second_mics[mic]['start'][idy])
                        cross_talk[mic]['end'].append(
                            active_mics[mic]['end'][idx] if e1 < e2
                            else second_mics[mic]['end'][idy])
    return cross_talk


def to_numpy(in_dict, start_sample, end_sample, sample_step=1, dtype=bool):
    """Interval lists -> dense activity over [start_sample, end_sample)."""
    num_samples = end_sample - start_sample
    array = np.zeros(int(num_samples / sample_step), dtype=dtype)
    for start, end in zip(in_dict['start'], in_dict['end']):
        if start > end_sample:
            break
        if end < start_sample:
            continue
        array[max(start - start_sample, 0) // sample_step:
              (end - start_sample) // sample_step] = 1
    return array


def get_active_speaker(start_sample, end_sample, session_id, mic_id,
                       json_path=None, speaker_json=None, sample_step=1,
                       dtype=bool):
    """Per-speaker {activity, cross_talk} masks for a sample range."""
    if json_path is not None:
        speaker_json = load_json(Path(json_path) / f'{session_id}.json')
    elif speaker_json is None:
        raise ValueError(
            'Either json_path or speaker_json have to be defined')
    out = {}
    for key, value in speaker_json['cross_talk'].items():
        out[key] = dict(
            cross_talk=to_numpy(value, start_sample, end_sample,
                                sample_step, dtype),
            activity=to_numpy(speaker_json[key][mic_id], start_sample,
                              end_sample, sample_step, dtype),
        )
    return out


def create_cross_talk_database(database_path, json_path,
                               datasets=('train', 'dev')):
    logging.basicConfig(level=logging.INFO)
    Path(json_path).mkdir(parents=True, exist_ok=True)
    for dataset in datasets:
        get_cross_talk(Path(database_path), dataset, Path(json_path))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', type=Path, required=True)
    parser.add_argument('--json-path', type=Path, required=True)
    parser.add_argument('--datasets', nargs='+', default=['train', 'dev'])
    args = parser.parse_args(argv)
    create_cross_talk_database(args.database_path, args.json_path,
                               args.datasets)


if __name__ == '__main__':
    main()
