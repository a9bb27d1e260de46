"""Kaldi-alignment-refined activity — the port of
``pb_chime5_tpu/activity_alignment.py`` (reference
pb_chime5/activity_alignment.py).

``get_non_sil_alignment_fn_from_kaldi(ali_path)`` converts Kaldi phone
alignments (10 ms frames: win 400 / shift 160 samples) into per-sample
non-silence masks and returns a ``non_sil_alignment_fn(ex,
perspective_mic_array)`` suitable for ``pb_chime5_tpu_torch.activity.
get_activity``; utterances without an alignment return scalar 1 (full
activity, counted as "missing").

As a CLI this module dumps the activity caches the enhancer's
``Activity(type='path')`` consumes:

    python -m pb_chime5_tpu_torch.activity_alignment \
        --database-path cache/chime5.json --out-dir cache \
        [--sessions dev] [--worn-ali-path <kaldi ali dir>]

writing ``cache/annotation/<S>.pkl`` (plain annotation activity) and,
when an alignment dir is given, ``cache/word_non_sil_alignment/<S>.pkl``.
The pickles hold this package's classes (``utils.Dispatcher``,
``utils.ArrayInterval``): the JAX package's pickles name its own, so
neither package reads the other's files.
"""

import collections

import numpy as np

from pb_chime5_tpu_torch.database.chime5 import (
    kaldi_id_to_parts, kaldi_to_nt_example_id)
from pb_chime5_tpu_torch.utils.activity_freq import (
    activity_frequency_to_time)
from pb_chime5_tpu_torch.utils.alignment import get_phone_alignment
from pb_chime5_tpu_torch.utils.dict_utils import Dispatcher

__all__ = ['get_non_sil_alignment_fn_from_kaldi', 'main']

# Kaldi CHiME-5 feature frames (alignment resolution)
ALI_WINDOW_LENGTH = 400
ALI_SHIFT = 160


def get_non_sil_alignment_fn_from_kaldi(
        ali_path,
        unique_alignments=True,
        channel_preference=None,
        add_statistics=False,
):
    """Build ``fn(ex, perspective_mic_array) -> bool array | 1``
    (reference activity_alignment.py:7-148)."""
    if not unique_alignments:
        raise NotImplementedError(unique_alignments)

    alignment = get_phone_alignment(
        ali_path,
        use_kaldi_id=True,
        unique_per_utt=unique_alignments,
        channel_preference=channel_preference,
    )
    non_sil = Dispatcher({k: v != 'sil' for k, v in alignment.items()})
    source_key_mapping = {
        kaldi_to_nt_example_id(k): k for k in non_sil.keys()
    }
    statistics = collections.defaultdict(set)

    def example_to_non_sil_alignment(ex, perspective_mic_array):
        example_id = ex['example_id']
        if perspective_mic_array[0] == 'P':
            target_len = ex['num_samples']['worn'][perspective_mic_array]
        elif perspective_mic_array[0] == 'U':
            target_len = ex['num_samples']['observation'][
                perspective_mic_array]
        else:
            raise NotImplementedError(perspective_mic_array)

        if example_id not in source_key_mapping:
            print(f'Warning: Could not find {example_id} in '
                  f'non_sil_alignment.')
            if add_statistics:
                statistics[
                    f"{ex.get('target_speaker', ex.get('speaker_id'))}_"
                    f"{ex['session_id']}"].add(example_id)
            return 1

        source_id = source_key_mapping[example_id]
        array_id = kaldi_id_to_parts(source_id)['array_id']
        if array_id.startswith('U'):
            source_len = ex['num_samples']['observation'][array_id]
        elif array_id.startswith('P'):
            source_len = ex['num_samples']['worn'][array_id]
        else:
            raise ValueError(array_id, source_id, example_id)

        ret = activity_frequency_to_time(
            non_sil[source_id],
            stft_window_length=ALI_WINDOW_LENGTH,
            stft_shift=ALI_SHIFT,
            stft_fading=False,
            time_length=source_len,
        )
        # center pad/cut from the alignment's clock to the requested
        # perspective's clock (reference activity_alignment.py:112-131)
        delta = target_len - source_len
        if delta > 0:
            ret = np.pad(ret, [delta // 2, delta - delta // 2])
        elif delta < 0:
            start_cut = (-delta) // 2
            end_cut = (-delta) - start_cut
            ret = ret[start_cut:-end_cut]
        return ret

    example_to_non_sil_alignment.statistics = statistics
    example_to_non_sil_alignment.non_sil_alignment_dict = non_sil
    return example_to_non_sil_alignment


# backwards-compatible alias matching the reference's (misspelled) name
get_non_sil_alignment_fn_from_kalid = get_non_sil_alignment_fn_from_kaldi


def main(database_path, out_dir, sessions=('train', 'dev', 'eval'),
         worn_ali_path=None, garbage_class=True):
    import pickle
    from pathlib import Path
    from pb_chime5_tpu_torch.activity import get_activity
    from pb_chime5_tpu_torch.database.chime5 import Chime5
    from pb_chime5_tpu_torch.scripts.run import get_session_ids

    out_dir = Path(out_dir)
    db = Chime5(database_path)
    session_ids = get_session_ids(list(sessions))
    it = db.get_iterator_for_session(
        session_ids, drop_unknown_target_speaker=True)

    data = get_activity(
        iterator=it, perspective='array', garbage_class=garbage_class,
        dtype=bool, non_sil_alignment_fn=None, use_ArrayIntervall=True)
    path = out_dir / 'annotation'
    path.mkdir(exist_ok=True, parents=True)
    for session_id, v in data.items():
        with open(path / f'{session_id}.pkl', 'wb') as fd:
            pickle.dump(v, fd)
        print(f'wrote {path / f"{session_id}.pkl"}')

    if worn_ali_path is not None:
        fn = get_non_sil_alignment_fn_from_kaldi(worn_ali_path)
        data = get_activity(
            iterator=it, perspective='array', garbage_class=garbage_class,
            dtype=bool, non_sil_alignment_fn=fn, use_ArrayIntervall=True)
        path = out_dir / 'word_non_sil_alignment'
        path.mkdir(exist_ok=True, parents=True)
        for session_id, v in data.items():
            with open(path / f'{session_id}.pkl', 'wb') as fd:
                pickle.dump(v, fd)
            print(f'wrote {path / f"{session_id}.pkl"}')


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--database-path', required=True)
    parser.add_argument('--out-dir', default='cache')
    parser.add_argument('--sessions', nargs='+',
                        default=['train', 'dev', 'eval'])
    parser.add_argument('--worn-ali-path', default=None)
    args = parser.parse_args()
    main(args.database_path, args.out_dir, args.sessions,
         args.worn_ali_path)
