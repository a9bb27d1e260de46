"""Kaldi phone alignments -> per-utterance label arrays — the port of
``pb_chime5_tpu/utils/alignment.py`` (reference
pb_chime5/utils/alignment.py).

The reference converts phone-id arrays to label arrays with a Cython loop
("~10x faster than python", alignment_util.pyx:8-21); here the same
conversion is a single vectorized ``np.take`` through a dense lookup
table, which is faster still and needs no extension.
"""

import collections
import itertools
import operator
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.database.chime5 import (
    kaldi_to_nt_example_id, kaldi_id_to_channel)
from pb_chime5_tpu_torch.utils.dict_utils import Dispatcher, merge

__all__ = ['alignment_id2phone', 'get_phone_alignment']


def alignment_id2phone(alignments: dict, id2phone: dict) -> dict:
    """{utt: int32 phone-id array} -> {utt: str label array}.

    Vectorized replacement for the reference's cy_alignment_id2phone
    (alignment_util.pyx:8-21).
    """
    max_id = max(id2phone) if id2phone else 0
    table = np.array([id2phone.get(i, '') for i in range(max_id + 1)])
    return {
        utt: table[np.asarray(ids, dtype=np.int64)]
        for utt, ids in alignments.items()
    }


def _helper(alignments, channel_preference, unique_per_utt=True,
            use_kaldi_id=False):
    """Merge per-channel (worn L/R) alignments into one per utterance
    (reference utils/alignment.py:147-261; doctest-pinned behaviour).

    channel_preference e.g. ['R', 'L']: both channels must occur
    somewhere; where both exist for one utterance, the first listed wins.
    None: channels must be disjoint per utterance (merge asserts).

    Note: the reference's *code* keys the merge by the kaldi id when
    ``use_kaldi_id=True`` (so nothing ever deduplicates), but its
    doctest documents per-utterance deduplication with the kaldi id only
    affecting the *output* keys.  The doctest semantics are the intended
    behaviour (its docstring: "unique_per_utt: Return one per
    utterance...") and are what this implementation follows.
    """
    records = [
        (
            kaldi_id_to_channel(k),
            kaldi_to_nt_example_id(k) if unique_per_utt else k,
            k,
            v,
        )
        for k, v in alignments.items()
    ]

    per_channel = {
        channel: {
            (nt_id if unique_per_utt else kaldi_id): (kaldi_id, data)
            for _, nt_id, kaldi_id, data in group
        }
        for channel, group in itertools.groupby(
            sorted(records, key=lambda e: (e[0], e[1], e[2])),
            key=lambda e: e[0])
    }

    if not unique_per_utt:
        assert channel_preference is None, channel_preference
        assert use_kaldi_id is True, use_kaldi_id

    if channel_preference is None:
        ret = dict(sorted(merge(*per_channel.values()).items()))
    else:
        assert len(per_channel) == len(channel_preference), (
            f'Expect channels {channel_preference} but found '
            f'{tuple(per_channel.keys())}.')
        ordered = operator.itemgetter(*channel_preference)(per_channel)
        if not isinstance(ordered, tuple):
            ordered = (ordered,)
        ret = dict(sorted(collections.ChainMap(*ordered).items()))

    if use_kaldi_id:
        return {kaldi_id: ali for _, (kaldi_id, ali) in ret.items()}
    return {nt_id: ali for nt_id, (kaldi_id, ali) in ret.items()}


def get_phone_alignment(ali_path, use_kaldi_id=False, unique_per_utt=True,
                        channel_preference=None):
    """Kaldi alignment dir(s) -> {utterance: per-frame phone label array}
    (10 ms frames).  Needs Kaldi binaries (see kaldi.helper)."""
    from pb_chime5_tpu_torch.kaldi import alignment as kaldi_alignment

    if isinstance(ali_path, (tuple, list)):
        parts = [
            get_phone_alignment(
                p, channel_preference=channel_preference,
                use_kaldi_id=use_kaldi_id)
            for p in ali_path
        ]
        total = sum(len(p) for p in parts)
        merged = {k: v for p in parts for k, v in p.items()}
        assert len(merged) == total
        return merged

    ali_path = Path(ali_path).expanduser().resolve()

    pairs = [reversed(line.split()) for line in
             (ali_path / 'phones.txt').read_text().splitlines()]
    id2phone = {int(k): v for k, v in pairs}

    raw = kaldi_alignment.import_alignment_data(
        ali_path,
        import_fn=kaldi_alignment.import_phone_alignment_from_file,
        per_frame=True,
        model_name=ali_path / 'final.mdl',
    )
    merged = _helper(
        raw,
        channel_preference=channel_preference,
        unique_per_utt=unique_per_utt,
        use_kaldi_id=use_kaldi_id,
    )
    return Dispatcher(alignment_id2phone(merged, id2phone))
