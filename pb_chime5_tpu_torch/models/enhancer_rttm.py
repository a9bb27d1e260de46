"""CHiME-6 track-2 enhancer: activity from an RTTM diarization — port of
``pb_chime5_tpu/models/enhancer_rttm.py`` (reference
pb_chime5/core_chime6_rttm.py).

The database is built from the corpus's audio files and an RTTM's
intervals (no transcriptions); the activity comes from an RTTM file
(possibly another one); each example's audio is read eagerly, float64,
through ``recursive_load_audio`` (uploaded in the compute dtype, float64
when asked) (short tracks dropped, the rest cut to
their common length) on the session pump's prefetch thread; a failing
example prints its id and raises (reference core_chime6_rttm.py:
168-185).  No session-audio cache, as in the JAX package.  The session
loop, the numeric chain and the flat-clock hooks (context frames, trim)
are the CHiME-6 enhancer's.
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.database.rttm import (
    RTTMDatabase, get_chime6_files, groupby, load_example_audio, load_rttm)
from pb_chime5_tpu_torch.models.enhancer import (
    DEFAULT_LENGTH_BUCKETS, check_factory_options)
from pb_chime5_tpu_torch.models.enhancer_chime6 import (
    Enhancer as _Chime6Enhancer)
from pb_chime5_tpu_torch.models.gss import GssConfig
from pb_chime5_tpu_torch.utils import ArrayInterval

__all__ = ['Activity', 'Enhancer', 'get_database', 'get_enhancer']


def _always(value):
    track = ArrayInterval(None)
    if value:
        track[0:10 * 3600 * 16000] = 1     # a 10 h horizon
    return track


@dataclasses.dataclass(eq=False)
class Activity:
    """[session][speaker] activity from RTTM file(s) (reference
    core_chime6_rttm.py:31-69), plus the noise class: ``garbage_class``
    True -> always on, False -> always off, None -> none."""
    garbage_class: bool = False
    rttm: str = None

    @functools.cached_property
    def _data(self):
        return load_rttm(self.rttm)

    def __getitem__(self, session_id):
        data = dict(self._data[session_id])
        if self.garbage_class is True or self.garbage_class is False:
            data['Noise'] = _always(self.garbage_class)
        elif self.garbage_class is not None:
            raise ValueError(self.garbage_class)
        return data


@dataclasses.dataclass
class Enhancer(_Chime6Enhancer):
    """The flat-clock enhancer on an RTTM database: the examples, and the
    channels of each, come from ``db``; the session loop shards on the
    examples' metadata, then reads each one's audio eagerly on the pump's
    prefetch thread (:func:`load_example_audio`)."""
    db: RTTMDatabase = None
    # no session-audio cache, as in the JAX package: the reads are eager
    device_audio_cache: bool = False

    def get_dataset(self, session_id):
        """The examples, each read into its ``audio_data`` when indexed."""
        return self._examples(session_id, audio_read=True)

    def get_iterator(self, session_id):
        return self._examples(session_id, audio_read=False)

    def _examples(self, session_id, audio_read):
        return self.db.get_dataset_for_session(
            session_id,
            audio_read=audio_read,
            adjust_times=False,
            context_samples=self.context_samples,
            equal_start_context=False,
        )

    def _prepare_example(self, ex, use_cache=False):
        return None, load_example_audio(ex)

    def _example_activity(self, ex, reference_array):
        return {
            k: arr[ex['start']:ex['end']]
            for k, arr in self.activity[ex['session_id']].items()
        }

    def enhance_example(self, ex):
        """One example with its ``audio_data`` -> the emitted waveform."""
        return self._enhance_loaded(ex, None, ex['audio_data'])


def get_database(chime6_dir, rttm, multiarray):
    """The audio-glob database of a ``multiarray`` policy (reference
    core_chime6_rttm.py:288-357): True every channel of every array,
    'outer_array_mics' the first and last of each, 'first_array_mics' the
    first of each."""
    chime6_dir = Path(chime6_dir)
    if multiarray is True:
        audio_paths = get_chime6_files(chime6_dir, worn=False, flat=True)
    elif multiarray in ('outer_array_mics', 'first_array_mics'):
        pick = ((0, -1) if multiarray == 'outer_array_mics' else (0,))
        audio_paths = {
            session: [files[i] for files in arrays.values() for i in pick]
            for session, arrays in get_chime6_files(
                chime6_dir, worn=False, flat=False).items()
        }
    else:
        raise ValueError(multiarray)

    alias = groupby(sorted(chime6_dir.glob('transcriptions/*/*.json')),
                    lambda p: p.parts[-2], lambda p: p.with_suffix('').name)
    return RTTMDatabase(rttm, audio_paths, alias=alias)


def get_enhancer(
    database_rttm,
    activity_rttm,
    chime6_dir='CHiME6',
    multiarray='outer_array_mics',
    context_samples=240000,

    wpe=True,
    wpe_tabs=10,
    wpe_delay=2,
    wpe_iterations=3,
    wpe_psd_context=0,

    activity_garbage_class=True,

    stft_size=1024,
    stft_shift=256,
    stft_fading=True,

    bss_iterations=20,
    bss_iterations_post=1,

    bf_drop_context=True,

    bf='mvdrSouden_ban',
    postfilter=None,

    length_buckets=DEFAULT_LENGTH_BUCKETS,
    compute_dtype=np.float32,
    device='cuda',
):
    """Factory with the keywords of the JAX package's RTTM
    ``get_enhancer`` (the reference's, pb_chime5/core_chime6_rttm.py:
    360-422), plus the compute ``device``."""
    check_factory_options(wpe, bf, activity_garbage_class, compute_dtype)
    return Enhancer(
        db=get_database(chime6_dir, database_rttm, multiarray),
        activity=Activity(
            garbage_class=activity_garbage_class,
            rttm=activity_rttm,
        ),
        gss_config=GssConfig(
            stft_size=stft_size, stft_shift=stft_shift,
            stft_fading=stft_fading,
            wpe=wpe, wpe_taps=wpe_tabs, wpe_delay=wpe_delay,
            wpe_iterations=wpe_iterations, wpe_psd_context=wpe_psd_context,
            bss_iterations=bss_iterations,
            bss_iterations_post=bss_iterations_post,
            bf=bf, postfilter=postfilter,
        ),
        bf_drop_context=bf_drop_context,
        context_samples=context_samples,
        length_buckets=length_buckets,
        compute_dtype=compute_dtype,
        device=device,
    )
