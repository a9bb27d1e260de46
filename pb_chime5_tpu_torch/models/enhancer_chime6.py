"""CHiME-6 session enhancer (track 1: one global clock) — port of
``pb_chime5_tpu/models/enhancer_chime6.py`` (reference
pb_chime5/core_chime6.py).

The numeric chain, the session loop and the session-audio cache are the
CHiME-5 enhancer's; only the timing differs: examples carry flat integer
``start`` / ``end`` on the global clock (no per-array clocks, so no
``adjust_times`` and no ``equal_start_context``), and the activity is
``get_activity_chime6``'s, keyed [session][speaker].  The flat clock
enters through the base class's hooks (``_cache_spans``,
``_prepare_example``, ``_example_activity``, ``_context_frames``,
``_trim``).
"""

import dataclasses
import functools
import pickle
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.activity import get_activity_chime6
from pb_chime5_tpu_torch.database.chime5 import Chime5
from pb_chime5_tpu_torch.io import load_audio
from pb_chime5_tpu_torch.models.enhancer import (
    DEFAULT_LENGTH_BUCKETS, JSON_PATH, Enhancer as _Chime5Enhancer,
    check_factory_options)
from pb_chime5_tpu_torch.models.gss import GssConfig
from pb_chime5_tpu_torch.ops.stft import samples_to_stft_frames

__all__ = ['Activity', 'Enhancer', 'get_enhancer',
           'start_end_context_frames']


@dataclasses.dataclass(eq=False)  # identity hash: methods are lru_cached
class Activity:
    """CHiME-6 activity provider, [session][speaker] (reference
    core_chime6.py:91-140): 'annotation' rasterizes the database's
    utterances on the global clock, 'path' loads per-session pickles."""
    type: str = 'annotation'
    garbage_class: bool = False
    database_path: str = str(JSON_PATH / 'chime6.json')
    path: str = None

    @functools.cached_property
    def db(self):
        return Chime5(self.database_path)

    @functools.lru_cache(maxsize=1)
    def _load_annotation(self, session_id):
        return get_activity_chime6(
            self.db.get_datasets(session_id),
            garbage_class=self.garbage_class)[session_id]

    @functools.lru_cache(maxsize=1)
    def _load_path(self, session_id):
        with open(Path(self.path) / f'{session_id}.pkl', 'rb') as fd:
            return pickle.load(fd)

    def __getitem__(self, session_id):
        if self.type == 'annotation':
            return self._load_annotation(session_id)
        if self.type == 'path':
            return self._load_path(session_id)
        raise ValueError(self.type)


def start_end_context_frames(ex, stft_size, stft_shift, stft_fading):
    """Frames of acoustic context at both ends, on the flat clock
    (reference core_chime6.py:216-237)."""
    start_context_samples = ex['start_orig'] - ex['start']
    end_context_samples = ex['end'] - ex['end_orig']
    assert start_context_samples >= 0, (start_context_samples, ex)
    assert end_context_samples >= 0, (end_context_samples, ex)
    return (
        samples_to_stft_frames(start_context_samples, stft_size,
                               stft_shift, fading=stft_fading),
        samples_to_stft_frames(end_context_samples, stft_size,
                               stft_shift, fading=stft_fading),
    )


@dataclasses.dataclass
class Enhancer(_Chime5Enhancer):
    """The CHiME-5 enhancer with the flat-clock hooks."""

    def get_iterator(self, session_id):
        return self.db.get_iterator_for_session(
            session_id,
            audio_read=False,
            adjust_times=False,
            drop_unknown_target_speaker=True,
            context_samples=self.context_samples,
            equal_start_context=False,
        )

    def _cache_spans(self, ex, reference_array):
        obs_paths = ex['audio_path']['observation']
        arrays, sel = self._multiarray_selection(obs_paths,
                                                 reference_array)
        return [(obs_paths[a], ex['start'], ex['end'], sel) for a in arrays]

    def _prepare_example(self, ex, use_cache=False):
        """(None, observation): the flat clock needs no reference array
        past the channel selection."""
        if use_cache and self._audio_cache is not None:
            ref = (self._resolve_reference_array(ex)
                   if self.multiarray is False else None)
            cached = self._audio_cache.lookup(
                ex['session_id'], self._cache_spans(ex, ref))
            if cached is not None:
                return None, cached
        return None, self._load_observation_flat(ex)

    def _example_activity(self, ex, reference_array):
        return {
            k: arr[ex['start']:min(ex['end'], len(arr))]
            for k, arr in self.activity[ex['session_id']].items()
        }

    def _context_frames(self, ex):
        return start_end_context_frames(
            ex, stft_size=self.stft_size, stft_shift=self.stft_shift,
            stft_fading=self.stft_fading)

    def _trim(self, ex, reference_array):
        if self.context_samples <= 0:
            return None
        return ex['start_orig'] - ex['start'], ex['num_samples_orig']

    def _load_observation_flat(self, ex):
        """Multi-array stacking on the global clock (reference
        core_chime6.py:410-490), in the array order and channel
        selection of ``_multiarray_selection``, as the cache spans."""
        obs_paths = ex['audio_path']['observation']
        ref = (self._resolve_reference_array(ex)
               if self.multiarray is False else None)
        arrays, sel = self._multiarray_selection(obs_paths, ref)
        loaded = [np.atleast_2d(load_audio(obs_paths[a], start=ex['start'],
                                           stop=ex['end'], dtype=None))[sel]
                  for a in arrays]
        time_length = min(a.shape[-1] for a in loaded)
        stacked = np.array([a[..., :time_length] for a in loaded])
        return stacked.reshape(-1, time_length)


def get_enhancer(
    multiarray=False,
    reference_array=None,
    context_samples=240000,

    wpe=True,
    wpe_tabs=10,
    wpe_delay=2,
    wpe_iterations=3,
    wpe_psd_context=0,

    activity_type='annotation',
    activity_path=None,
    activity_garbage_class=True,

    stft_size=1024,
    stft_shift=256,
    stft_fading=True,

    bss_iterations=20,
    bss_iterations_post=1,

    bf_drop_context=True,

    bf='mvdrSouden_ban',
    postfilter=None,

    database_path=str(JSON_PATH / 'chime6.json'),

    length_buckets=DEFAULT_LENGTH_BUCKETS,
    compute_dtype=np.float32,
    device_audio_cache=True,
    cache_window_seconds=180.0,
    cache_prefetch=True,
    device='cuda',
):
    """Factory with the keywords of the JAX package's CHiME-6
    ``get_enhancer`` (the reference's, pb_chime5/core_chime6.py:571-634),
    plus the compute ``device``."""
    check_factory_options(wpe, bf, activity_garbage_class, compute_dtype)
    assert activity_path is None or activity_type == 'path', \
        (activity_path, activity_type)
    return Enhancer(
        activity=Activity(
            type=activity_type,
            garbage_class=activity_garbage_class,
            path=activity_path,
            database_path=database_path,
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
        multiarray=multiarray,
        reference_array=reference_array,
        length_buckets=length_buckets,
        compute_dtype=compute_dtype,
        device_audio_cache=device_audio_cache,
        cache_window_seconds=cache_window_seconds,
        cache_prefetch=cache_prefetch,
        device=device,
    )
