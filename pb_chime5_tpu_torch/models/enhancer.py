"""Host-side CHiME-5 session enhancer — port of the serial path of
``pb_chime5_tpu/models/enhancer.py`` (reference pb_chime5/core.py:281-637).

Per-session iteration, multi-array stacking, activity slicing, context
bookkeeping and WAV output stay on the host; each utterance is one
asynchronous dispatch on the card.  By default (``device_audio_cache``)
a session is dispatched in session-time order, and each utterance's
observation is sliced out of the device-resident session-audio window
(``models/audio_cache.py``, :meth:`GssPipeline.dispatch_cached`);
otherwise it is read and uploaded per utterance
(:meth:`GssPipeline.dispatch`).  ``compute_dtype`` float32 (the hand
kernels) or float64 (plain PyTorch, as the JAX package computes in
float64 when asked); :meth:`Enhancer.debug_example` runs the debug twin.
Not ported yet (ROADMAP.md, Queue 1): the mesh loop and warmup.
"""

import dataclasses
import functools
import pickle
from pathlib import Path

import numpy as np
import torch

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.activity import get_activity
from pb_chime5_tpu_torch.database.chime5 import Chime5
from pb_chime5_tpu_torch.io import dump_audio, load_audio
from pb_chime5_tpu_torch.models.audio_cache import (
    CachedWindow, SessionAudioCache)
from pb_chime5_tpu_torch.models.gss import GssConfig, GssPipeline
from pb_chime5_tpu_torch.ops.stft import istft, samples_to_stft_frames, stft
from pb_chime5_tpu_torch.parallel.scheduler import length_balanced_shard
from pb_chime5_tpu_torch.utils import activity_time_to_frequency

__all__ = ['Activity', 'Enhancer', 'get_enhancer', 'async_session_pump',
           'start_end_context_frames', 'DEFAULT_LENGTH_BUCKETS']

JSON_PATH = Path('cache')

# 16 kHz samples; an utterance + 2 x 15 s context is <= ~40 s for almost
# every CHiME-5 utterance
DEFAULT_LENGTH_BUCKETS = tuple(
    16000 * s for s in (34, 38, 42, 48, 60, 90, 150, 300))


@dataclasses.dataclass(eq=False)  # identity hash: methods are lru_cached
class Activity:
    """Session activity provider (reference core.py:91-141): 'annotation'
    rasterizes the database's utterance annotations, 'path' loads
    pre-computed per-session pickles."""
    type: str = 'annotation'
    garbage_class: bool = False
    database_path: str = str(JSON_PATH / 'chime5.json')
    path: str = None

    @functools.cached_property
    def db(self):
        return Chime5(self.database_path)

    @functools.lru_cache(maxsize=1)
    def _load_annotation(self, session_id):
        return get_activity(self.db.get_datasets(session_id),
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


def async_session_pump(items, prepare, dispatch, finish, id_of, *,
                       on_error='raise', prefetch=2, write_ahead=4):
    """Prefetch / dispatch-ahead / writer pump of the serial session loop.

    ``prepare(item)`` runs on one prefetch thread (host I/O);
    ``dispatch(item, prepared)`` on the calling thread (asynchronous
    device dispatch); ``finish(*args)`` on one writer thread (waits for
    the device result and writes the WAV).  ``on_error='raise'``
    re-raises a failure, ``'skip'`` prints it and continues.
    """
    import collections
    import concurrent.futures
    import traceback

    def handle_error(item_id):
        # called from an active except block: bare raise re-raises
        print('ERROR: Failed example:', item_id)
        if on_error == 'raise':
            raise
        assert on_error == 'skip', on_error
        traceback.print_exc()

    with concurrent.futures.ThreadPoolExecutor(1) as pool, \
            concurrent.futures.ThreadPoolExecutor(1) as writer:
        window = collections.deque()
        pending = collections.deque()    # (item_id, writer future)
        it = iter(items)
        for item in it:
            window.append((item, pool.submit(prepare, item)))
            if len(window) >= prefetch:
                break

        def drain(item_id, future):
            try:
                future.result()
            except Exception:
                handle_error(item_id)

        while window:
            item, future = window.popleft()
            nxt = next(it, None)
            if nxt is not None:
                window.append((nxt, pool.submit(prepare, nxt)))
            item_id = id_of(item)
            try:
                args = dispatch(item, future.result())
            except Exception:
                handle_error(item_id)
                continue
            pending.append((item_id, writer.submit(finish, *args)))
            while len(pending) > write_ahead:
                drain(*pending.popleft())
        while pending:
            drain(*pending.popleft())


def start_end_context_frames(ex, stft_size, stft_shift, stft_fading):
    """Frames of acoustic context at both ends (reference
    core.py:217-238)."""
    start_context_samples = \
        ex['start_orig']['original'] - ex['start']['original']
    end_context_samples = ex['end']['original'] - ex['end_orig']['original']
    assert start_context_samples >= 0, (start_context_samples, ex)
    assert end_context_samples >= 0, (end_context_samples, ex)
    return (
        samples_to_stft_frames(start_context_samples, stft_size,
                               stft_shift, fading=stft_fading),
        samples_to_stft_frames(end_context_samples, stft_size,
                               stft_shift, fading=stft_fading),
    )


def _example_start_key(ex):
    """Session-timeline position of an example, for cache-friendly
    time-ordered dispatch (earliest array start; arrays drift by less
    than the cache margin, so any of them orders the timeline)."""
    start = ex['start']
    if isinstance(start, dict):
        obs = start.get('observation')
        if isinstance(obs, dict) and obs:
            return min(obs.values())
        return start.get('original', 0)
    return start


@dataclasses.dataclass
class Enhancer:
    """Session-level driver (reference core.py:281-571), serial path."""
    activity: Activity
    gss_config: GssConfig

    bf_drop_context: bool = True
    context_samples: int = 240000
    multiarray: object = False       # True|False|'outer_array_mics'|
    #                                  'first_array_mics'
    reference_array: str = None
    length_buckets: tuple = DEFAULT_LENGTH_BUCKETS
    # np.float32 (the hand kernels) | np.float64 (plain PyTorch)
    compute_dtype: object = np.float32
    # device-resident rolling session-audio cache (models/audio_cache.py):
    # session loops slice each utterance out of a resident window of
    # session audio instead of uploading utterance + 30 s context every
    # time; outputs are bit-identical either way
    device_audio_cache: bool = True
    cache_window_seconds: float = 180.0
    # background upload of the predicted next window while the current
    # one still serves hits; self-disabling on misprediction
    cache_prefetch: bool = True
    # trim the +-context span off the enhanced waveform on the device
    # (GssPipeline._plan_trim): only ~the emitted utterance is downloaded
    device_trim: bool = True
    device: str = 'cuda'

    def __post_init__(self):
        self._pipeline = GssPipeline(
            self.gss_config,
            length_buckets=(list(self.length_buckets)
                            if self.length_buckets else None),
            dtype=self.compute_dtype,
            device_trim=self.device_trim,
            device=self.device)
        self._audio_cache = None
        if self.device_audio_cache:
            self._audio_cache = SessionAudioCache(
                window_seconds=self.cache_window_seconds,
                coerce=self._pipeline._normalize_obs,
                bucket_length=self._pipeline.bucket_length,
                prefetch=self.cache_prefetch,
                device=self.device)

    @property
    def db(self):
        return self.activity.db

    @property
    def stft_size(self):
        return self.gss_config.stft_size

    @property
    def stft_shift(self):
        return self.gss_config.stft_shift

    @property
    def stft_fading(self):
        return self.gss_config.stft_fading

    def stft(self, x):
        """Analysis transform (reference core.py:305-312): NumPy (..., N)
        in, NumPy (..., T, F) out, computed on the enhancer's device."""
        X = stft(torch.from_numpy(np.asarray(x)).to(self._pipeline.device),
                 self.stft_size, self.stft_shift, fading=self.stft_fading)
        return X.cpu().numpy()

    def istft(self, X):
        """Synthesis transform: NumPy (..., T, F) in, NumPy (..., N) out."""
        x = istft(torch.from_numpy(np.asarray(X)).to(self._pipeline.device),
                  self.stft_size, self.stft_shift, fading=self.stft_fading)
        return x.cpu().numpy()

    def get_iterator(self, session_id):
        return self.db.get_iterator_for_session(
            session_id,
            audio_read=False,
            adjust_times=True,
            drop_unknown_target_speaker=True,
            context_samples=self.context_samples,
            equal_start_context=True,
        )

    def enhance_session(
            self,
            session_ids,
            audio_dir,
            dataset_slice=False,
            audio_dir_exist_ok=False,
            is_master=True,
            shard_fn=length_balanced_shard,
            progress=None,
            resume=False,
            on_error='raise',
            write_ahead=4,
    ):
        """Enhance all utterances of the given session(s) into
        ``audio_dir/<dataset>/<example_id>.wav``.

        ``shard_fn(examples, length_fn)`` selects this process's subset;
        ``resume=True`` skips examples whose WAV exists; ``on_error``
        'raise' or 'skip'; ``write_ahead`` bounds the utterances in
        flight on the device while earlier results are written.  With
        the session-audio cache on, the shard is dispatched in session
        time order, and one ``session-audio cache: {...}`` line prints
        the cache's stats of this call.
        """
        audio_dir = Path(audio_dir)
        it = self.get_iterator(session_ids)

        if is_master:
            audio_dir.mkdir(exist_ok=audio_dir_exist_ok, parents=True)
            for dataset in set(mapping.session_to_dataset.values()):
                (audio_dir / dataset).mkdir(exist_ok=True)

        if dataset_slice is not False:
            if dataset_slice is True:
                it = it[:2]
            elif isinstance(dataset_slice, int):
                it = it[:dataset_slice]
            elif isinstance(dataset_slice, slice):
                it = it[dataset_slice]
            else:
                raise ValueError(dataset_slice)

        def length_fn(ex):
            ns = ex['num_samples']
            return ns['original'] if isinstance(ns, dict) else ns

        shard = shard_fn(list(it), length_fn)
        if self._audio_cache is not None and isinstance(shard, (list,
                                                                tuple)):
            # the session iterator is speaker-grouped (P05_*, P06_*, ...),
            # so a K-speaker session would traverse the timeline K times
            # and the rolling window would refill K times over; outputs
            # are independent files, so the dispatch order is free
            shard = sorted(shard, key=_example_start_key)
        todo = [
            ex for ex in shard
            if not (resume and (
                audio_dir / mapping.session_to_dataset[ex['session_id']]
                / f"{ex['example_id']}.wav").exists())]

        def finish(example_id, session_id, handle):
            # writer thread: waits for the device result, writes the WAV
            x_hat = self._finish_dispatched(handle)
            assert x_hat.ndim == 1, x_hat.shape
            dataset = mapping.session_to_dataset[session_id]
            dump_audio(x_hat, audio_dir / dataset / f'{example_id}.wav')
            if progress is not None:
                progress(example_id)

        def dispatch(ex, prepared):
            reference_array, obs = prepared
            handle = self._dispatch_loaded(ex, reference_array, obs)
            return ex['example_id'], ex['session_id'], handle

        if self._audio_cache is not None:
            # a new run is a new schedule: don't inherit a previous
            # run's wasteful-schedule disable (or its stale window)
            self._audio_cache.new_run()
        cache_since = self._cache_stats_snapshot()
        async_session_pump(
            todo, functools.partial(self._prepare_example, use_cache=True),
            dispatch, finish, lambda ex: ex['example_id'],
            on_error=on_error, write_ahead=write_ahead)
        self._log_cache_stats(cache_since)

    def _log_cache_stats(self, since=None):
        """One line per enhance_session call: how the session-audio cache
        behaved during this call (``since``: the stats at its entry).
        'hits' served from the resident window; 'direct' = fallback
        uploads."""
        if self._audio_cache is not None:
            stats = dict(self._audio_cache.stats)
            if since:
                stats = {k: v - since.get(k, 0) for k, v in stats.items()}
            print('session-audio cache:', stats, flush=True)

    def _cache_stats_snapshot(self):
        return (dict(self._audio_cache.stats)
                if self._audio_cache is not None else None)

    def _resolve_reference_array(self, ex):
        if self.reference_array is not None:
            return self.reference_array
        try:
            return ex['reference_array']
        except KeyError:
            raise RuntimeError(
                'Failed to get the "reference_array" from the example '
                '(the "train" dataset has none); set one with '
                '"with reference_array=U06".  In multiarray mode the '
                'reference array is used for the projection of the human '
                'annotations.') from None

    def _load_observation(self, ex, reference_array):
        """Multi-array stacking (reference core.py:427-490); audio stays in
        the file's dtype (PCM16 is scaled on the device)."""
        obs_paths = ex['audio_path']['observation']
        arrays, sel = self._multiarray_selection(obs_paths,
                                                 reference_array)
        loaded = []
        for array in arrays:
            audio = load_audio(
                obs_paths[array],
                start=ex['start']['observation'][array],
                stop=ex['end']['observation'][array],
                dtype=None,
            )
            loaded.append(np.atleast_2d(audio)[sel])
        time_length = min(a.shape[-1] for a in loaded)
        stacked = np.array([a[..., :time_length] for a in loaded])
        return stacked.reshape(-1, time_length)          # 'ACN->A*CN'

    def _multiarray_selection(self, obs_paths, reference_array):
        """(array ids in stacking order, channel selector)."""
        if self.multiarray is True:
            return sorted(obs_paths.keys()), slice(None)
        if self.multiarray == 'outer_array_mics':
            return sorted(obs_paths.keys()), [0, -1]
        if self.multiarray == 'first_array_mics':
            return sorted(obs_paths.keys()), [0]
        if self.multiarray is False:
            return [reference_array], slice(None)
        raise ValueError(self.multiarray)

    def _cache_spans(self, ex, reference_array):
        """(paths, start, stop, channel_selector) per array in stacking
        order — mirrors :meth:`_load_observation` exactly."""
        obs_paths = ex['audio_path']['observation']
        arrays, sel = self._multiarray_selection(obs_paths,
                                                 reference_array)
        return [(obs_paths[a], ex['start']['observation'][a],
                 ex['end']['observation'][a], sel) for a in arrays]

    def _prepare_example(self, ex, use_cache=False):
        """Host I/O (prefetch thread): the reference array and the
        observation audio — or, with ``use_cache`` and the session-audio
        cache on, a :class:`CachedWindow` (device window + offsets)."""
        reference_array = self._resolve_reference_array(ex)
        if use_cache and self._audio_cache is not None:
            cached = self._audio_cache.lookup(
                ex['session_id'], self._cache_spans(ex, reference_array))
            if cached is not None:
                return reference_array, cached
        return reference_array, self._load_observation(ex, reference_array)

    def enhance_example(self, ex):
        reference_array, obs = self._prepare_example(ex)
        return self._enhance_loaded(ex, reference_array, obs)

    def debug_example(self, ex):
        """Autopsy one utterance: the debug twin of the chain
        (:meth:`GssPipeline.debug`, the unfused EM) on its observation,
        read from the files; returns ``{'x_hat', 'masks' (K, T, F),
        'weights', 'logdet', 'condition', 'posterior_entropy'}`` (the
        per-EM-iteration statistics of
        ``ops.cacgmm.cacgmm_posteriors_debug``), ``x_hat`` trimmed as
        :meth:`enhance_example`'s output."""
        reference_array, obs = self._prepare_example(ex)
        activity_freq, target_index, start_cf, end_cf = self._device_args(
            self._example_activity(ex, reference_array),
            ex['speaker_id'], ex)
        x_hat, masks, debug = self._pipeline.debug(
            obs, activity_freq, target_index,
            start_context_frames=start_cf, end_context_frames=end_cf)
        trim = self._trim(ex, reference_array)
        if trim is not None:
            x_hat = x_hat[..., trim[0]:trim[0] + trim[1]]
        return dict(x_hat=x_hat, masks=masks, **debug)

    def _example_activity(self, ex, reference_array):
        """Per-class sample activity on the reference array's clock
        (reference core.py:419-425)."""
        array_start = ex['start']['observation'][reference_array]
        array_end = ex['end']['observation'][reference_array]
        return {
            k: arr[array_start:min(array_end, len(arr))]
            for k, arr in self.activity[ex['session_id']][
                reference_array].items()
        }

    def _device_args(self, ex_array_activity, speaker_id, ex):
        """(activity_freq, target_index, start/end context frames)."""
        activity_freq = activity_time_to_frequency(
            np.array(list(ex_array_activity.values())),
            stft_window_length=self.stft_size,
            stft_shift=self.stft_shift,
            stft_fading=self.stft_fading,
            stft_pad=True,
        )
        if self.bf_drop_context:
            start_cf, end_cf = self._context_frames(ex)
        else:
            start_cf = end_cf = 0
        target_index = tuple(ex_array_activity.keys()).index(speaker_id)
        return activity_freq, target_index, start_cf, end_cf

    def _context_frames(self, ex):
        return start_end_context_frames(
            ex, stft_size=self.stft_size, stft_shift=self.stft_shift,
            stft_fading=self.stft_fading)

    def _trim(self, ex, reference_array):
        if self.context_samples <= 0:
            return None
        start_orig = ex['start_orig']['observation'][reference_array]
        start = ex['start']['observation'][reference_array]
        return (start_orig - start,
                ex['num_samples_orig']['observation'][reference_array])

    def _dispatch_loaded(self, ex, reference_array, obs):
        """Asynchronous dispatch of one loaded utterance; the handle's
        :meth:`GssPipeline.gather` yields the emitted (trimmed) waveform
        (reference core.py:500-505)."""
        activity_freq, target_index, start_cf, end_cf = self._device_args(
            self._example_activity(ex, reference_array),
            ex['speaker_id'], ex)
        kw = dict(start_context_frames=start_cf, end_context_frames=end_cf,
                  trim=self._trim(ex, reference_array))
        if isinstance(obs, CachedWindow):
            return self._pipeline.dispatch_cached(
                obs.buf, obs.offsets, obs.num_valid_samples, activity_freq,
                target_index, **kw)
        return self._pipeline.dispatch(obs, activity_freq, target_index,
                                       **kw)

    def _finish_dispatched(self, handle):
        return self._pipeline.gather(handle)

    def _enhance_loaded(self, ex, reference_array, obs):
        """Everything after the audio read."""
        return self._finish_dispatched(
            self._dispatch_loaded(ex, reference_array, obs))

    def enhance_observation(self, obs, ex_array_activity, speaker_id,
                            ex=None):
        """Public per-observation entry point (reference core.py:514-571)."""
        activity_freq, target_index, start_cf, end_cf = self._device_args(
            ex_array_activity, speaker_id, ex)
        x_hat, _ = self._pipeline(
            obs, activity_freq, target_index,
            start_context_frames=start_cf, end_context_frames=end_cf)
        return x_hat


def check_factory_options(wpe, bf, activity_garbage_class, compute_dtype):
    """The checks every factory makes of its keywords."""
    assert wpe is True or wpe is False, wpe
    if str(bf).startswith('lcmv'):
        # the LCMV beamformer treats the LAST mask class as the noise PSD
        assert activity_garbage_class not in (False, None), (
            'bf=lcmv requires a garbage (noise) class: set '
            'activity_garbage_class=True')
    if np.dtype(compute_dtype) not in (np.float32, np.float64):
        raise NotImplementedError(
            f'compute_dtype={compute_dtype!r}: the port computes in float32 '
            f'or float64')


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

    database_path=str(JSON_PATH / 'chime5.json'),

    length_buckets=DEFAULT_LENGTH_BUCKETS,
    compute_dtype=np.float32,
    compile_mode='fused',
    device_audio_cache=True,
    cache_window_seconds=180.0,
    cache_prefetch=True,
    device_trim=True,
    device='cuda',
):
    """Factory with the keyword surface of the JAX package's
    ``get_enhancer`` (the reference's, pb_chime5/core.py:574-637, and the
    JAX extensions), plus the compute ``device``.

    ``compute_dtype`` float32 (the hand kernels) or float64 (plain
    PyTorch); any other raises.  ``device_audio_cache``,
    ``cache_window_seconds`` and ``cache_prefetch`` switch and size the
    session-audio cache, with the JAX defaults (on, 180 s, prefetch on)."""
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
            stft_size=stft_size,
            stft_shift=stft_shift,
            stft_fading=stft_fading,
            wpe=wpe,
            wpe_taps=wpe_tabs,
            wpe_delay=wpe_delay,
            wpe_iterations=wpe_iterations,
            wpe_psd_context=wpe_psd_context,
            bss_iterations=bss_iterations,
            bss_iterations_post=bss_iterations_post,
            bf=bf,
            postfilter=postfilter,
            compile_mode=compile_mode,
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
        device_trim=device_trim,
        device=device,
    )
