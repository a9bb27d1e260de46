"""Device-resident rolling session-audio cache — port of
``pb_chime5_tpu/models/audio_cache.py``: the same policy, arguments and
``stats`` keys.

The reference re-reads every utterance's +-15 s acoustic context from the
session recordings (core.py:439-488); the direct path mirrors that with a
per-utterance host-to-device upload.  Consecutive utterances of a session
overlap so heavily (10 s utterance + 30 s context) that per-utterance
upload moves ~4x more bytes than the session holds.  This cache keeps a
rolling window of the session audio on the device, and each dispatch
slices its observation out of it at per-array offsets
(:func:`pb_chime5_tpu_torch.models.gss.gss_enhance_cached`).  Outputs are
bit-identical to the direct path: the slice is the same file content, and
samples beyond the valid length are zeroed exactly where the direct path
zero-pads.

Policy per example (:meth:`SessionAudioCache.lookup`):

* window hit -> (device window, per-array offsets, valid length)
* miss -> refill the window at this example's spans minus a margin
* a refill is WASTEFUL when the hits it served moved fewer samples than
  the window upload itself (sparse sessions, unordered schedules,
  backward seeks).  Two consecutive wasteful refills disable the cache
  for the rest of the session and the caller falls back to direct
  upload, counted in ``stats['direct']``
* utterance longer than the window -> direct upload

Window PREFETCH: with session-time-ordered dispatch the next window's
base is predictable, so once a hit lands within ``prefetch_lead_seconds``
of the window's end a worker thread uploads the next window while hits
from the current one keep dispatching.  On the miss the pending window is
adopted if it covers the requested spans (same file content at a shifted
base), else it is discarded and the ordinary synchronous refill runs; two
discarded prefetches stop prefetching for the session.  Every discarded
upload, in-flight ones included, is charged to ``refill_mb`` and
``prefetch_wasted`` (:meth:`_discard_pending`).  While a prefetch is
pending, two windows are resident: 2 x 138 MB at the 180 s default for
24 int16 channels.

On CUDA a window is uploaded on the cache's own stream, from pinned
memory, and that stream is synchronized before the upload returns: the
window is complete before any lookup hands it out, and ``refill_s`` /
``prefetch_s`` time the host read and the transfer themselves.  Its
memory belongs to that stream's pool, so the dispatch that reads it on
another stream must ``record_stream`` it
(:meth:`GssPipeline.dispatch_cached` does).

The seconds of ``stats`` are those of the cache's spans
(``utils.profiling.timed_span``): ``cache.refill`` (a synchronous
refill, the lookup's thread), ``cache.adopt_wait`` (the wait for an
adopted prefetch) and ``cache.prefetch`` (an upload on the worker).
"""

import threading
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from pb_chime5_tpu_torch._device import resolve_device
from pb_chime5_tpu_torch.io import audio_length, load_audio
from pb_chime5_tpu_torch.utils.profiling import timed_span

__all__ = ['SessionAudioCache', 'CachedWindow']


class CachedWindow(tuple):
    """(device window (A*C, W), offsets (A,) int32, num_valid_samples) —
    marker type so the dispatch path can tell a cached lookup from a
    host-loaded observation array."""
    __slots__ = ()

    def __new__(cls, buf, offsets, num_valid_samples):
        return tuple.__new__(cls, (buf, offsets, num_valid_samples))

    @property
    def buf(self):
        return self[0]

    @property
    def offsets(self):
        return self[1]

    @property
    def num_valid_samples(self):
        return self[2]


class SessionAudioCache:
    """See the module docstring.

    Args:
      window_seconds: resident window length W.  Amortized upload for a
        long session is ``session_bytes * W / (W - max_utterance)``.
        With ``prefetch`` on, peak device memory is 2x this window while
        a speculative upload is pending.
      margin_seconds: the window starts this much before the first
        requested span, so small backward wobbles (equal start context,
        clock drift) stay inside it.
      coerce: maps the host-read (C, n) array to the upload dtype — pass
        the pipeline's ``_normalize_obs`` so cached and direct uploads
        are bitwise the same conversion.
      bucket_length: the pipeline's bucket function (the containment
        check uses the PADDED slice length).
      sample_rate: converts the second-based sizes.
      device_put: host (A*C, W) array -> window; by default
        :meth:`upload` to ``device``.
      prefetch: speculative background upload of the predicted next
        window (module docstring).
      prefetch_lead_seconds: start the background upload once a hit
        reaches this close to the window end (clamped to a third of the
        window).
      device: where the window lives ('cuda' raises without a card).
    """

    def __init__(self, *, window_seconds=180.0, margin_seconds=1.0,
                 sample_rate=16000, coerce=None, bucket_length=None,
                 device_put=None, prefetch=True,
                 prefetch_lead_seconds=90.0, device='cuda'):
        self.window = int(window_seconds * sample_rate)
        self.margin = int(margin_seconds * sample_rate)
        self.coerce = coerce if coerce is not None else (lambda a: a)
        self.bucket_length = bucket_length if bucket_length is not None \
            else (lambda n: n)
        self.device = resolve_device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == 'cuda' else None)
        self.device_put = device_put if device_put is not None \
            else self.upload
        self.prefetch = prefetch
        self.prefetch_lead = int(prefetch_lead_seconds * sample_rate)
        self._key = None
        self._bases = None
        self._buf = None
        self._disabled = False
        self._wasteful_refills = 0
        self._hit_samples_since_refill = 0
        self._length_cache = {}
        self._executor = None
        self._finalizer = None
        # done-callbacks of discarded in-flight prefetches mutate stats
        # from the worker thread; every mutation of a key that callback
        # touches holds this lock on the owner thread too
        self._stats_lock = threading.Lock()
        self._pending = None          # dict(bases, spec, future) or None
        self._armed = True            # one prefetch per resident window
        self._prefetch_dead = 0       # discarded prefetches this session
        self._max_npad = 0
        self.stats = {'hits': 0, 'refills': 0, 'direct': 0,
                      'refill_mb': 0.0, 'refill_s': 0.0,
                      'prefetch_hits': 0, 'prefetch_wasted': 0,
                      'prefetch_s': 0.0}

    # -- helpers ----------------------------------------------------------

    def upload(self, host):
        """Host array -> tensor on the cache's device.  On the CPU it
        shares the array's memory; on CUDA it is copied from pinned
        memory on the cache's stream, which is synchronized (the JAX
        ``block_until_ready``)."""
        buf = torch.from_numpy(host)
        if self._stream is None:
            return buf
        with torch.cuda.stream(self._stream):
            buf = buf.pin_memory().to(self.device, non_blocking=True)
        self._stream.synchronize()
        return buf

    def _file_length(self, paths):
        """Min length over the per-channel files of one array."""
        key = tuple(paths) if isinstance(paths, (list, tuple)) else paths
        if key not in self._length_cache:
            if isinstance(paths, (list, tuple)):
                self._length_cache[key] = min(
                    audio_length(p) for p in paths)
            else:
                self._length_cache[key] = audio_length(paths)
        return self._length_cache[key]

    def _load_window(self, per_array, bases, name='cache.refill'):
        """Host read + upload of one (A*C, window) window at the given
        per-array bases; returns (buf, nbytes, seconds), the seconds of
        the span ``name``.  Runs on the caller's thread for synchronous
        refills (``cache.refill``) and on the prefetch worker for
        speculative ones (``cache.prefetch``)."""
        with timed_span(name) as timed:
            rows = []
            for (paths, _s, _e, selector), base in zip(per_array, bases):
                # fill_value=0 pads session-tail short reads to exactly
                # `window` samples, so every row is (C, window)
                audio = load_audio(paths, start=base,
                                   stop=base + self.window, dtype=None,
                                   fill_value=0)
                rows.append(self.coerce(np.atleast_2d(audio)[selector]))
            host = np.concatenate(rows, axis=0)
            buf = self.device_put(host)
        return buf, host.nbytes, timed.seconds

    def _refill(self, per_array, starts):
        # timed (host read + upload together): 'refill_s'/'refill_mb'
        # attribute the session's upload cost
        self._bases = [max(0, s - self.margin) for s in starts]
        self._buf, nbytes, dt = self._load_window(per_array, self._bases)
        with self._stats_lock:
            self.stats['refills'] += 1
            self.stats['refill_mb'] += round(nbytes / 1e6, 3)
            self.stats['refill_s'] += round(dt, 4)

    # -- speculative next-window prefetch ----------------------------------

    @staticmethod
    def _spec_key(per_array):
        """Hashable identity of the window's row content apart from the
        base offsets: per-array file paths + channel selector.  A pending
        window may only be adopted for spans with the same key."""
        def norm(sel):
            if isinstance(sel, slice):
                return ('slice', sel.start, sel.stop, sel.step)
            if isinstance(sel, (list, tuple)):
                return ('idx',) + tuple(sel)
            return ('idx', sel)
        return tuple(
            (tuple(p) if isinstance(p, (list, tuple)) else p, norm(sel))
            for (p, _s, _e, sel) in per_array)

    def _maybe_prefetch(self, per_array, starts, n_pad):
        """Called on a hit: when the utterance's far edge is within
        ``prefetch_lead`` of the window end, start uploading the next
        window in the background.  The next base is the current one
        advanced by (window - max_npad - 2*margin): for a session-time-
        ordered schedule the first missing utterance then lands inside
        the pending window."""
        if (not self.prefetch or self._pending is not None
                or not self._armed or self._prefetch_dead >= 2):
            return
        # the effective lead never exceeds a third of the window, so tiny
        # windows don't prefetch on their very first hit
        lead = min(self.prefetch_lead, self.window // 3)
        reach = max(s - b for s, b in zip(starts, self._bases)) + n_pad
        if reach <= self.window - lead:
            return
        advance = self.window - self._max_npad - 2 * self.margin
        if advance <= self.window // 4:   # degenerate window/utterance mix
            return
        bases = [b + advance for b in self._bases]
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix='audio-cache-prefetch')
            # must not capture `self` (the finalizer would keep the
            # cache alive forever); binding the executor is the point
            self._finalizer = weakref.finalize(
                self, self._executor.shutdown, wait=False)
        self._armed = False
        self._pending = {
            'bases': bases,
            'spec': self._spec_key(per_array),
            'future': self._executor.submit(
                self._load_window, list(per_array), bases,
                'cache.prefetch'),
        }

    def _discard_pending(self):
        """Drop the speculative window (if any) with honest accounting
        on every discard path (session change, :meth:`new_run`, cache
        disable, :meth:`close`): a future that can still be cancelled
        moved no bytes; a running or finished upload is charged to
        ``refill_mb`` + ``prefetch_wasted``."""
        pending, self._pending = self._pending, None
        if pending is None:
            return
        future = pending['future']
        if future.cancel():
            return                    # never started: no bytes moved

        def _account(fut):
            with self._stats_lock:
                self.stats['prefetch_wasted'] += 1
                try:
                    _buf, nbytes, dt = fut.result()
                except Exception:
                    return            # failed upload moved ~nothing
                self.stats['refill_mb'] += round(nbytes / 1e6, 3)
                self.stats['prefetch_s'] += round(dt, 4)

        future.add_done_callback(_account)

    def _try_adopt_pending(self, per_array, starts, n_pad):
        """On a miss: adopt the pending speculative window if it covers
        the requested spans (True), else discard it (False either way
        when absent or failed).  Only the blocking wait counts toward
        ``refill_s``; the upload itself is reported as ``prefetch_s``."""
        pending, self._pending = self._pending, None
        if pending is None:
            return False
        try:
            with timed_span('cache.adopt_wait') as wait:
                buf, nbytes, dt = pending['future'].result()
        except Exception:
            self._prefetch_dead += 1
            with self._stats_lock:
                self.stats['prefetch_wasted'] += 1
            return False
        waited = wait.seconds
        covers = (
            pending['spec'] == self._spec_key(per_array)
            and all(s >= b and s - b + n_pad <= self.window
                    for s, b in zip(starts, pending['bases'])))
        if not covers:
            self._prefetch_dead += 1
            with self._stats_lock:
                self.stats['prefetch_wasted'] += 1
                self.stats['refill_mb'] += round(nbytes / 1e6, 3)
            return False
        self._prefetch_dead = 0
        self._bases = pending['bases']
        self._buf = buf
        with self._stats_lock:
            self.stats['refills'] += 1
            self.stats['prefetch_hits'] += 1
            self.stats['refill_mb'] += round(nbytes / 1e6, 3)
            self.stats['refill_s'] += round(waited, 4)
            self.stats['prefetch_s'] += round(dt, 4)
        return True

    # -- public -----------------------------------------------------------

    def new_run(self):
        """Forget the policy verdict and the resident window: a new
        ``enhance_session`` call is a new schedule, so a previous run's
        wasteful-schedule disable must not leak into it."""
        self._key = None
        self._discard_pending()

    def close(self):
        """Shut down the prefetch worker thread (idempotent); a finalizer
        covers callers that drop the cache without closing."""
        self._discard_pending()
        executor, self._executor = self._executor, None
        if executor is not None:
            executor.shutdown(wait=False)
        if self._finalizer is not None:
            self._finalizer.detach()
            self._finalizer = None

    def lookup(self, session_key, per_array):
        """per_array: list of (paths, start, stop, channel_selector) in
        array order.  Returns a :class:`CachedWindow` or None (the caller
        falls back to the direct per-utterance upload)."""
        if session_key != self._key:
            self._key = session_key
            self._bases = None
            self._buf = None
            self._disabled = False
            self._wasteful_refills = 0
            self._hit_samples_since_refill = 0
            self._discard_pending()
            self._armed = True
            self._prefetch_dead = 0
            self._max_npad = 0
        if self._disabled:
            self.stats['direct'] += 1
            return None

        starts = [s for (_p, s, _e, _sel) in per_array]
        # the valid length mirrors the direct path's min-over-arrays
        # truncation, including short reads at the session tail
        N = min(min(e, self._file_length(p)) - s
                for (p, s, e, _sel) in per_array)
        if N <= 0:
            self.stats['direct'] += 1
            return None
        N_pad = self.bucket_length(N)
        if N_pad + self.margin > self.window:
            self.stats['direct'] += 1
            return None                      # utterance too long to cache

        self._max_npad = max(self._max_npad, N_pad)
        hit = self._bases is not None and all(
            s >= b and s - b + N_pad <= self.window
            for s, b in zip(starts, self._bases))
        if hit:
            self._hit_samples_since_refill += N_pad
            self.stats['hits'] += 1
            self._maybe_prefetch(per_array, starts, N_pad)
        else:
            # was the previous window worth its upload?  A refill pays
            # ~window samples per row; the hits it served saved ~N_pad
            # samples per row each.  (The first fill has no predecessor.)
            if self._bases is not None:
                if self._hit_samples_since_refill < self.window:
                    self._wasteful_refills += 1
                else:
                    self._wasteful_refills = 0
                if self._wasteful_refills >= 2:
                    # sparse or unordered schedule: direct upload moves
                    # fewer bytes — give up for this session
                    self._disabled = True
                    self._buf = None
                    self._discard_pending()  # free + account it
                    self.stats['direct'] += 1
                    return None
            self._hit_samples_since_refill = 0
            if not self._try_adopt_pending(per_array, starts, N_pad):
                self._refill(per_array, starts)
            self._armed = True        # new window: one prefetch allowed
        offsets = np.asarray(
            [s - b for s, b in zip(starts, self._bases)], np.int32)
        return CachedWindow(self._buf, offsets, N)
