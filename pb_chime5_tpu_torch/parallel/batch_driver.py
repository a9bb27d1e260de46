"""Batch collation driver: feeds the session loop onto a device mesh —
port of ``pb_chime5_tpu/parallel/batch_driver.py``.

Utterances are collated into same-shape groups, keyed by (channels,
bucketed length, classes), and for items served by the session-audio
cache also by the window they are sliced from; each full group is
dispatched as one batch over the ``('data', 'freq')`` mesh
(``parallel/mesh.py``), every data group's rows on its own device and
every kernel launch over all of its rows.

Numerics are those of the serial path: both run the same ``models/gss.py``
stages on the same padded bucket shapes, with per-row valid-sample masks,
target indices and context-drop frame counts.  A batch of one row is the
serial chain bit for bit.

Partial groups (end of session, rare shapes) are dispatched with their
real rows only: the JAX package repeats the first row to reuse one
compiled program, and an eager chain has none to reuse.  The rows are
split over the data groups as evenly as they go, so each data group that
runs gets at least one; with fewer rows than data groups the rest idle.
"""

import dataclasses

import numpy as np
import torch

from pb_chime5_tpu_torch.parallel.mesh import (
    sharded_gss_enhance, sharded_gss_enhance_cached)

__all__ = ['BatchDispatcher', 'DispatchedBatch']


@dataclasses.dataclass
class _PendingItem:
    tag: object              # caller's cookie (e.g. example dict)
    num_valid_samples: int   # true length before bucket padding
    obs: np.ndarray          # (D, N_pad) normalized; None for cached items
    activity: np.ndarray     # (K, T_pad) int8
    target_index: int
    start_context_frames: int
    end_context_frames: int
    offsets: np.ndarray = None   # (A,) int32 for session-cache items


@dataclasses.dataclass
class DispatchedBatch:
    """One batch in flight: ``handle`` is its (B, N_pad) waveform in pinned
    host memory (or on the CPU), filled behind the device's work, and
    ``done`` the event that marks its arrival (None off the card);
    ``items`` the rows' metadata."""
    handle: object
    items: list
    done: object = None

    def gather(self):
        """Wait for the batch; yields (tag, x_hat[:valid]) per row."""
        if self.done is not None:
            self.done.synchronize()
        out = self.handle.numpy()
        for row, item in zip(out, self.items):
            yield item.tag, row[:item.num_valid_samples]


class BatchDispatcher:
    """Collates utterances into mesh-wide batches.

    ``pipeline`` (a ``models.gss.GssPipeline``) supplies the config, the
    length buckets and the observation dtype, the serial path's
    quantization and bucketing.  ``utterances_per_device`` rows are
    stacked per data group: 1 (default) keeps each row the serial
    chain's; more amortize each launch over more utterances.
    """

    def __init__(self, mesh, pipeline, *, utterances_per_device=1):
        assert utterances_per_device >= 1, utterances_per_device
        self.mesh = mesh
        self.pipeline = pipeline
        self.batch_size = mesh.shape['data'] * utterances_per_device
        self._groups = {}        # (D, N_pad, K) -> [_PendingItem]
        self._windows = {}       # cached-group key -> device window

    def _activity(self, activity_freq, N_pad):
        T_pad = self.pipeline.frame_count(N_pad)
        act = np.zeros((activity_freq.shape[0], T_pad), np.int8)
        act[:, :activity_freq.shape[1]] = np.asarray(
            activity_freq, np.int8)[:, :T_pad]
        return act

    def _queue(self, key, item):
        group = self._groups.setdefault(key, [])
        group.append(item)
        if len(group) >= self.batch_size:
            del self._groups[key]
            return self._dispatch(key, group)
        return None

    def add(self, obs, activity_freq, target_index, *,
            start_context_frames=0, end_context_frames=0, tag=None):
        """Queue one utterance; returns a DispatchedBatch when this
        addition filled a group, else None."""
        obs = self.pipeline._normalize_obs(obs)
        D, N = obs.shape
        N_pad = self.pipeline.bucket_length(N)
        padded = np.zeros((D, N_pad), obs.dtype)
        padded[:, :N] = obs
        act = self._activity(activity_freq, N_pad)
        item = _PendingItem(
            tag=tag, num_valid_samples=N, obs=padded, activity=act,
            target_index=int(target_index),
            start_context_frames=int(start_context_frames),
            end_context_frames=int(end_context_frames))
        return self._queue((D, N_pad, act.shape[0]), item)

    def add_cached(self, window, offsets, num_valid_samples,
                   activity_freq, target_index, *,
                   start_context_frames=0, end_context_frames=0,
                   tag=None):
        """Queue one utterance served by the device-resident session-audio
        window (``models/audio_cache.py``): it carries (A,) offsets, not
        the observation.  The rows of a batch share one window, so the
        group key carries the window's identity: a refill starts a new
        group, and the old one keeps its window alive until it is
        dispatched."""
        N = int(num_valid_samples)
        N_pad = self.pipeline.bucket_length(N)
        act = self._activity(activity_freq, N_pad)
        offsets = np.asarray(offsets, np.int32)
        W = window.shape[1]
        if offsets.min() < 0 or offsets.max() + N_pad > W:
            raise ValueError(f'offsets {offsets} + {N_pad} samples outside '
                             f'the window of {W}')
        item = _PendingItem(
            tag=tag, num_valid_samples=N, obs=None, activity=act,
            target_index=int(target_index),
            start_context_frames=int(start_context_frames),
            end_context_frames=int(end_context_frames), offsets=offsets)
        key = ('cached', id(window), len(offsets), N_pad, act.shape[0])
        self._windows[key] = window
        return self._queue(key, item)

    def flush(self):
        """Dispatch every partial group; returns a list of
        DispatchedBatch."""
        batches = [self._dispatch(key, group)
                   for key, group in self._groups.items()]
        self._groups.clear()
        return batches

    @property
    def pending_count(self):
        return sum(len(g) for g in self._groups.values())

    def _dispatch(self, key, items):
        act = np.stack([r.activity for r in items])
        per_row = dict(
            target_index=np.array([r.target_index for r in items]),
            num_valid_samples=np.array([r.num_valid_samples for r in items]),
            start_context_frames=np.array([r.start_context_frames
                                           for r in items]),
            end_context_frames=np.array([r.end_context_frames
                                         for r in items]))
        config = self.pipeline.config
        if key[0] == 'cached':
            _tag, _wid, A, N_pad, _K = key
            window = self._windows.pop(key)
            if window.device.type == 'cuda':
                # the window returns to its upload stream's pool when the
                # cache drops it: reused only after the work enqueued here
                window.record_stream(
                    torch.cuda.current_stream(window.device))
            out = sharded_gss_enhance_cached(
                self.mesh, window, np.stack([r.offsets for r in items]),
                act, config=config, num_arrays=A, slice_samples=N_pad,
                num_output_samples=N_pad, **per_row)
        else:
            N_pad = key[1]
            out = sharded_gss_enhance(
                self.mesh, np.stack([r.obs for r in items]), act,
                config=config, num_output_samples=N_pad, **per_row)
        done = None
        if out.device.type == 'cuda':
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(out.device))
            out = host
        return DispatchedBatch(handle=out, items=items, done=done)
