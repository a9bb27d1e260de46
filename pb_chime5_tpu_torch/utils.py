"""Host-side helpers of the session loop: a keyed dict with helpful
errors, a sparse boolean activity track, and sample -> STFT-frame
activity pooling.

Counterparts of ``pb_chime5_tpu.utils`` (``Dispatcher``,
``ArrayInterval``, ``array_intervals_from_rttm``,
``activity_time_to_frequency``), reduced to what the enhancers use.
"""

import decimal
from pathlib import Path

import numpy as np

__all__ = ['Dispatcher', 'ArrayInterval', 'array_intervals_from_rttm',
           'segment_axis', 'activity_time_to_frequency']


class Dispatcher(dict):
    """A dict whose KeyError lists the available keys."""

    def __getitem__(self, item):
        try:
            return super().__getitem__(item)
        except KeyError:
            raise KeyError(
                f'Invalid option {item!r}. Possible keys are '
                f'{tuple(self.keys())!r}.') from None


class ArrayInterval:
    """Boolean 1-D array of ``shape`` stored as (start, stop) intervals:
    a 2.5 h session's activity track costs O(#utterances), not
    O(#samples).  Supports ``a[s:e] = 1 / 0`` and ``a[s:e]`` -> bool
    array.  ``shape`` None leaves the length open (an RTTM track): then
    every slice needs a stop, and no bound is checked."""

    def __init__(self, shape):
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        if shape is not None:
            shape = tuple(int(s) for s in shape)
            assert len(shape) == 1, shape
        self.shape = shape
        self._intervals = []            # sorted, disjoint, non-touching

    def __len__(self):
        return self.shape[0]

    def _bounds(self, item):
        assert isinstance(item, slice) and item.step is None, item
        start = 0 if item.start is None else item.start
        if item.stop is None:
            assert self.shape is not None, 'open-ended slice needs a shape'
            stop = self.shape[0]
        else:
            stop = item.stop
        assert start >= 0 and stop >= 0, (start, stop)
        if self.shape is not None:
            assert start <= self.shape[0] and stop <= self.shape[0], \
                (start, stop, self.shape)
        return start, stop

    @property
    def intervals(self):
        return tuple(self._intervals)

    normalized_intervals = intervals

    def add_intervals(self, slices):
        """Set each slice of ``slices`` to True."""
        for item in slices:
            self[item] = 1

    def __setitem__(self, item, value):
        start, stop = self._bounds(item)
        kept = []
        for s, e in self._intervals:       # subtract [start, stop)
            if e <= start or s >= stop:
                kept.append((s, e))
                continue
            if s < start:
                kept.append((s, start))
            if e > stop:
                kept.append((stop, e))
        if value in (1, True):
            kept.append((start, stop))
        elif value not in (0, False):
            raise NotImplementedError(value)
        merged = []
        for s, e in sorted(iv for iv in kept if iv[0] < iv[1]):
            if merged and s <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], e))
            else:
                merged.append((s, e))
        self._intervals = merged

    def __getitem__(self, item):
        start, stop = self._bounds(item)
        out = np.zeros(max(stop - start, 0), bool)
        for s, e in self._intervals:
            s, e = max(s, start), min(e, stop)
            if s < e:
                out[s - start:e - start] = True
        return out


def array_intervals_from_rttm(rttm_file, shape=None, sample_rate=16000):
    """An RTTM file -> ``{file_id: {speaker: ArrayInterval}}``.

    A line reads ``SPEAKER <file-id> <chan> <begin> <duration> <NA> <NA>
    <name> <NA>``, times in seconds; each must land on a whole sample
    (reference intervall_array.py:96-99)."""
    data = {}
    for line in Path(rttm_file).read_text().splitlines():
        if not line.strip():
            continue
        parts = line.split()
        assert parts[0] == 'SPEAKER', parts
        begin = decimal.Decimal(parts[3]) * sample_rate
        end = begin + decimal.Decimal(parts[4]) * sample_rate
        assert begin == int(begin), (line, begin)
        assert end == int(end), (line, end)
        speakers = data.setdefault(parts[1], {})
        if parts[7] not in speakers:
            speakers[parts[7]] = ArrayInterval(shape)
        speakers[parts[7]][int(begin):int(end)] = 1
    return data


def segment_axis(x, length: int, shift: int, *, end='pad'):
    """Frame the last axis into overlapping segments (..., T, length);
    ``end='pad'`` zero-pads the tail to a full segment, ``'cut'`` drops
    it."""
    x = np.asarray(x)
    n = x.shape[-1]
    if end == 'pad':
        frames = max(1, -(-(n - length + shift) // shift))
        full = (frames - 1) * shift + length
        if full > n:
            x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, full - n)])
    elif end == 'cut':
        frames = (n - length + shift) // shift
        if frames < 1:
            raise ValueError(f'signal too short: {n} < {length} (cut)')
        x = x[..., :(frames - 1) * shift + length]
    else:
        raise ValueError(end)
    strides = x.strides[:-1] + (shift * x.strides[-1], x.strides[-1])
    return np.lib.stride_tricks.as_strided(
        x, shape=x.shape[:-1] + (frames, length), strides=strides,
        writeable=False)


def activity_time_to_frequency(time_activity, stft_window_length: int,
                               stft_shift: int, stft_fading: bool,
                               stft_pad: bool = True):
    """(..., N) sample activity -> (..., T) frame activity: a frame is
    active iff any sample under its window is."""
    time_activity = np.asarray(time_activity)
    assert time_activity.dtype != object, time_activity.dtype
    if stft_fading:
        pad = stft_window_length - stft_shift
        time_activity = np.pad(
            time_activity, [(0, 0)] * (time_activity.ndim - 1) + [(pad, pad)])
    return segment_axis(time_activity, stft_window_length, stft_shift,
                        end='pad' if stft_pad else 'cut').any(axis=-1)
