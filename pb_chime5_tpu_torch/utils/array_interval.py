"""A sparse boolean 1-D array stored as sorted (start, stop) intervals —
the port of ``pb_chime5_tpu/utils/array_interval.py`` (reference
pb_chime5/utils/intervall_array.py:103-455).

A 2.5 h session's activity track costs O(#intervals), not O(#samples):
slice get and set (scalar or boolean array values), construction from a
dense array, an interval string or an RTTM file, and pickling through the
compact string form.  The intervals are kept normalized (sorted, disjoint,
non-touching) after every edit.
"""

import decimal
from pathlib import Path

import numpy as np

__all__ = ['ArrayInterval', 'array_interval_from_str',
           'array_intervals_from_rttm']


def _subtract(intervals, start, stop):
    """``intervals`` with [start, stop) removed (half-open)."""
    kept = []
    for s, e in intervals:
        if e <= start or s >= stop:
            kept.append((s, e))
            continue
        if s < start:
            kept.append((s, start))
        if e > stop:
            kept.append((stop, e))
    return kept


def _normalize(intervals):
    """Sort, drop empties, merge touching or overlapping intervals."""
    merged = []
    for s, e in sorted(iv for iv in intervals if iv[0] < iv[1]):
        if merged and s <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], e))
        else:
            merged.append((s, e))
    return merged


def _str_to_intervals(string):
    out = []
    for part in string.replace(' ', '').strip(',').split(','):
        s, e = part.split(':')
        out.append((int(s), int(e)))
    return out


def array_interval_from_str(string, shape):
    """'1:4, 5:20' -> ArrayInterval (the inverse of its string form)."""
    ai = ArrayInterval(shape)
    if string:
        ai._intervals = _normalize(_str_to_intervals(string))
    return ai


class ArrayInterval:
    """Boolean 1-D array of ``shape`` stored as (start, stop) intervals.
    ``a[s:e] = 1 / 0`` or a boolean array of length e - s, and ``a[s:e]``
    -> bool array.  ``shape`` None leaves the length open (an RTTM track):
    then every slice needs a stop, and no bound is checked."""

    from_str = staticmethod(array_interval_from_str)

    def __init__(self, shape):
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        if shape is not None:
            shape = tuple(int(s) for s in shape)
            assert len(shape) == 1, shape
        self.shape = shape
        self._intervals = []            # sorted, disjoint, non-touching

    @staticmethod
    def from_array(array):
        """A dense 1-D bool array -> ArrayInterval of its length."""
        array = np.asarray(array)
        assert array.ndim == 1, array.ndim
        assert array.dtype == bool, array.dtype
        ai = ArrayInterval(array.shape)
        ai._intervals = _runs(array)
        return ai

    def __reduce__(self):
        # the compact string form, rebuilt by this module's function: a
        # pickle of the port loads where only the port is installed
        return array_interval_from_str, (
            self._intervals_as_str,
            None if self.shape is None else self.shape[-1])

    def __len__(self):
        return self.shape[0]

    def __eq__(self, other):
        if not isinstance(other, ArrayInterval):
            return NotImplemented
        return (self.shape == other.shape
                and self._intervals == other._intervals)

    def __repr__(self):
        return (f'{type(self).__name__}("{self._intervals_as_str}", '
                f'shape={self.shape})')

    @property
    def intervals(self):
        return tuple(self._intervals)

    normalized_intervals = intervals

    @property
    def _intervals_as_str(self):
        return ', '.join(f'{s}:{e}' for s, e in self._intervals)

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

    def add_intervals_from_str(self, string):
        self._intervals = _normalize(self._intervals
                                     + _str_to_intervals(string))

    def add_intervals(self, slices):
        """Set each slice of ``slices`` to True."""
        for item in slices:
            self[item] = 1

    def __setitem__(self, item, value):
        start, stop = self._bounds(item)
        kept = _subtract(self._intervals, start, stop)
        if isinstance(value, (tuple, list, np.ndarray)):
            value = np.asarray(value, dtype=bool)
            assert len(value) == stop - start, (start, stop, len(value))
            kept += [(s + start, e + start) for s, e in _runs(value)]
        elif np.isscalar(value) and value in (1, True):
            kept.append((start, stop))
        elif not (np.isscalar(value) and value in (0, False)):
            raise NotImplementedError(value)
        self._intervals = _normalize(kept)

    def __getitem__(self, item):
        start, stop = self._bounds(item)
        out = np.zeros(max(stop - start, 0), bool)
        for s, e in self._intervals:
            s, e = max(s, start), min(e, stop)
            if s < e:
                out[s - start:e - start] = True
        return out

    def sum(self):
        """The number of True samples, in O(#intervals)."""
        return sum(e - s for s, e in self._intervals)


def _runs(array):
    """The (start, stop) runs of True in a 1-D bool array."""
    diff = np.diff(array.astype(np.int8))
    rising = (np.nonzero(diff > 0)[0] + 1).tolist()
    falling = (np.nonzero(diff < 0)[0] + 1).tolist()
    if len(array) and array[0]:
        rising = [0] + rising
    if len(array) and array[-1]:
        falling = falling + [len(array)]
    return list(zip(rising, falling))


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
