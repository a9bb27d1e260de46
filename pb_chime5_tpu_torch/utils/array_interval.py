"""A sparse boolean 1-D array stored as sorted (start, stop) intervals —
the port of ``pb_chime5_tpu/utils/array_interval.py`` (reference
pb_chime5/utils/intervall_array.py:103-455).

A 2.5 h session's activity track costs O(#intervals), not O(#samples):
slice get and set (scalar or boolean array values), construction from a
dense array, an interval string or an RTTM file, and pickling through the
compact string form.  An edit appends or cuts; the intervals are
normalized (sorted, disjoint, non-touching) at the first read after it,
as the JAX package's are.

The interval algebra (intersection, subtraction, normalization, parsing)
runs in the native library ``csrc/interval_ops.cpp`` (built with the host
compiler at first use, ``ops/kernels/_build.py``), as the JAX package's
runs in its ``_interval_ops`` where it is built; the ``_py_*`` functions
are the plain versions the tests hold it to.
"""

import ctypes
import decimal
import itertools
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.ops.kernels import _build

# the port builds its native algebra from its own source: always there
HAVE_NATIVE = True

__all__ = ['ArrayInterval', 'array_interval_from_str',
           'array_intervals_from_rttm', 'HAVE_NATIVE']


# --------------------------------------------------------------------------
# interval algebra: the plain versions (the native library mirrors these)
# --------------------------------------------------------------------------

def _py_intersection(interval, intervals):
    start, end = interval
    out = []
    for i_start, i_end in intervals:
        s = max(start, i_start)
        e = min(end, i_end)
        if s < e:
            out.append((s, e))
    return tuple(out)


def _py_non_intersection(interval, intervals):
    """Half-open set subtraction: remove [start, end) from every
    interval."""
    start, end = interval
    out = []
    for i_start, i_end in intervals:
        if i_end <= start or i_start >= end:      # disjoint
            out.append((i_start, i_end))
            continue
        if i_start < start:                        # left remainder
            out.append((i_start, start))
        if i_end > end:                            # right remainder
            out.append((end, i_end))
    return tuple(out)


def _py_normalize(intervals):
    """Sort, drop empties, merge touching or overlapping intervals."""
    ivs = sorted((s, e) for s, e in intervals if s < e)
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return tuple(out)


def _py_str_to_intervals(string):
    out = []
    for part in string.replace(' ', '').strip(',').split(','):
        s, e = part.split(':')
        out.append((int(s), int(e)))
    return tuple(out)


# --------------------------------------------------------------------------
# interval algebra: the native library (flat int64 buffers of n pairs)
# --------------------------------------------------------------------------

_I64, _P = ctypes.c_int64, ctypes.c_void_p


def _entry(name, argtypes):
    return _build.kernel_entry('interval_ops', name, argtypes, _I64)


def _pairs(intervals):
    """``intervals`` as a flat int64 buffer of (start, stop) pairs."""
    flat = np.fromiter(itertools.chain.from_iterable(intervals), np.int64)
    if len(flat) != 2 * len(intervals):
        raise ValueError('interval must have exactly 2 items')
    return flat


def _tuples(out, n):
    """The first ``n`` pairs of ``out`` as a tuple of (start, stop)."""
    flat = iter(out[:2 * n].tolist())
    return tuple(zip(flat, flat))


def _clip(name, interval, intervals, rows):
    """``name`` (intersection or subtraction) of ``interval`` with
    ``intervals``, into ``rows`` x the input's pairs."""
    ivs = _pairs(intervals)
    out = np.empty(rows * len(ivs), np.int64)
    n = _entry(name, (_I64, _I64, _P, _I64, _P))(
        int(interval[0]), int(interval[1]), ivs.ctypes.data, len(ivs) // 2,
        out.ctypes.data)
    return _tuples(out, n)


def _intersection(interval, intervals):
    return _clip('pb_intersection', interval, intervals, 1)


def _non_intersection(interval, intervals):
    return _clip('pb_non_intersection', interval, intervals, 2)


def _normalize(intervals):
    ivs = _pairs(intervals)
    out = np.empty_like(ivs)
    n = _entry('pb_normalize', (_P, _I64, _P))(
        ivs.ctypes.data, len(ivs) // 2, out.ctypes.data)
    return _tuples(out, n)


def _str_to_intervals(string):
    text = string.encode()
    if b'\0' in text:
        raise ValueError('embedded null character')
    out = np.empty(2 * (text.count(b',') + 1), np.int64)
    err = ctypes.create_string_buffer(len(text) + 64)
    n = _entry('pb_str_to_intervals', (ctypes.c_char_p, _P, _I64,
                                       ctypes.c_char_p, _I64))(
        text, out.ctypes.data, len(out) // 2, err, len(err))
    if n < 0:
        raise ValueError(err.value.decode(errors='replace'))
    return _tuples(out, n)


def array_interval_from_str(string, shape):
    """'1:4, 5:20' -> ArrayInterval (the inverse of its string form)."""
    ai = ArrayInterval(shape)
    if string:
        ai._set(_str_to_intervals(string))
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
        self._intervals = ()
        self._normalized = True         # sorted, disjoint, non-touching

    @staticmethod
    def from_array(array):
        """A dense 1-D bool array -> ArrayInterval of its length."""
        array = np.asarray(array)
        assert array.ndim == 1, array.ndim
        assert array.dtype == bool, array.dtype
        ai = ArrayInterval(array.shape)
        ai._intervals = _runs(array)    # normalized as they come
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
                and self.intervals == other.intervals)

    def __repr__(self):
        return (f'{type(self).__name__}("{self._intervals_as_str}", '
                f'shape={self.shape})')

    @property
    def intervals(self):
        if not self._normalized:
            self._intervals = _normalize(self._intervals)
            self._normalized = True
        return self._intervals

    normalized_intervals = intervals

    def _set(self, intervals):
        """Edits append or cut and leave the merge to the next read, as
        the JAX package's ``ArrayInterval`` does: a run of ``[s:e] = 1``
        costs no foreign call."""
        self._intervals = intervals
        self._normalized = False

    @property
    def _intervals_as_str(self):
        return ', '.join(f'{s}:{e}' for s, e in self.intervals)

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
        self._set(self._intervals + _str_to_intervals(string))

    def add_intervals(self, slices):
        """Set each slice of ``slices`` to True."""
        for item in slices:
            self[item] = 1

    def __setitem__(self, item, value):
        start, stop = self._bounds(item)
        if isinstance(value, (tuple, list, np.ndarray)):
            value = np.asarray(value, dtype=bool)
            assert len(value) == stop - start, (start, stop, len(value))
            self._set(_non_intersection((start, stop), self.intervals)
                      + tuple((s + start, e + start) for s, e in _runs(value)))
        elif np.isscalar(value) and value in (1, True):
            self._set(self._intervals + ((start, stop),))
        elif np.isscalar(value) and value in (0, False):
            self._set(_non_intersection((start, stop), self.intervals))
        else:
            raise NotImplementedError(value)

    def __getitem__(self, item):
        start, stop = self._bounds(item)
        out = np.zeros(max(stop - start, 0), bool)
        for s, e in _intersection((start, stop), self.intervals):
            out[s - start:e - start] = True
        return out

    def sum(self):
        """The number of True samples, in O(#intervals)."""
        return sum(e - s for s, e in self.intervals)


def _runs(array):
    """The (start, stop) runs of True in a 1-D bool array."""
    diff = np.diff(array.astype(np.int8))
    rising = (np.nonzero(diff > 0)[0] + 1).tolist()
    falling = (np.nonzero(diff < 0)[0] + 1).tolist()
    if len(array) and array[0]:
        rising = [0] + rising
    if len(array) and array[-1]:
        falling = falling + [len(array)]
    return tuple(zip(rising, falling))


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
