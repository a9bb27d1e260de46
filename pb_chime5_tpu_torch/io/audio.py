"""load_audio / dump_audio with the reference's call semantics.

Behavioural contract (reference pb_chime5/io/audioread.py:34-224,
audiowrite.py:16-207):

* ``load_audio`` reads a ``[start, stop)`` (or ``start`` + ``frames``)
  segment, returns float64 in [-1, 1) by default (PCM scaled by 2^-15 /
  2^-31), transposed to (channels, samples), mono squeezed to (samples,).
  ``unit='seconds'`` converts start/stop/frames via the file's sample rate.
  ``dtype=None`` returns the file's native dtype unscaled.
* ``dump_audio`` peak-normalizes with the (2^15 - 1) / 2^15 correction (so
  +1.0 never occurs), writes int16 by default, and supports incremental
  writes at a ``start`` offset into an existing file.

The byte-level work is done by the native library ``csrc/wav_ops.cpp``
(built with the host compiler at first use, ``ops/kernels/_build.py``;
one foreign call a read, which opens the file once and releases the
GIL), as the JAX package's ``_wav_ops`` does where it is built.
Incremental writes, ``audio_length`` and ``audio_channels`` use the
Python RIFF parser in ``pb_chime5_tpu_torch.io.wav``;
``_py_read`` is the Python route of a read, the plain version the tests
hold the native one to.

The port's copy of ``pb_chime5_tpu/io/audio.py``.
"""

import ctypes
import os
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.io import wav as _pywav
from pb_chime5_tpu_torch.ops.kernels import _build

# the port builds its native reader from its own source: always there
HAVE_NATIVE = True

__all__ = ['load_audio', 'dump_audio', 'audioread', 'audio_length',
           'audio_channels', 'HAVE_NATIVE']

_PCM_SCALE = {np.dtype(np.int16): 2.0 ** 15, np.dtype(np.int32): 2.0 ** 31}


_DTYPE_FROM_FMT = {
    (1, 16): np.int16, (1, 32): np.int32,
    (3, 32): np.float32, (3, 64): np.float64,
}
_FMT_FROM_DTYPE = {np.dtype(t): fb for fb, t in _DTYPE_FROM_FMT.items()}

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_ERR = (ctypes.c_char_p, _I64)
# the read's allocator: nbytes -> the address of a buffer that outlives it
_ALLOC = ctypes.CFUNCTYPE(_P, _I64)
_READ = ('wav_ops', 'pb_wav_read', (ctypes.c_char_p, _I64, _I64, _ALLOC, _P,
                                    *_ERR))
_WRITE = ('wav_ops', 'pb_wav_write', (ctypes.c_char_p, _P, _I64,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32, _I64, *_ERR))


def _c_path(path):
    raw = os.fsencode(str(path))
    if b'\0' in raw:
        raise ValueError('embedded null character')
    return raw


def _check(code, path, err):
    """Raise what the native entry's return ``code`` stands for: an errno
    (> 0) as ``OSError`` with the path, else its message in ``err``."""
    if code > 0:
        raise OSError(code, os.strerror(code), str(path))
    if code < 0:
        message = err.value.decode(errors='replace')
        raise (ValueError if code == -1 else OSError)(message)


def _native_read(path, start, stop):
    """Frames [start, stop) (``stop`` None or negative: to the end) by the
    native library: (array, sample_rate), as the JAX package's native
    route returns them.  One foreign call opens and parses the file once
    and asks ``alloc`` for the buffer the frames go to."""
    raw_path = _c_path(path)
    err = ctypes.create_string_buffer(len(raw_path) + 128)
    header = (_I64 * 5)()
    buffers = []

    def alloc(nbytes):
        try:
            buffers.append(np.empty(nbytes, np.uint8))
        except BaseException as e:      # raised again after the call
            buffers.append(e)
            return None
        return buffers[0].ctypes.data

    code = _build.kernel_entry(*_READ)(
        raw_path, int(start), -1 if stop is None else int(stop),
        _ALLOC(alloc), header, err, len(err))
    if buffers and isinstance(buffers[0], BaseException):
        raise buffers[0]
    _check(code, path, err)
    channels, bits, fmt, rate, got = header
    data = buffers[0][:got].view(_DTYPE_FROM_FMT[(fmt, bits)]).reshape(
        -1, channels)
    if channels == 1:
        data = data[:, 0]
    return data, rate


def _native_write(path, data, sample_rate):
    """``data`` ((frames,) or (frames, channels), a dtype of
    ``_FMT_FROM_DTYPE``) as a canonical WAV by the native library."""
    fmt, bits = _FMT_FROM_DTYPE[data.dtype]
    data = np.ascontiguousarray(data)
    channels = 1 if data.ndim == 1 else data.shape[1]
    raw_path = _c_path(path)
    err = ctypes.create_string_buffer(len(raw_path) + 128)
    _check(_build.kernel_entry(*_WRITE)(
        raw_path, data.ctypes.data, data.nbytes, channels, bits, fmt,
        int(sample_rate), err, len(err)), path, err)


def _py_read(path, start, stop):
    """The Python route of :func:`_read`'s read (``io/wav.py``)."""
    return _pywav.read_wav(path, start, stop)


def _read(path, start, stop):
    _build.load_library('wav_ops')      # a failed build raises as itself
    try:
        return _native_read(path, start, stop)
    except (ValueError, RuntimeError, EOFError) as e:
        _raise_legacy_read_error(path, e)


def _raise_legacy_read_error(path, cause):
    """Reproduce the reference's diagnostics for non-RIFF inputs
    (pb_chime5/io/audioread.py:197-207): corpora like TIMIT/TIDIGITS ship
    NIST-SPHERE files with a ``.wav`` suffix; the reference pipes the path
    through ``file(1)`` and raises its description, and raises a
    wrong-suffix error for anything that is not ``.wav`` at all."""
    path = Path(path)
    if path.suffix != '.wav':
        raise RuntimeError(
            f'Wrong suffix {path.suffix} in {path}') from cause
    try:
        with open(path, 'rb') as fd:
            magic = fd.read(8)
    except OSError:
        raise cause
    if magic.startswith(b'NIST_1A'):
        try:
            from pb_chime5_tpu_torch.utils.process_caller import run_process
            stdout = run_process(['file', str(path)]).stdout
        except Exception:
            # no file(1) in minimal images: same message it would print
            stdout = f'{path}: NIST SPHERE file\n'
        raise RuntimeError(stdout) from cause
    raise cause


def audio_length(path, unit='samples'):
    """Number of frames (or seconds) in an audio file — header-only."""
    info = _pywav.wav_info(path)
    if unit == 'samples':
        return info.num_frames
    if unit == 'seconds':
        return info.num_frames / info.sample_rate
    raise ValueError(unit)


def audio_channels(path):
    return _pywav.wav_info(path).channels


def load_audio(
        path,
        *,
        frames=-1,
        start=0,
        stop=None,
        dtype=np.float64,
        fill_value=None,
        expected_sample_rate=None,
        unit='samples',
        return_sample_rate=False,
):
    path = Path(path).expanduser()

    if unit == 'seconds':
        sample_rate = _pywav.wav_info(path).sample_rate
        start = int(np.round(start * sample_rate))
        if frames > 0:
            frames = int(np.round(frames * sample_rate))
        if stop is not None and stop > 0:
            stop = int(np.round(stop * sample_rate))
    elif unit != 'samples':
        raise ValueError(unit)

    if frames > 0:
        assert stop is None, (frames, stop)
        stop = start + frames

    data, sample_rate = _read(path, start, stop)

    if expected_sample_rate is not None and \
            expected_sample_rate != sample_rate:
        raise ValueError(
            f'Requested sampling rate is {expected_sample_rate} but the '
            f'audiofile has {sample_rate}')

    requested = None if stop is None else stop - start
    if fill_value is not None and requested is not None and \
            len(data) < requested:
        pad = [(0, requested - len(data))] + [(0, 0)] * (data.ndim - 1)
        data = np.pad(data, pad, constant_values=fill_value)

    if dtype is not None:
        scale = _PCM_SCALE.get(data.dtype)
        data = data.astype(dtype)
        if scale is not None and np.dtype(dtype).kind == 'f':
            data = data / scale

    signal = data.T  # (channels, samples); mono stays (samples,)

    if return_sample_rate:
        return signal, sample_rate
    return signal


def audioread(path, offset=0.0, duration=None, expected_sample_rate=None):
    """Legacy reader API (reference pb_chime5/io/audioread.py:227-300):
    seconds-based offset/duration, float32 output, (signal, sample_rate)
    return.  No implicit resampling — a mismatched
    ``expected_sample_rate`` raises, like the reference."""
    signal, sample_rate = load_audio(
        path,
        start=offset,
        frames=-1 if duration is None else duration,
        unit='seconds',
        dtype=np.float32,
        expected_sample_rate=expected_sample_rate,
        return_sample_rate=True,
    )
    return signal, sample_rate


def dump_audio(
        obj,
        path,
        *,
        sample_rate=16000,
        dtype=np.int16,
        start=None,
        normalize=True,
):
    path = Path(path).expanduser()
    obj = np.asarray(obj)

    if normalize:
        if obj.dtype.kind not in 'fi':
            raise TypeError(
                f'Only float and int supported with normalize, '
                f'got {obj.dtype}')
        assert dtype == np.int16, (
            f'normalize is only allowed for dtype == np.int16, not {dtype}')
        correction = (2 ** 15 - 1) / (2 ** 15)
        peak = np.amax(np.abs(obj))
        if peak > 0:
            obj = obj * (correction / peak)

    if dtype is None:
        out = obj
    elif np.dtype(dtype).kind == 'i' and obj.dtype.kind == 'f':
        scale = _PCM_SCALE[np.dtype(dtype)]
        info = np.iinfo(dtype)
        out = np.clip(np.round(obj * scale), info.min, info.max).astype(dtype)
    else:
        out = obj.astype(dtype)

    # host convention is (channels, samples); files store (frames, channels)
    data = out.T if out.ndim == 2 else out

    if start is None and data.dtype in _FMT_FROM_DTYPE:
        _native_write(path, data, sample_rate)
        return
    _pywav.write_wav(path, data, sample_rate, start=start)
