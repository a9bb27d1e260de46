"""Host I/O of the session loop: segmented WAV reads, WAV writes, JSON.

Same call semantics as ``pb_chime5_tpu.io`` for what the port uses:

* ``load_audio(path, start=, stop=, dtype=)`` reads ``[start, stop)``
  by seeking, as (channels, samples) (mono: (samples,)); PCM is scaled
  to [-1, 1) for a float ``dtype`` (default float64); ``dtype=None``
  keeps the file's samples unscaled.  A list of paths loads as one
  stacked array (a CHiME array's 4 per-channel files -> (4, N)).
  ``fill_value=`` pads a read that the end of the file cuts short to
  exactly ``stop - start`` samples.
* ``audio_length(path)`` is a file's number of frames, from its header.
* ``dump_audio`` peak-normalizes with the (2^15 - 1) / 2^15 correction
  and writes 16 kHz int16 by default; ``dtype=None`` writes the array's
  own float or int type.
* ``symlink(source, link_name, override=)`` makes a link idempotently.

WAV support: PCM 16/32 bit and IEEE float 32/64, including
WAVE_FORMAT_EXTENSIBLE headers.
"""

import datetime
import json
import os
import struct
from pathlib import Path

import numpy as np

__all__ = ['load_audio', 'audio_length', 'dump_audio', 'load_json',
           'dump_json', 'symlink']

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE
_DTYPES = {(_FMT_PCM, 16): np.int16, (_FMT_PCM, 32): np.int32,
           (_FMT_FLOAT, 32): np.float32, (_FMT_FLOAT, 64): np.float64}
_PCM_SCALE = {np.dtype(np.int16): 2.0 ** 15, np.dtype(np.int32): 2.0 ** 31}
SAMPLE_RATE = 16000


def _wav_header(f, path):
    """-> (dtype, channels, sample_rate, num_frames, data offset)."""
    riff, _, wave = struct.unpack('<4sI4s', f.read(12).ljust(12, b'\0'))
    if riff != b'RIFF' or wave != b'WAVE':
        raise ValueError(f'{path}: not a RIFF/WAVE file')
    fmt = None
    while True:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f'{path}: no data chunk found')
        chunk_id, size = struct.unpack('<4sI', head)
        if chunk_id == b'fmt ':
            data = f.read(size)
            if len(data) < 16:
                raise ValueError(f'{path}: truncated fmt chunk')
            audio_format, channels, rate, _, _, bits = struct.unpack(
                '<HHIIHH', data[:16])
            if audio_format == _FMT_EXTENSIBLE and len(data) >= 26:
                audio_format = struct.unpack('<H', data[24:26])[0]
            fmt = (audio_format, channels, rate, bits)
        elif chunk_id == b'data':
            if fmt is None:
                raise ValueError(f'{path}: data chunk before fmt chunk')
            audio_format, channels, rate, bits = fmt
            if (audio_format, bits) not in _DTYPES:
                raise ValueError(
                    f'{path}: unsupported format {audio_format}/{bits} bit')
            frame_bytes = channels * bits // 8
            return (np.dtype(_DTYPES[audio_format, bits]), channels, rate,
                    size // frame_bytes, f.tell())
        else:
            f.seek(size + (size & 1), 1)


def _load_one(path, start, stop, dtype, fill_value):
    path = Path(path).expanduser()
    requested = None if stop is None else stop - start
    with open(path, 'rb') as f:
        file_dtype, channels, _, num_frames, offset = _wav_header(f, path)
        stop = num_frames if stop is None else min(stop, num_frames)
        start = min(max(start, 0), num_frames)
        count = max(stop - start, 0)
        f.seek(offset + start * channels * file_dtype.itemsize)
        raw = f.read(count * channels * file_dtype.itemsize)
    data = np.frombuffer(raw, file_dtype).reshape(-1, channels)
    if fill_value is not None and requested is not None \
            and len(data) < requested:
        data = np.pad(data, [(0, requested - len(data)), (0, 0)],
                      constant_values=fill_value)
    if channels == 1:
        data = data[:, 0]
    if dtype is not None:
        scale = _PCM_SCALE.get(file_dtype)
        data = data.astype(dtype)
        if scale is not None and np.dtype(dtype).kind == 'f':
            data = data / scale
    return data.T


def load_audio(path, *, start=0, stop=None, dtype=np.float64,
               fill_value=None):
    """Samples ``[start, stop)`` of a WAV file, or of each file of a
    list (stacked); with ``fill_value``, a read cut short by the end of
    the file is padded with it to ``stop - start`` samples."""
    if isinstance(path, (list, tuple)):
        return np.array([_load_one(p, start, stop, dtype, fill_value)
                         for p in path])
    return _load_one(path, start, stop, dtype, fill_value)


def audio_length(path):
    """Number of frames of a WAV file, read from its header."""
    path = Path(path).expanduser()
    with open(path, 'rb') as f:
        return _wav_header(f, path)[3]


def dump_audio(obj, path, *, dtype=np.int16, normalize=True):
    """Write (samples,) or (channels, samples) as a 16 kHz WAV file."""
    obj = np.asarray(obj)
    if normalize:
        if obj.dtype.kind not in 'fi':
            raise TypeError(f'normalize needs float or int, got {obj.dtype}')
        assert dtype == np.int16, f'normalize needs dtype int16, not {dtype}'
        peak = np.amax(np.abs(obj))
        if peak > 0:
            obj = obj * ((2 ** 15 - 1) / 2 ** 15 / peak)
    if dtype is None:
        out = obj
    elif np.dtype(dtype).kind == 'i' and obj.dtype.kind == 'f':
        info = np.iinfo(dtype)
        out = np.clip(np.round(obj * _PCM_SCALE[np.dtype(dtype)]),
                      info.min, info.max).astype(dtype)
    else:
        out = obj.astype(dtype)
    data = out.T if out.ndim == 2 else out[:, None]          # (frames, ch)
    fmt = {np.dtype(v): k for k, v in _DTYPES.items()}.get(data.dtype)
    if fmt is None:
        raise ValueError(f'unsupported dtype {data.dtype}')
    audio_format, bits = fmt
    frames, channels = data.shape
    block = channels * bits // 8
    header = struct.pack(
        '<4sI4s4sIHHIIHH4sI', b'RIFF', 36 + frames * block, b'WAVE',
        b'fmt ', 16, audio_format, channels, SAMPLE_RATE,
        SAMPLE_RATE * block, block, bits, b'data', frames * block)
    with open(Path(path).expanduser(), 'wb') as f:
        f.write(header)
        f.write(np.ascontiguousarray(data).tobytes())


def symlink(source, link_name, *, override=False):
    """Point ``link_name`` at ``source``; nothing to do when it already
    does.  A link to elsewhere is replaced with ``override``, else
    ``FileExistsError`` (reference io/file_handling.py:24-80)."""
    link_name = Path(link_name).expanduser()
    source = Path(source)
    if link_name.is_symlink():
        if os.readlink(link_name) == str(source):
            return
        if not override:
            raise FileExistsError(
                f'{link_name} already points to {os.readlink(link_name)}')
        link_name.unlink()
    link_name.symlink_to(source)


class _Encoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, Path):
            return str(obj)
        if isinstance(obj, (datetime.datetime, datetime.date)):
            return obj.isoformat()
        return super().default(obj)


def load_json(path):
    with open(Path(path).expanduser()) as f:
        return json.load(f)


def dump_json(obj, path):
    path = Path(path).expanduser()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, cls=_Encoder, indent=2, sort_keys=True)
