"""Minimal RIFF/WAVE parser with segmented reads and incremental writes.

Replaces the reference's libsndfile dependency (pb_chime5/io/audioread.py
uses soundfile) for the formats the CHiME data actually uses: PCM 16/32,
IEEE float 32/64, mono or multichannel.  Supports:

* header-only probing (``wav_info``),
* reading an arbitrary ``[start, stop)`` sample range without touching the
  rest of the file (seek-based, like soundfile's ``start``/``stop``),
* writing, including incremental writes at a sample offset into an
  existing file (the reference's ``dump_audio(..., start=...)`` r+ mode,
  audiowrite.py:164-206).

The port's only reader and writer (the JAX package also has a native
twin, ``cpp/wav_ops.cpp``, which the port does not build).

The port's copy of ``pb_chime5_tpu/io/wav.py``.
"""

import dataclasses
import struct
from pathlib import Path

import numpy as np

__all__ = ['WavInfo', 'wav_info', 'read_wav', 'write_wav']

_FMT_PCM = 1
_FMT_FLOAT = 3
_FMT_EXTENSIBLE = 0xFFFE


@dataclasses.dataclass
class WavInfo:
    channels: int
    sample_rate: int
    bits_per_sample: int
    audio_format: int
    num_frames: int
    data_offset: int        # file offset of the first audio byte
    data_bytes: int

    @property
    def dtype(self):
        if self.audio_format == _FMT_PCM:
            return {16: np.int16, 32: np.int32, 8: np.uint8}[
                self.bits_per_sample]
        if self.audio_format == _FMT_FLOAT:
            return {32: np.float32, 64: np.float64}[self.bits_per_sample]
        raise ValueError(f'unsupported wav format {self.audio_format}')

    @property
    def bytes_per_frame(self):
        return self.channels * self.bits_per_sample // 8


def _parse_header(f, path):
    head = f.read(12)
    if len(head) < 12:
        raise ValueError(f'{path}: truncated file ({len(head)} bytes, '
                         f'no RIFF/WAVE header)')
    riff, _, wave = struct.unpack('<4sI4s', head)
    if riff != b'RIFF' or wave != b'WAVE':
        raise ValueError(f'{path}: not a RIFF/WAVE file '
                         f'(magic {riff!r}/{wave!r})')
    fmt = None
    while True:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f'{path}: no data chunk found')
        chunk_id, chunk_size = struct.unpack('<4sI', head)
        if chunk_id == b'fmt ':
            fmt_data = f.read(chunk_size)
            if len(fmt_data) < 16:
                raise ValueError(
                    f'{path}: truncated fmt chunk ({len(fmt_data)} of '
                    f'{chunk_size} bytes)')
            (audio_format, channels, sample_rate, _, _,
             bits_per_sample) = struct.unpack('<HHIIHH', fmt_data[:16])
            if audio_format == _FMT_EXTENSIBLE and chunk_size >= 40:
                # sub-format GUID's first 2 bytes carry the real format;
                # guard on bytes actually read, not the declared size (a
                # file truncated inside the fmt chunk must raise the
                # ValueError above's style, not a raw struct.error)
                if len(fmt_data) < 26:
                    raise ValueError(
                        f'{path}: truncated fmt chunk ({len(fmt_data)} '
                        f'of {chunk_size} bytes)')
                audio_format = struct.unpack('<H', fmt_data[24:26])[0]
            fmt = (audio_format, channels, sample_rate, bits_per_sample)
        elif chunk_id == b'data':
            if fmt is None:
                raise ValueError(f'{path}: data chunk before fmt chunk')
            audio_format, channels, sample_rate, bits = fmt
            bytes_per_frame = channels * bits // 8
            return WavInfo(
                channels=channels,
                sample_rate=sample_rate,
                bits_per_sample=bits,
                audio_format=audio_format,
                num_frames=chunk_size // max(bytes_per_frame, 1),
                data_offset=f.tell(),
                data_bytes=chunk_size,
            )
        else:
            f.seek(chunk_size + (chunk_size & 1), 1)


def wav_info(path) -> WavInfo:
    with open(path, 'rb') as f:
        return _parse_header(f, path)


def read_wav(path, start=0, stop=None, *, always_2d=False):
    """Read frames [start, stop) -> (array (frames,) or (frames, channels),
    sample_rate).  Values are raw (ints for PCM, floats for IEEE)."""
    with open(path, 'rb') as f:
        info = _parse_header(f, path)
        if stop is None or stop > info.num_frames:
            stop = info.num_frames
        start = min(max(start, 0), info.num_frames)
        count = max(stop - start, 0)
        f.seek(info.data_offset + start * info.bytes_per_frame)
        raw = f.read(count * info.bytes_per_frame)
    data = np.frombuffer(raw, dtype=info.dtype)
    data = data.reshape(-1, info.channels)
    if info.channels == 1 and not always_2d:
        data = data[:, 0]
    return data, info.sample_rate


def write_wav(path, data, sample_rate, *, start=None):
    """Write ``data`` ((frames,) or (frames, channels)) to ``path``.

    ``start`` (sample offset) performs an in-place r+ write into an
    existing file.  Writing past the current end extends the file (the gap
    is zero-filled) and patches the RIFF/data chunk sizes — matching the
    reference's soundfile r+ semantics (audiowrite.py doctests write at
    start offsets beyond the current length).
    """
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    frames, channels = data.shape
    if data.dtype == np.int16:
        audio_format, bits = _FMT_PCM, 16
    elif data.dtype == np.int32:
        audio_format, bits = _FMT_PCM, 32
    elif data.dtype == np.float32:
        audio_format, bits = _FMT_FLOAT, 32
    elif data.dtype == np.float64:
        audio_format, bits = _FMT_FLOAT, 64
    else:
        raise ValueError(f'unsupported dtype {data.dtype}')

    if start is not None and not Path(path).exists():
        # first write of an incremental file at a nonzero offset: create
        # the header + zero gap, then fall through to the r+ path (the
        # reference's soundfile 'w' mode seeks to start the same way,
        # audiowrite.py:164-206)
        write_wav(path, np.zeros((0, channels), data.dtype), sample_rate)

    if start is not None:
        info = wav_info(path)
        assert info.dtype == data.dtype, (info.dtype, data.dtype)
        assert info.channels == channels, (info.channels, channels)
        with open(path, 'r+b') as f:
            end_frame = start + frames
            if end_frame > info.num_frames:
                # zero-fill any gap, then patch the chunk sizes
                gap = start - info.num_frames
                if gap > 0:
                    f.seek(info.data_offset + info.data_bytes)
                    f.write(b'\x00' * (gap * info.bytes_per_frame))
                new_data_bytes = end_frame * info.bytes_per_frame
                f.seek(4)
                f.write(struct.pack('<I',
                                    info.data_offset + new_data_bytes - 8))
                f.seek(info.data_offset - 4)
                f.write(struct.pack('<I', new_data_bytes))
            f.seek(info.data_offset + start * info.bytes_per_frame)
            f.write(np.ascontiguousarray(data).tobytes())
        return

    data_bytes = frames * channels * bits // 8
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    header = struct.pack(
        '<4sI4s4sIHHIIHH4sI',
        b'RIFF', 36 + data_bytes, b'WAVE',
        b'fmt ', 16, audio_format, channels, sample_rate,
        byte_rate, block_align, bits,
        b'data', data_bytes,
    )
    path = Path(path)
    with open(path, 'wb') as f:
        f.write(header)
        f.write(np.ascontiguousarray(data).tobytes())
