"""PCM16 WAV reading for the reference, on the standard library alone."""

import wave

import numpy as np

__all__ = ['num_frames', 'read_pcm16']


def num_frames(path):
    with wave.open(str(path), 'rb') as f:
        return f.getnframes()


def read_pcm16(path, start=0, stop=None):
    """Samples ``[start, stop)`` of a mono PCM16 file as int16, fewer where
    the file ends first."""
    with wave.open(str(path), 'rb') as f:
        if f.getsampwidth() != 2 or f.getnchannels() != 1:
            raise ValueError(f'{path}: not mono PCM16')
        n = f.getnframes()
        stop = n if stop is None else min(stop, n)
        if start >= stop:
            return np.zeros(0, np.int16)
        f.setpos(start)
        return np.frombuffer(f.readframes(stop - start), '<i2')
