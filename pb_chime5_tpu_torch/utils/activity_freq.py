"""Sample-level activity <-> STFT-frame-level activity (host NumPy) — the
port of ``pb_chime5_tpu/utils/activity_freq.py`` (reference
pb_chime5/database/chime5/database.py:328-472): a frame is active iff any
sample under its analysis window is; the inverse marks every sample under
an active frame.
"""

import numpy as np

__all__ = ['segment_axis', 'activity_time_to_frequency',
           'activity_frequency_to_time']


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


def activity_frequency_to_time(frequency_activity, stft_window_length: int,
                               stft_shift: int, stft_fading: bool = False,
                               time_length: int = None):
    """(..., T) frame activity -> (..., N) sample activity: every sample
    under an active frame.  ``time_length`` cuts or zero-pads the end to
    that length (by less than the window's overlap)."""
    if stft_fading:
        raise NotImplementedError(stft_fading)
    frequency_activity = np.asarray(frequency_activity)
    T = frequency_activity.shape[-1]
    n = T * stft_shift + stft_window_length - stft_shift
    time_activity = np.zeros((*frequency_activity.shape[:-1], n), bool)
    view = np.lib.stride_tricks.as_strided(
        time_activity,
        shape=(*time_activity.shape[:-1], T, stft_window_length),
        strides=time_activity.strides[:-1] + (
            stft_shift * time_activity.strides[-1],
            time_activity.strides[-1]),
        writeable=True)
    view[frequency_activity.astype(bool)] = True
    if time_length is not None and time_length != n:
        delta = abs(n - time_length)
        assert delta < stft_window_length - stft_shift, \
            (delta, stft_window_length, stft_shift)
        if time_length < n:
            time_activity = time_activity[..., :time_length]
        else:
            time_activity = np.pad(
                time_activity,
                [(0, 0)] * (time_activity.ndim - 1) + [(0, delta)])
    return time_activity
