"""STFT / iSTFT — port of ``pb_chime5_tpu/ops/stft.py``.

Same analysis/synthesis semantics (periodic Blackman analysis window,
biorthogonal synthesis window, ``fading`` pad/crop of ``size - shift``
samples, ``pad=True`` frame-count ceiling).  The windows and the
frame-count arithmetic are NumPy / Python copies of the JAX package's
(its ``ops`` package imports JAX); the transforms are ``torch.fft.rfft``
/ ``irfft`` (cuFFT on the card), the JAX non-TPU path
(``dft_backend='fft'``).
"""

import functools

import numpy as np
import torch
import torch.nn.functional as nnf

__all__ = [
    'blackman_window',
    'biorthogonal_synthesis_window',
    'samples_to_stft_frames',
    'stft_frame_count',
    'valid_frame_mask',
    'stft',
    'istft',
]


def blackman_window(size: int, dtype=np.float64) -> np.ndarray:
    """Periodic Blackman window (``scipy.signal.blackman(size + 1)[:-1]``)."""
    n = np.arange(size)
    w = (
        0.42
        - 0.5 * np.cos(2.0 * np.pi * n / size)
        + 0.08 * np.cos(4.0 * np.pi * n / size)
    )
    return np.asarray(w, dtype=dtype)


def biorthogonal_synthesis_window(window, shift: int) -> np.ndarray:
    """``w_s[n] = w[n] / sum_k w[(n mod shift) + k * shift] ** 2`` — makes
    overlap-add an exact inverse of the analysis transform."""
    window = np.asarray(window)
    size = window.shape[0]
    denom = np.zeros(shift, window.dtype)
    for start in range(size):
        denom[start % shift] += window[start] ** 2
    denom = np.maximum(denom, np.finfo(window.dtype).tiny)
    full = np.tile(denom, -(-size // shift))[:size]
    return window / full


def samples_to_stft_frames(samples: int, size: int, shift: int, *,
                           fading: bool = False, pad: bool = True) -> int:
    """Number of STFT frames a span of ``samples`` samples produces
    (nara_wpe ``_samples_to_stft_frames`` semantics)."""
    if fading:
        samples = samples + 2 * (size - shift)
    if pad:
        return -(-(samples - size + shift) // shift)
    return (samples - size + shift) // shift


def stft_frame_count(num_samples: int, size: int, shift: int, *,
                     fading: bool = True) -> int:
    """Frames :func:`stft` emits for a ``num_samples`` signal."""
    return max(1, samples_to_stft_frames(
        num_samples, size, shift, fading=fading, pad=True))


def valid_frame_mask(num_valid_samples: int, num_frames: int, size: int,
                     shift: int, *, fading: bool = True, device='cpu'):
    """Boolean ``(num_frames,)`` mask of the STFT frames produced by the
    first ``num_valid_samples`` samples of a zero-padded signal (the
    ``pad=True`` frame count, clamped to >= 1)."""
    pad_extra = 2 * (size - shift) if fading else 0
    t_valid = max(
        (int(num_valid_samples) + pad_extra - size + 2 * shift - 1)
        // shift, 1)
    return torch.arange(num_frames, device=device) < t_valid


@functools.lru_cache(maxsize=16)
def _window_tensor(window_fn, size, shift, synthesis, dtype, device):
    """The analysis window (or, with ``synthesis``, its biorthogonal
    synthesis window) as a tensor on ``device``, made once: a copy from
    NumPy memory on every call would make each call wait for the card."""
    window = np.asarray(window_fn(size))
    if synthesis:
        window = biorthogonal_synthesis_window(window, shift)
    return torch.as_tensor(window, dtype=dtype, device=device)


def stft(x, size: int = 1024, shift: int = 256, *, fading: bool = True,
         pad: bool = True, window_fn=blackman_window):
    """``(..., N)`` real tensor -> ``(..., T, size // 2 + 1)`` complex."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    if fading:
        x = nnf.pad(x, (size - shift, size - shift))
    n = x.shape[-1]
    if pad:
        num_frames = max(1, -(-(n - size + shift) // shift))
    else:
        num_frames = (n - size + shift) // shift
        if num_frames < 1:
            raise ValueError(f'signal too short: {n} < {size} (pad=False)')
    full = (num_frames - 1) * shift + size
    if full > n:
        x = nnf.pad(x, (0, full - n))
    frames = x[..., :full].unfold(-1, size, shift)     # (..., T, size)
    if window_fn is not None:
        frames = frames * _window_tensor(window_fn, size, shift, False,
                                         frames.dtype, frames.device)
    return torch.fft.rfft(frames, n=size, dim=-1)


def _overlap_add(frames, size: int, shift: int):
    """``(..., T, size)`` -> ``(..., (T - 1) * shift + size)``."""
    lead = frames.shape[:-2]
    T = frames.shape[-2]
    out_len = (T - 1) * shift + size
    cols = frames.reshape(-1, T, size).transpose(1, 2)  # (B, size, T)
    out = nnf.fold(cols, output_size=(1, out_len), kernel_size=(1, size),
                   stride=(1, shift))
    return out.reshape(*lead, out_len)


def istft(X, size: int = 1024, shift: int = 256, *, fading: bool = True,
          window_fn=blackman_window, num_samples: int = None):
    """Inverse STFT by biorthogonal-window overlap-add.

    ``(..., T, size // 2 + 1)`` -> ``(..., samples)``; ``num_samples``
    crops or zero-pads the result to that length.
    """
    frames = torch.fft.irfft(X, n=size, dim=-1)
    frames = frames * _window_tensor(window_fn, size, shift, True,
                                     frames.dtype, frames.device)
    x = _overlap_add(frames, size, shift)
    if fading:
        x = x[..., size - shift: x.shape[-1] - (size - shift)]
    if num_samples is not None:
        if num_samples <= x.shape[-1]:
            x = x[..., :num_samples]
        else:
            x = nnf.pad(x, (0, num_samples - x.shape[-1]))
    return x
