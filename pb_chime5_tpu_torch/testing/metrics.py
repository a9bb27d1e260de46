"""Textbook intelligibility metric for quality gates — the port's copy of
``pb_chime5_tpu/testing/metrics.py`` (NumPy only; the same inputs give the
same scores).

SIR-style energy ratios (tests/test_realistic_scene.py) measure
suppression but cannot see musical-noise artifacts from aggressive
masks — the reference keeps a mask postfilter exactly to trade those
(reference core.py:268-273).  :func:`stoi` implements the standard
short-time objective intelligibility measure (Taal, Hendriks, Heusdens,
Jensen, "An Algorithm for Intelligibility Prediction of Time-Frequency
Weighted Noisy Speech", IEEE TASLP 2011) from the paper's equations —
NumPy only, no external packages:

1. resample clean + degraded to 10 kHz (periodic-sinc / FFT resampling;
   the signals here are synthetic scenes, there is no out-of-band
   content to alias),
2. remove frames more than 40 dB below the loudest CLEAN frame
   (256/128 Hann framing, both signals keep the same frame set),
3. STFT 256/128/512-FFT Hann, 15 one-third-octave bands with center
   frequencies 150 * 2^(k/3) Hz,
4. per 30-frame segment and band: scale the degraded envelope to the
   clean energy, clip at -15 dB SDR, correlate with the clean envelope,
5. average the correlations over bands and segments.

Scores land in ~[0, 1] (identical signals -> 1.0; uncorrelated noise
-> ~0).  This follows the published algorithm but is an independent
implementation; tests pin its analytic invariants (identity = 1,
monotone in SNR, silence/short-input handling), not third-party outputs.
"""

import numpy as np

__all__ = ['stoi']

_FS = 10000            # the metric's internal rate
_FRAME = 256
_HOP = 128
_NFFT = 512
_NBANDS = 15
_MINFREQ = 150.0
_SEG = 30              # frames per short-time segment (384 ms)
_BETA_DB = -15.0       # lower SDR clipping bound
_DYN_DB = 40.0         # silent-frame removal dynamic range


def _resample_fft(x, fs_in, fs_out):
    """Periodic-sinc resampling via spectrum truncation/zero-pad."""
    if fs_in == fs_out:
        return np.asarray(x, float)
    n_in = len(x)
    n_out = int(round(n_in * fs_out / fs_in))
    X = np.fft.rfft(np.asarray(x, float))
    k_out = n_out // 2 + 1
    if k_out <= len(X):
        Y = X[:k_out].copy()
    else:
        Y = np.zeros(k_out, complex)
        Y[:len(X)] = X
    return np.fft.irfft(Y, n_out) * (n_out / n_in)


def _frames(x, window):
    n = (len(x) - _FRAME) // _HOP + 1
    if n <= 0:
        return np.empty((0, _FRAME))
    idx = np.arange(_FRAME)[None, :] + _HOP * np.arange(n)[:, None]
    return x[idx] * window


def _third_octave_matrix(fs):
    """(15, F) 0/1 matrix collecting FFT bins into one-third-octave
    bands (paper section II-A)."""
    f = np.fft.rfftfreq(_NFFT, 1.0 / fs)
    cf = _MINFREQ * 2.0 ** (np.arange(_NBANDS) / 3.0)
    lo = cf / 2.0 ** (1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    H = np.zeros((_NBANDS, len(f)))
    for j in range(_NBANDS):
        # each bin joins the band whose edges enclose it (nearest-edge
        # assignment like the published implementation)
        sel = (f >= lo[j]) & (f < hi[j])
        H[j, sel] = 1.0
    return H


def stoi(clean, degraded, fs=16000):
    """Short-time objective intelligibility of ``degraded`` against
    ``clean`` (1-D arrays at rate ``fs``); higher is better, identical
    inputs give 1.0.  Returns ``nan`` when the clean signal has fewer
    than one 384 ms segment of active speech."""
    clean = np.asarray(clean, float).ravel()
    degraded = np.asarray(degraded, float).ravel()
    n = min(len(clean), len(degraded))
    clean, degraded = clean[:n], degraded[:n]

    x = _resample_fft(clean, fs, _FS)
    y = _resample_fft(degraded, fs, _FS)

    window = np.hanning(_FRAME + 2)[1:-1]
    xf = _frames(x, window)
    yf = _frames(y, window)
    if len(xf) == 0 or not np.any(xf):
        return float('nan')           # no clean speech to measure against

    # silent-frame removal, thresholded on the CLEAN frame energies
    e = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + 1e-300)
    keep = e > (e.max() - _DYN_DB)
    xf, yf = xf[keep], yf[keep]
    if len(xf) < _SEG:
        return float('nan')

    X = np.abs(np.fft.rfft(xf, _NFFT, axis=1))
    Y = np.abs(np.fft.rfft(yf, _NFFT, axis=1))
    H = _third_octave_matrix(_FS)
    # (bands, frames) one-third-octave envelopes
    Xb = np.sqrt(H @ (X.T ** 2))
    Yb = np.sqrt(H @ (Y.T ** 2))

    c = 10.0 ** (-_BETA_DB / 20.0)    # -15 dB SDR bound -> 5.62
    scores = []
    for m in range(_SEG, Xb.shape[1] + 1):
        Xs = Xb[:, m - _SEG:m]
        Ys = Yb[:, m - _SEG:m]
        alpha = (np.linalg.norm(Xs, axis=1, keepdims=True)
                 / (np.linalg.norm(Ys, axis=1, keepdims=True) + 1e-300))
        Yp = np.minimum(alpha * Ys, Xs * (1.0 + c))
        Xc = Xs - Xs.mean(axis=1, keepdims=True)
        Yc = Yp - Yp.mean(axis=1, keepdims=True)
        num = np.sum(Xc * Yc, axis=1)
        den = (np.linalg.norm(Xc, axis=1) * np.linalg.norm(Yc, axis=1)
               + 1e-300)
        scores.append(np.mean(num / den))
    return float(np.mean(scores))
