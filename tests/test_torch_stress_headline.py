"""Headline-scale parity and separation quality of the port — the twin of
``tests/test_stress_headline.py``.

The production shape: D = 24 channels (6 arrays x 4 mics), K = 5 classes
(4 speakers + noise), F = 513, T = 4191 (> 4096), STFT 1024 / 256, WPE
taps 10, delay 2, 3 iterations, cacGMM 20 + 1 iterations, MVDR-Souden +
BAN: the port's float32 chain (the default ``GssConfig``: the 1e-4 WPE
load, K1, ``em_finalize``, K5) against the float64 NumPy oracle of
``tests/reference_numpy.py``, with the JAX test's three attributed
measurements and its pins (WPE < 0.15, EM + beamformer on identical input
at 2 + 0 < 0.03, the full chain < 0.6 and its SIR gain within 1 dB of
the oracle's or better).

It runs on the card where there is one (the CPU otherwise, for hours):
``python -m pytest --noconftest -m stress tests/test_torch_stress_headline.py
-s`` (``tests/conftest.py`` imports JAX; the oracle's frequencies run in
one process per CPU core).  Marked ``stress`` and ``slow``: outside tier 1.
"""

import concurrent.futures
import functools
import multiprocessing
import os

import numpy as np
import pytest
import torch

from tests import reference_numpy as ref

pytestmark = [pytest.mark.stress, pytest.mark.slow]

# the scene and the SIR of tests/test_stress_headline.py, copied: that
# file imports JAX, which the card's machine does not have

FS = 16000


def make_production_scene(rng, seconds=67.0, D=24, num_speakers=4):
    """Speech-like stochastic sources, staggered activity, random FIR
    mixing to D channels, always-on noise class.  T = 4191 frames at the
    default 1024/256 STFT for seconds=67."""
    N = int(seconds * FS)
    spans = [(0.00, 0.35), (0.25, 0.60), (0.50, 0.80), (0.70, 1.00)]
    assert num_speakers == len(spans)
    K = num_speakers + 1
    activity = np.zeros((K, N), bool)
    activity[-1] = True                      # noise class always on
    obs = 0.02 * rng.standard_normal((D, N))
    for k, (lo, hi) in enumerate(spans):
        env = rng.uniform(0.3, 1.0, N // 800 + 1).repeat(800)[:N]
        s = rng.standard_normal(N) * env
        tilt = rng.standard_normal(3) * [1.0, 0.8, 0.4]
        s = np.convolve(s, tilt, mode='same')
        a, b = int(lo * N), int(hi * N)
        s[:a] = 0.0
        s[b:] = 0.0
        activity[k, a:b] = True
        h = rng.standard_normal((D, 7))
        for d in range(D):
            obs[d] += np.convolve(s, h[d], mode='same')
    return obs.astype(np.float64), activity, spans


def _sir(x, activity, spans, N, target=0, interferer=1):
    """Energy ratio: target-exclusive region vs interferer-exclusive
    region (the target's strongest overlapper)."""
    t_hi = int(spans[interferer][0] * N)          # only target active
    i_lo = int(spans[target][1] * N)              # target silent
    i_hi = int(spans[2][0] * N)                   # spk2 not yet active
    x = np.asarray(x)
    e_t = float((x[..., :t_hi] ** 2).mean())
    e_i = float((x[..., i_lo:i_hi] ** 2).mean())
    return 10.0 * np.log10(e_t / max(e_i, 1e-300))


def _per_frequency(fn, Y, **kw):
    """``fn`` (an oracle of ``reference_numpy`` that treats each frequency
    alone, frequency first) over blocks of frequencies in parallel
    processes, concatenated: the oracle's own values."""
    blocks = np.array_split(Y, os.cpu_count() or 1)
    with concurrent.futures.ProcessPoolExecutor(
            len(blocks), mp_context=multiprocessing.get_context('spawn')) \
            as pool:
        return np.concatenate(list(pool.map(functools.partial(fn, **kw),
                                            blocks)))


def _oracle_chain(Y, act_f, N, size, shift, iterations, iterations_post):
    """Oracle EM + MVDR + BAN + iSTFT on a dereverberated Y (F, D, T)."""
    masks = _per_frequency(ref.cacgmm_posteriors_np, Y.transpose(0, 2, 1),
                           activity=act_f, iterations=iterations,
                           iterations_post=iterations_post)     # (F, K, T)
    target = masks[:, 0, :]
    distortion = masks.sum(axis=1) - target
    cov_x = ref.psd_np(Y, target)
    cov_n = ref.psd_np(Y, distortion)
    w, _ = ref.mvdr_souden_np(cov_x, cov_n)
    w = ref.ban_np(w, cov_n)
    X_hat = np.einsum('fd,fdt->ft', w.conj(), Y)
    return ref.istft_np(X_hat.T[None], size, shift, fading=True)[0][:N]


def test_headline_shape_port_vs_oracle():
    from pb_chime5_tpu_torch.models.gss import (
        GssConfig, _bf_stage, _em_stage, _stft_and_mask, _wpe_stage)
    from pb_chime5_tpu_torch.ops.stft import istft
    from pb_chime5_tpu_torch.utils import activity_time_to_frequency

    device = 'cuda' if torch.cuda.is_available() else 'cpu'
    size, shift = 1024, 256
    obs, activity, spans = make_production_scene(np.random.default_rng(0))
    D, N = obs.shape
    act_f = activity_time_to_frequency(activity, size, shift,
                                       stft_fading=True, stft_pad=True)
    assert act_f.shape[1] > 4096 and D == 24 and act_f.shape[0] == 5

    def rel_rms(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    # the float64 oracle's front (the reference equations)
    Y_raw = np.ascontiguousarray(
        ref.stft_np(obs, size, shift, fading=True).transpose(2, 0, 1))
    Y_o = _per_frequency(ref.wpe_np, Y_raw, taps=10, delay=2, iterations=3)

    def port_front():
        O, fm, _ = _stft_and_mask(
            torch.from_numpy(obs.astype(np.float32)).to(device), None,
            GssConfig())
        return _wpe_stage(O, GssConfig(), fm).cpu().numpy()

    def port_back(Y_in, iterations, iterations_post):
        config = GssConfig(bss_iterations=iterations,
                           bss_iterations_post=iterations_post)
        Y = torch.from_numpy(Y_in.astype(np.complex64)).to(device)
        act = torch.from_numpy(act_f.astype(np.int8)).to(device)
        masks = _em_stage(Y, act, config, None)
        X_hat, _ = _bf_stage(Y, masks, 0, config, 0, 0, None)
        got = istft(X_hat.T, size, shift, fading=True,
                    num_samples=N).cpu().numpy()
        assert np.isfinite(got).all()
        return got

    # 1. WPE deviation (the deliberate 1e-4 load of the float32 WPE)
    Y_p = port_front()
    assert np.isfinite(Y_p).all()
    rms_wpe = rel_rms(Y_p, Y_o)
    # 2. EM + beamformer, short trajectory, on identical input
    rms_emshort = rel_rms(port_back(Y_o, 2, 0),
                          _oracle_chain(Y_o, act_f, N, size, shift, 2, 0))
    # 3. the full chain, quality parity
    want_full = _oracle_chain(Y_o, act_f, N, size, shift, 20, 1)
    got_full = port_back(Y_p, 20, 1)
    rms_full = rel_rms(got_full, want_full)
    sir_in = _sir(obs[0], activity, spans, N)
    sir_oracle = _sir(want_full, activity, spans, N)
    sir_port = _sir(got_full, activity, spans, N)
    name = (torch.cuda.get_device_name(0) if device == 'cuda'
            else 'the CPU')
    print(f'\nheadline-shape parity on {name}: rel_rms wpe={rms_wpe:.4f} '
          f'em_short={rms_emshort:.4f} full(20+1)={rms_full:.4f}  SIR '
          f'in={sir_in:.1f} dB  oracle={sir_oracle:.1f} dB  '
          f'port={sir_port:.1f} dB')

    assert rms_wpe < 0.15, rms_wpe
    assert rms_emshort < 0.03, rms_emshort
    assert rms_full < 0.6, rms_full
    assert sir_oracle - sir_in > 15.0, (sir_in, sir_oracle)
    assert sir_port - sir_in > 15.0, (sir_in, sir_port)
    assert sir_port >= sir_oracle - 1.0, (sir_port, sir_oracle)
