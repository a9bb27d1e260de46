"""Analytic FLOP counts of one ``gss_enhance`` for achieved FLOP/s and MFU
on the card — the port's counterpart of ``pb_chime5_tpu/utils/flops.py``,
in the port's formulation.

The counts are the work the algorithm needs, whatever kernel does it, so
that a kernel which does less arithmetic moves the time and not the
denominator:

* a complex matmul (M, C) x (C, N) counts 8*M*N*C real FLOPs (4 real
  products and their sums per element pair);
* WPE statistics as full complex Grams, per iteration and frequency:
  R = 8*d^2*T (the (d, T) x (T, d) product, d = taps*D, both triangles,
  no lane padding) and P = 8*d*D*T; the filter apply G^H Y~ = 8*D*d*T;
  the solve at its leading terms (complex Cholesky 8*d^3/3 and two
  triangular substitutions with D right-hand sides, 2*8*d^2*D);
* the STFT and iSTFT as real FFTs, 2.5*S*log2(S) a frame and channel;
* the EM (E-step forms, M-step scatters, the K inverses of the finalize,
  the initial M-step) and the beamformer (two PSDs, the MVDR-Souden
  inverse and product, the apply) exactly as the JAX model counts them;
* elementwise work (masks, floors, normalizations, windows) is left out.

Peak: the H100 SXM's 67 TFLOP/s float32 on the CUDA cores (NVIDIA's data
sheet, at its 700 W limit): the port pins TF32 off (``_device.py``), so
no product runs on the tensor cores.  MFU = (FLOPs / wall) / peak; state
it beside the card's name and power limit.
"""

import math

from pb_chime5_tpu_torch.ops.stft import stft_frame_count

__all__ = ['gss_stage_flops', 'gss_total_flops', 'mfu',
           'H100_FP32_PEAK_TFLOPS']

H100_FP32_PEAK_TFLOPS = 67.0


def _fft(S):
    """Real FLOPs of one real FFT of length S."""
    return 2.5 * S * math.log2(S)


def gss_stage_flops(*, num_samples, D, K, stft_size=1024, stft_shift=256,
                    stft_fading=True, wpe_taps=10, wpe_iterations=3,
                    bss_iterations=20, bss_iterations_post=1):
    """{stage: FLOPs} of one ``gss_enhance`` of ``num_samples`` samples of
    D channels and K classes (``wpe_iterations=0`` without WPE); F =
    stft_size // 2 + 1 bins, T frames as :func:`stft` emits them."""
    F = stft_size // 2 + 1
    T = stft_frame_count(num_samples, stft_size, stft_shift,
                         fading=stft_fading)
    S = stft_size
    d = wpe_taps * D
    flops = {'stft': D * T * _fft(S)}

    flops['wpe_stats'] = (8 * d * d * T + 8 * d * D * T) * F * wpe_iterations
    flops['wpe_solve'] = ((8 * d ** 3 // 3 + 2 * 8 * d * d * D) * F
                          * wpe_iterations)
    flops['wpe_tail'] = 8 * D * d * T * F * wpe_iterations

    em_iters = bss_iterations + bss_iterations_post
    e_step = K * (8 * D * D * T + 8 * D * T) * F
    m_step = K * (8 * D * D * T) * F
    inv = K * (8 * D ** 3) * F
    # + m_step: the initial M-step from the activity
    flops['em'] = (e_step + m_step + inv) * em_iters + m_step

    psd = 2 * (8 * D * D * T) * F
    mvdr = (8 * D ** 3 + 8 * D ** 3 + 8 * D * D) * F
    flops['beamform'] = psd + mvdr + 8 * D * T * F

    flops['istft'] = T * _fft(S)
    return flops


def gss_total_flops(**kwargs):
    """Sum of :func:`gss_stage_flops`."""
    return sum(gss_stage_flops(**kwargs).values())


def mfu(flops, seconds, peak_tflops=H100_FP32_PEAK_TFLOPS):
    """(achieved TFLOP/s, its share of ``peak_tflops``)."""
    achieved = flops / seconds / 1e12
    return achieved, achieved / peak_tflops
