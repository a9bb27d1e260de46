"""The least work of the chain's WPE and EM stages, from an utterance's
shapes and activity, and the least time it takes on one H100.

The counts are what the algorithm needs, whatever kernel or library call
carries it, so a later change of kernel moves the time and not the count.
A complex multiply-add is 8 real operations.  Per frequency, with d =
taps * D and T the utterance's frames (padding never counts):

WPE, each iteration:
  * statistics (K2's count): the lower triangle of R = sum_t w_t y~ y~^H
    and P = sum_t w_t y~ y^H: 8 T (d (d + 1) / 2 + d D);
  * solve: a complex Cholesky of R, 8 d^3 / 6, and the forward and back
    substitutions for D right-hand sides, 8 d^2 D;
  * filter: X = Y - G^H Y~, 8 T d D;
  * the power and the weights are elementwise and left out.
EM, each pass (K1's count): per frame the lower triangle of z z^H
  (3 D^2) and the quadratic form of every class (2 D^2 each: the log-pdf
  is shifted by its largest class before the activity gate), and the
  update of S_k's lower triangle (2 D^2) for each (frame, class) pair the
  pass gates in; then the finalize, K Hermitian inverses of 8 D^3 / 2
  (Cholesky, triangular inverse, product).  The first pass, from the
  activity, gates in every class; the masked passes the active pairs; the
  final E-step forms and quadratic forms only.
Bytes: the stage's input read once and its output written once
(complex64 observations, float32 masks).

Peaks (NVIDIA's H100 SXM data sheet, at its 700 W limit): 67 TFLOP/s
float32 outside the tensor cores (the program pins TF32 off) and HBM
3.35 TB/s.  A stage's share of its roofline is its least time over its
measured time, and cannot pass 100 %.
"""

__all__ = ['FP32_FLOP_PER_S', 'HBM_BYTES_PER_S', 'k1_flops', 'k2_flops',
           'wpe_work', 'em_work', 'least_seconds']

FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
COMPLEX64 = 8
FLOAT32 = 4


def k2_flops(F, T, D, taps):
    """One iteration's statistics: R's lower triangle and P."""
    d = taps * D
    return 8 * F * T * (d * (d + 1) // 2 + d * D)


def k1_flops(F, T, D, K, pairs):
    """One E+M pass over T frames, ``pairs`` (frame, class) pairs gated in
    (a sum over the F frequencies of one utterance)."""
    return F * (T * (3 + 2 * K) * D * D + pairs * 2 * D * D)


def wpe_work(F, D, T, taps, iterations):
    """(operations, bytes) of the WPE stage."""
    d = taps * D
    per_iteration = (k2_flops(F, T, D, taps)
                     + F * (8 * d ** 3 // 6 + 8 * d * d * D)
                     + 8 * F * T * d * D)
    return iterations * per_iteration, 2 * F * D * T * COMPLEX64


def em_work(F, D, T, K, active_pairs, iterations, iterations_post):
    """(operations, bytes) of the EM stage: ``active_pairs`` is the number
    of (frame, class) pairs the activity gates in."""
    finalize = F * K * 8 * D ** 3 // 2
    passes = [K * T] + [active_pairs] * (iterations - 1) \
        + [K * T] * max(iterations_post - 1, 0)
    flops = sum(k1_flops(F, T, D, K, p) + finalize for p in passes)
    flops += F * T * (3 + 2 * K) * D * D                # final E-step
    return flops, F * D * T * COMPLEX64 + F * K * T * FLOAT32


def least_seconds(flops, nbytes):
    return max(flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S)
