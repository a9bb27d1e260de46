"""The WPE statistics kernel (K2), the Gauss-Jordan kernel's two entries
(K3, K4) and the blocked Cholesky solve (K5) vs their plain PyTorch
versions, on the card.

Marked ``cuda`` and skipped without a CUDA device (the kernels have no
CPU or interpret mode); run on a machine with an H100 with
``python -m pytest --noconftest tests/test_torch_kernels_cuda.py``
(``tests/conftest.py`` imports JAX).  ``chip_smoke.py`` makes the same
comparisons at the headline shapes with the inputs and error measures
defined here; the CPU tests use the same inputs against the JAX package.

Tolerances and their reasons:

* K2: relative Frobenius error of R and of P per frequency <= 1e-5.  Both
  versions sum ~T float32 products per entry, in other orders (the
  kernel in t order per entry, cuBLAS in blocked order), and the kernel
  mirrors R's lower triangle where the plain version computes the upper
  one.
* K3 / K4 on well-conditioned HPD input (``random_hpd``): inverse
  relative Frobenius error per matrix <= 1e-5, logdet absolute <= 1e-4
  (float32 elimination with condition numbers ~1e2, FMA contraction in
  the kernel only).
* K3 on the EM's own kind of input (``em_like_batch``: rank-deficient
  covariances that only the 1e-6 jitter makes invertible, condition
  ~1e6): logdet within 1e-3 absolute and inverse within 1e-5 relative
  Frobenius of the plain version, all outputs finite.  The kernel runs
  the plain version's operations in its order (they agreed bit for bit
  on an H100), so the conditioning, which amplifies any difference in
  rounding, does not widen these.  Its largest residual ||B X - I||_F is
  also held to <= 2x the plain version's + 1e-6 against float64.
* The relative floor mode (``gauss_jordan_inverse_and_logdet``, the plain
  version ``ops/linalg.py``'s) under the K3 / K4 gates, on HPD and on
  EM-like input.
* ``em_finalize`` (the whole EM finalize in one launch) against its plain
  version on the EM's accumulated state (``em_state``: rank-deficient
  scatter, an empty class, a tiny den, a silent frequency), in both
  floor modes: precision within 1e-5 relative Frobenius, logdet within
  1e-3, log_weight within 1e-6 absolute, and a residual against float64
  no worse than the plain version's (2x + 1e-6); the kernel sums the
  trace and the classes' den in one fixed order where PyTorch picks its
  own, so the jitter may move by an ulp.  The empty class (den = 0,
  S = 0: B = I + jitter) involves no such sum and is pinned bit for bit.
* K5 on well-conditioned SPD / HPD input: relative Frobenius error per
  frequency <= 1e-5 against the plain version (the same panels and
  floor; the 32-wide products summed in other orders) and <= 1e-4
  against a float64 solve of the same loaded system; the zero-pivot
  floor pin is exact (1 / FLT_MIN).  The complex instantiation
  (``hermitian_solve_chol``, the WPE solve) under the same gates against
  its plain version and against a float64 ``hermitian_solve`` with the
  same ``refine``, and bit-equal to its plain version (which performs
  the kernel's operations one for one); its relative floor pin within
  1e-5 of b / eps^3, the healthy rows exact.
"""

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch import _device
from pb_chime5_tpu_torch.ops import cacgmm, linalg
from pb_chime5_tpu_torch.ops.kernels import chol_solve, gj_inverse, wpe_stats
from pb_chime5_tpu_torch.ops.linalg import hermitize
from pb_chime5_tpu_torch.ops.wpe import build_y_tilde, get_power_inverse

pytestmark = pytest.mark.cuda

STATS_RTOL = 1e-5
INV_RTOL = 1e-5
LOGDET_ATOL = 1e-4
EM_LOGDET_ATOL = 1e-3
SOLVE_RTOL = 1e-5
SOLVE_F64_RTOL = 1e-4

LOG_WEIGHT_ATOL = 1e-6
DIAGONAL_FLOOR = 1e-6   # CacgmmConfig's default

GJ_ENTRIES = {
    'k3': (gj_inverse.hermitian_inverse_and_logdet_2d,
           gj_inverse.hermitian_inverse_and_logdet_2d_reference),
    'k4': (gj_inverse.hermitian_inverse_and_logdet,
           gj_inverse.hermitian_inverse_and_logdet_reference),
}
# every floor mode of the kernel's inverse-only entries
GJ_MODES = {
    **GJ_ENTRIES,
    'relative': (gj_inverse.gauss_jordan_inverse_and_logdet,
                 linalg.gauss_jordan_inverse_and_logdet),
}


def wpe_inputs(F, D, T, *, taps=10, delay=2, seed=0, device='cpu'):
    """(Y_tilde (F, taps*D, T), Y (F, D, T), inv_power (F, T), valid
    frames) as WPE's first iteration hands them to its statistics:
    seeded complex noise with a near-silent stretch (1e-4 of the level,
    inv_power up to ~1e8) and a zero-padded tail of T // 10 masked
    frames, stacked and weighted by the port's own WPE helpers."""
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((F, D, T)) + 1j * rng.standard_normal((F, D, T))
    Y[..., T // 3:T // 3 + T // 8] *= 1e-4
    valid = T - T // 10
    Y[..., valid:] = 0
    Y = torch.as_tensor(Y.astype(np.complex64), device=device)
    fm = torch.arange(T, device=device) < valid
    Y_tilde = (build_y_tilde(Y, taps, delay) * fm).contiguous()
    return (Y_tilde, Y, get_power_inverse(Y, frame_mask=fm).contiguous(),
            valid)


def stats_errors(R, P, R_ref, P_ref):
    """Largest per-frequency relative Frobenius error of R and of P, and
    the largest absolute error of either."""
    def rel(x, ref):
        diff = torch.linalg.matrix_norm(x - ref)
        norm = torch.linalg.matrix_norm(ref)
        return float(torch.where(diff == 0, torch.zeros_like(diff),
                                 diff / norm).max())
    max_abs = max(float((R - R_ref).abs().max()),
                  float((P - P_ref).abs().max()))
    return rel(R, R_ref), rel(P, P_ref), max_abs


def random_hpd(shape, D, *, seed=0, device='cpu'):
    """Well-conditioned Hermitian PD batch ``A A^H / D + I``."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((*shape, D, D)) \
        + 1j * rng.standard_normal((*shape, D, D))
    B = A @ A.conj().swapaxes(-1, -2) / D + np.eye(D)
    return torch.as_tensor(B.astype(np.complex64), device=device)


def em_like_batch(F, K, D, *, seed=0, device='cpu'):
    """Covariances as the EM's finalize hands them to its inverse:
    rank-deficient scatter (rank 1 .. D - 1 per class), trace-normalized,
    an empty class (B = I), then the 1e-6 trace-scaled jitter
    (``cacgmm.add_jitter``)."""
    rng = np.random.default_rng(seed)
    ranks = rng.integers(1, D, size=(F, K))
    Z = rng.standard_normal((F, K, D, D)) \
        + 1j * rng.standard_normal((F, K, D, D))
    Z = Z * (np.arange(D) < ranks[..., None])[..., None, :]
    S = Z @ Z.conj().swapaxes(-1, -2)
    if K > 1:
        S[:, 1] = 0
    cov = cacgmm._trace_normalize(hermitize(
        torch.as_tensor(S.astype(np.complex64))))
    return cacgmm.add_jitter(cov, 1e-6).to(device).contiguous()


def em_state(F, K, D, *, frames=None, seed=0, device='cpu'):
    """(S (F, K, D, D) complex64, den (F, K) float32) as the fused E+M
    kernel hands them to the finalize: ``S_k = sum_t g_kt z_t z_t^H`` over
    unit-norm z and ``den_k = sum_t g_kt``.  ``frames`` frames a class
    (default: D, of which a random 1 .. D - 1 carry weight, so only the
    jitter makes the covariance invertible).  Frequency 0 is silent (every
    class den = 0, S = 0), frequency 1's last class is empty, frequency
    2's first class has a tiny den (1e-30, its S scaled alike)."""
    rng = np.random.default_rng(seed)
    n = frames or D
    z = rng.standard_normal((F, K, n, D)) \
        + 1j * rng.standard_normal((F, K, n, D))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    g = rng.uniform(0.05, 1.0, (F, K, n))
    if frames is None:
        g = g * (np.arange(n) < rng.integers(1, max(D, 2), (F, K, 1)))
    S = np.einsum('fkt,fktd,fkte->fkde', g, z, z.conj())
    den = g.sum(-1)
    S[0], den[0] = 0, 0
    if F > 1:
        S[1, -1], den[1, -1] = 0, 0
    if F > 2:
        S[2, 0] *= 1e-30 / den[2, 0]
        den[2, 0] = 1e-30
    return (torch.as_tensor(S.astype(np.complex64), device=device),
            torch.as_tensor(den.astype(np.float32), device=device))


def finalize_errors(out, ref):
    """Largest per-matrix relative Frobenius error of the precision,
    largest absolute logdet and log_weight errors; out and ref are
    (log_weight, precision, logdet)."""
    rel, dld, _ = inverse_errors(out[1], out[2], ref[1], ref[2])
    return rel, dld, float((out[0] - ref[0]).abs().max())


def inverse_errors(inv, ld, inv_ref, ld_ref):
    """Largest per-matrix relative Frobenius error of the inverse, largest
    absolute logdet error, largest absolute error of either."""
    rel = torch.linalg.matrix_norm(inv - inv_ref) \
        / torch.linalg.matrix_norm(inv_ref)
    dld = (ld - ld_ref).abs()
    return (float(rel.max()), float(dld.max()),
            max(float((inv - inv_ref).abs().max()), float(dld.max())))


def against_float64(B, inv, ld):
    """Largest residual ||B X - I||_F and largest logdet error against
    float64, over the batch."""
    B64 = B.to(torch.complex128)
    eye = torch.eye(B.shape[-1], dtype=B64.dtype, device=B.device)
    res = torch.linalg.matrix_norm(B64 @ inv.to(B64.dtype) - eye)
    ld64 = torch.linalg.slogdet(B64)[1]
    return float(res.max()), float((ld.double() - ld64).abs().max())


def spd_system(F, S, E, *, seed=0, device='cpu'):
    """Real SPD (F, S, S) ``M M^T / S + I`` and (F, S, E) right-hand
    sides, float32."""
    rng = np.random.default_rng(seed)
    M = torch.as_tensor(rng.standard_normal((F, S, S)).astype(np.float32),
                        device=device)
    A2 = M @ M.transpose(-2, -1) / S + torch.eye(S, device=device)
    A2 = (A2 + A2.transpose(-2, -1)) / 2
    B2 = torch.as_tensor(rng.standard_normal((F, S, E)).astype(np.float32),
                         device=device)
    return A2.contiguous(), B2


def hpd_system(F, D, E, *, seed=0, device='cpu'):
    """Complex64 HPD (F, D, D): ``M M^H / D + I`` with its rows and
    columns scaled by factors in [e^-2, e^2] (the equilibration undoes
    them), and (F, D, E) right-hand sides."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return torch.as_tensor((rng.standard_normal(shape)
                                + 1j * rng.standard_normal(shape))
                               .astype(np.complex64), device=device)
    M = normal(F, D, D)
    A = M @ M.conj().transpose(-2, -1) / D \
        + torch.eye(D, dtype=M.dtype, device=device)
    s = torch.as_tensor(np.exp(rng.uniform(-2, 2, (F, D))).astype(np.complex64),
                        device=device)
    return hermitize(A * s[:, :, None] * s[:, None, :]).contiguous(), \
        normal(F, D, E)


def frobenius_errors(X, ref):
    """Largest per-batch-element relative Frobenius error of X."""
    return float((torch.linalg.matrix_norm(X - ref.to(X.dtype))
                  / torch.linalg.matrix_norm(ref.to(X.dtype))).max())


def solve_error_f64(X, A, B, relative_load):
    """Largest per-frequency relative Frobenius error of X against the
    float64 solve of the same equilibrated, loaded system."""
    X64 = linalg.hermitian_solve(A.to(torch.complex128),
                                 B.to(torch.complex128),
                                 relative_load=relative_load)
    return frobenius_errors(X.to(torch.complex128), X64)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _device.assert_precision()
    return torch.device('cuda')


# (F, D, T, taps): partial quads and blocks on every axis; dim one below,
# at and one above the 64-row block (63, 64, 65); D one above the 24
# columns of P beside the diagonal block (25) and past a further block of
# 64 (89, 50); one frame (T = 1); T one below and one above the 16-frame
# chunk and two of them; one tap; and the headline shape
@pytest.mark.parametrize('shape', [
    (3, 3, 700, 4), (2, 5, 97, 11), (2, 50, 40, 2), (1, 1, 1, 1),
    (513, 24, 2504, 10), (2, 21, 200, 3), (2, 8, 64, 8), (2, 13, 150, 5),
    (2, 25, 90, 2), (1, 89, 70, 1), (3, 24, 1, 10), (2, 24, 15, 10),
    (2, 24, 17, 10), (2, 24, 31, 10), (2, 24, 33, 10), (2, 24, 300, 1),
], ids=lambda s: 'F{}-D{}-T{}-taps{}'.format(*s))
def test_wpe_stats_matches_reference(cuda, shape):
    F, D, T, taps = shape
    Yt, Y, w, _ = wpe_inputs(F, D, T, taps=taps, seed=3, device=cuda)
    before = wpe_stats.wpe_statistics.launches
    R, P = wpe_stats.wpe_statistics(Yt, Y, w)
    torch.cuda.synchronize()
    assert wpe_stats.wpe_statistics.launches == before + 1
    rel_R, rel_P, _ = stats_errors(R, P,
                                   *wpe_stats.wpe_statistics_reference(
                                       Yt, Y, w))
    assert torch.isfinite(R).all() and torch.isfinite(P).all()
    assert rel_R <= STATS_RTOL and rel_P <= STATS_RTOL, (rel_R, rel_P)
    # the upper triangle is the conjugate mirror of the lower one
    assert torch.equal(R.transpose(-2, -1).conj().tril(-1), R.tril(-1))


def test_wpe_stats_is_deterministic(cuda):
    inputs = wpe_inputs(32, 24, 900, seed=4, device=cuda)[:3]
    R1, P1 = wpe_stats.wpe_statistics(*inputs)
    R2, P2 = wpe_stats.wpe_statistics(*inputs)
    assert torch.equal(R1, R2) and torch.equal(P1, P2)


# (T, frames appended): inside the last chunk, a whole chunk more, many
@pytest.mark.parametrize('T,extra', [(100, 20), (64, 32), (33, 300)])
def test_wpe_stats_padding_invariant(cuda, T, extra):
    """Frames appended to T with zero Y_tilde (masked: Y and the weight
    are whatever the padding holds, here noise and 1e8) leave R and P bit
    for bit as they were: chunks sit at fixed offsets, and a frame of zeros
    adds exactly nothing."""
    F, D = 4, 24
    Yt, Y, w, _ = wpe_inputs(F, D, T, seed=6, device=cuda)
    rng = np.random.default_rng(7)
    noise = rng.standard_normal((F, D, extra)) \
        + 1j * rng.standard_normal((F, D, extra))
    Yt2 = torch.cat([Yt, Yt.new_zeros((F, Yt.shape[1], extra))], -1)
    Y2 = torch.cat([Y, torch.as_tensor(noise.astype(np.complex64),
                                       device=cuda)], -1)
    w2 = torch.cat([w, w.new_full((F, extra), 1e8)], -1)
    R1, P1 = wpe_stats.wpe_statistics(Yt, Y, w)
    R2, P2 = wpe_stats.wpe_statistics(Yt2.contiguous(), Y2.contiguous(),
                                      w2.contiguous())
    assert torch.equal(R1, R2) and torch.equal(P1, P2)


def test_wpe_stats_rejects_unsupported_inputs(cuda):
    Yt, Y, w, _ = wpe_inputs(2, 3, 50, taps=2, seed=5, device=cuda)
    before = wpe_stats.wpe_statistics.launches
    for args in ((Yt.to(torch.complex128), Y, w), (Yt, Y, w.double()),
                 (Yt, Y[:, :, :40], w), (Yt, Y.transpose(0, 1)
                                         .contiguous().transpose(0, 1), w),
                 (Yt, Y.cpu(), w)):
        with pytest.raises(ValueError):
            wpe_stats.wpe_statistics(*args)
    assert wpe_stats.wpe_statistics.launches == before


@pytest.mark.parametrize('entry', sorted(GJ_ENTRIES))
@pytest.mark.parametrize('shape,D', [
    ((7,), 1), ((5,), 4), ((3, 4), 13), ((2,), 32), ((513, 5), 24),
], ids=lambda v: str(v))
def test_gj_matches_reference_on_hpd(cuda, entry, shape, D):
    kernel, reference = GJ_ENTRIES[entry]
    B = random_hpd(shape, D, seed=6, device=cuda)
    before = kernel.launches
    inv, ld = kernel(B)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert inv.shape == B.shape and ld.shape == B.shape[:-2]
    rel, dld, _ = inverse_errors(inv, ld, *reference(B))
    assert rel <= INV_RTOL and dld <= LOGDET_ATOL, (rel, dld)


def test_gj_on_em_like_batch(cuda):
    B = em_like_batch(513, 5, 24, seed=7, device=cuda)
    inv, ld = gj_inverse.hermitian_inverse_and_logdet_2d(B)
    inv_ref, ld_ref = gj_inverse.hermitian_inverse_and_logdet_2d_reference(B)
    assert torch.isfinite(inv).all() and torch.isfinite(ld).all()
    rel, dld, _ = inverse_errors(inv, ld, inv_ref, ld_ref)
    assert rel <= INV_RTOL and dld <= EM_LOGDET_ATOL, (rel, dld)
    res, _ = against_float64(B, inv, ld)
    res_ref, _ = against_float64(B, inv_ref, ld_ref)
    assert res <= 2 * res_ref + 1e-6, (res, res_ref)


def test_gj_floor_modes_differ_on_a_negative_pivot(cuda):
    B = negative_pivot_matrix().to(cuda)
    for entry, (kernel, reference) in GJ_ENTRIES.items():
        inv, ld = kernel(B)
        inv_ref, ld_ref = reference(B)
        torch.testing.assert_close(ld, ld_ref, rtol=1e-6, atol=0)
        torch.testing.assert_close(inv, inv_ref, rtol=1e-5, atol=0)
    assert float(gj_inverse.hermitian_inverse_and_logdet(B)[1]) == \
        -float('inf')


def test_gj_is_deterministic(cuda):
    B = em_like_batch(64, 5, 24, seed=8, device=cuda)
    for kernel, _ in GJ_ENTRIES.values():
        inv1, ld1 = kernel(B)
        inv2, ld2 = kernel(B)
        assert torch.equal(inv1, inv2) and torch.equal(ld1, ld2)


def test_gj_rejects_unsupported_inputs(cuda):
    before = {k: e.launches for k, (e, _) in GJ_ENTRIES.items()}
    for B in (random_hpd((2,), gj_inverse.MAX_D + 1, device=cuda),
              random_hpd((2,), 4, device=cuda).to(torch.complex128),
              random_hpd((2,), 4, device=cuda).transpose(-2, -1),
              random_hpd((0,), 4, device=cuda)):
        for kernel, _ in GJ_ENTRIES.values():
            with pytest.raises(ValueError):
                kernel(B)
    assert before == {k: e.launches for k, (e, _) in GJ_ENTRIES.items()}


WIDTHS = [1, 4, 17, 24, 32]


@pytest.mark.parametrize('mode', sorted(GJ_MODES))
@pytest.mark.parametrize('K', [1, 5])
@pytest.mark.parametrize('D', WIDTHS)
def test_gj_modes_at_every_width(cuda, mode, K, D):
    kernel, reference = GJ_MODES[mode]
    B = random_hpd((9, K), D, seed=D + K, device=cuda)
    before = kernel.launches
    inv, ld = kernel(B)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.isfinite(inv).all() and torch.isfinite(ld).all()
    rel, dld, _ = inverse_errors(inv, ld, *reference(B))
    assert rel <= INV_RTOL and dld <= LOGDET_ATOL, (rel, dld)


def test_relative_gj_on_em_like_batch(cuda):
    B = em_like_batch(513, 5, 24, seed=9, device=cuda)
    inv, ld = gj_inverse.gauss_jordan_inverse_and_logdet(B)
    inv_ref, ld_ref = linalg.gauss_jordan_inverse_and_logdet(B)
    assert torch.isfinite(inv).all() and torch.isfinite(ld).all()
    rel, dld, _ = inverse_errors(inv, ld, inv_ref, ld_ref)
    assert rel <= INV_RTOL and dld <= EM_LOGDET_ATOL, (rel, dld)
    res, _ = against_float64(B, inv, ld)
    res_ref, _ = against_float64(B, inv_ref, ld_ref)
    assert res <= 2 * res_ref + 1e-6, (res, res_ref)


def finalized_covariances(S, den):
    """The covariances the finalize inverts: trace-normalized, jittered."""
    return gj_inverse.add_jitter(gj_inverse.em_covariances(S, den)[1],
                                 DIAGONAL_FLOOR)


# K = MAX_K at D = 32 needs 66 KB of shared memory a CTA, above the 48 KB
# that a launch gets without the kernel's opt-in
@pytest.mark.parametrize('floor', sorted(gj_inverse.FLOORS))
@pytest.mark.parametrize('K', [1, 5, gj_inverse.MAX_K])
@pytest.mark.parametrize('D', WIDTHS)
def test_em_finalize_at_every_width(cuda, floor, K, D):
    S, den = em_state(9, K, D, seed=D + 10 * K, device=cuda)
    before = gj_inverse.em_finalize.launches
    out = gj_inverse.em_finalize(S, den, diagonal_floor=DIAGONAL_FLOOR,
                                 floor=floor)
    torch.cuda.synchronize()
    assert gj_inverse.em_finalize.launches == before + 1
    assert all(torch.isfinite(x).all() for x in out)
    ref = gj_inverse.em_finalize_reference(
        S, den, diagonal_floor=DIAGONAL_FLOOR, floor=floor)
    rel, dld, dlw = finalize_errors(out, ref)
    assert rel <= INV_RTOL and dld <= EM_LOGDET_ATOL \
        and dlw <= LOG_WEIGHT_ATOL, (rel, dld, dlw)
    B = finalized_covariances(S, den)
    res, _ = against_float64(B, out[1], out[2])
    res_ref, _ = against_float64(B, ref[1], ref[2])
    assert res <= 2 * res_ref + 1e-6, (res, res_ref)


@pytest.mark.parametrize('floor', sorted(gj_inverse.FLOORS))
def test_em_finalize_is_deterministic_and_batch_independent(cuda, floor):
    """Bit for bit: two runs, and one frequency alone against the same
    frequency inside the headline batch (no sum crosses matrices)."""
    S, den = em_state(513, 5, 24, seed=3, device=cuda)

    def run(S, den):
        return gj_inverse.em_finalize(S, den, diagonal_floor=DIAGONAL_FLOOR,
                                      floor=floor)
    first, second = run(S, den), run(S, den)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for f in (0, 1, 2, 300, 512):
        alone = run(S[f:f + 1].contiguous(), den[f:f + 1].contiguous())
        assert all(torch.equal(a, b[f:f + 1]) for a, b in zip(alone, first))


@pytest.mark.parametrize('mode', sorted(GJ_MODES))
def test_gj_modes_are_deterministic_and_batch_independent(cuda, mode):
    kernel, _ = GJ_MODES[mode]
    B = em_like_batch(64, 5, 24, seed=4, device=cuda)
    inv, ld = kernel(B)
    inv2, ld2 = kernel(B)
    assert torch.equal(inv, inv2) and torch.equal(ld, ld2)
    one, ld1 = kernel(B[17:18].contiguous())
    assert torch.equal(one, inv[17:18]) and torch.equal(ld1, ld[17:18])


@pytest.mark.parametrize('floor', sorted(gj_inverse.FLOORS))
def test_em_finalize_empty_class_bit_pin(cuda, floor):
    """den = 0 and S = 0: log_weight = log(FLT_MIN) and the inverse of
    B = I + jitter, bit for bit the plain version's on the card; a silent
    frequency (every class empty) stays finite."""
    K, D = 5, 24
    S, den = em_state(4, K, D, seed=5, device=cuda)
    out = gj_inverse.em_finalize(S, den, diagonal_floor=DIAGONAL_FLOOR,
                                 floor=floor)
    ref = gj_inverse.em_finalize_reference(
        S, den, diagonal_floor=DIAGONAL_FLOOR, floor=floor)
    tiny = torch.finfo(torch.float32).tiny
    for f, k in [(1, K - 1)] + [(0, k) for k in range(K)]:
        for a, b in zip(out, ref):
            assert torch.equal(a[f, k], b[f, k]), (f, k)
        assert float(out[0][f, k]) == float(np.log(np.float32(tiny)))
    assert all(torch.isfinite(x[0]).all() for x in out)
    eye = torch.eye(D, dtype=S.dtype, device=cuda)
    torch.testing.assert_close(out[1][1, K - 1], eye / (1 + DIAGONAL_FLOOR),
                               rtol=1e-6, atol=0)


def test_em_finalize_rejects_unsupported_inputs(cuda):
    S, den = em_state(3, 2, 4, seed=6, device=cuda)
    before = gj_inverse.em_finalize.launches
    bad = [(S.to(torch.complex128), den), (S, den.double()),
           (S, den[:, :1].contiguous()), (S, den.cpu()),
           (S.transpose(-2, -1), den), (S[:, :, :3], den),
           (torch.zeros((1, 9, 4, 4), dtype=S.dtype, device=cuda),
            torch.zeros((1, 9), device=cuda)),
           (torch.zeros((1, 1, 33, 33), dtype=S.dtype, device=cuda),
            torch.zeros((1, 1), device=cuda))]
    for S_bad, den_bad in bad:
        with pytest.raises(ValueError):
            gj_inverse.em_finalize(S_bad, den_bad,
                                   diagonal_floor=DIAGONAL_FLOOR)
    with pytest.raises(ValueError):
        gj_inverse.em_finalize(S, den, diagonal_floor=DIAGONAL_FLOOR,
                               floor='flushed_log')
    assert gj_inverse.em_finalize.launches == before


def negative_pivot_matrix(D=6, seed=0):
    """One Hermitian matrix, near the identity, whose last pivot is
    negative (-0.5): K3 floors it to FLT_MIN (a logdet term of -87.34 and
    a ~1e37 last row), K4 takes its reciprocal and a logdet of -inf."""
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((D, D)) + 1j * rng.standard_normal((D, D))
    B = np.eye(D) + 0.01 * (E + E.conj().T) / 2
    B[-1, -1] = -0.5
    return torch.as_tensor(B[None].astype(np.complex64))


@pytest.mark.parametrize('F,S,E', [
    (3, 32, 1), (2, 64, 5), (5, 160, 24), (2, 512, 24), (1, 992, 24),
], ids=lambda v: str(v))
def test_chol_solve_matches_reference(cuda, F, S, E):
    A2, B2 = spd_system(F, S, E, seed=9, device=cuda)
    before = chol_solve.chol_solve_real_spd.launches
    X = chol_solve.chol_solve_real_spd(A2, B2)
    torch.cuda.synchronize()
    assert chol_solve.chol_solve_real_spd.launches == before + 1
    assert X.shape == B2.shape and torch.isfinite(X).all()
    rel = frobenius_errors(X, chol_solve.chol_solve_real_spd_reference(A2, B2))
    assert rel <= SOLVE_RTOL, rel
    X64 = torch.linalg.solve(A2.double(), B2.double())
    assert frobenius_errors(X.double(), X64) <= SOLVE_RTOL


def test_hermitian_solve_pallas_at_the_wpe_headline(cuda):
    """513 systems of 240 x 240 (the real block 480 -> 512), 24
    right-hand sides, the WPE load 1e-4."""
    A, B = hpd_system(513, 240, 24, seed=10, device=cuda)
    before = chol_solve.hermitian_solve_pallas.launches
    X = chol_solve.hermitian_solve_pallas(A, B, relative_load=1e-4)
    torch.cuda.synchronize()
    assert chol_solve.hermitian_solve_pallas.launches == before + 1
    assert X.dtype == torch.complex64 and torch.isfinite(X).all()
    ref = chol_solve.hermitian_solve_pallas_reference(A, B,
                                                      relative_load=1e-4)
    assert frobenius_errors(X, ref) <= SOLVE_RTOL
    assert solve_error_f64(X, A, B, 1e-4) <= SOLVE_F64_RTOL


def test_chol_solve_zero_pivot_floor_pin(cuda):
    A2 = torch.eye(64, device=cuda)[None].contiguous()
    A2[0, 5, 5] = 0
    B2 = torch.zeros((1, 64, 3), device=cuda)
    B2[0, 5, 0] = 1
    B2[0, 7, 1] = 2
    X = chol_solve.chol_solve_real_spd(A2, B2)
    want = B2.clone()
    want[0, 5, 0] = 1 / torch.finfo(torch.float32).tiny
    assert torch.equal(X, want)
    assert torch.equal(X, chol_solve.chol_solve_real_spd_reference(A2, B2))


def test_chol_solve_is_deterministic(cuda):
    A2, B2 = spd_system(40, 256, 24, seed=11, device=cuda)
    assert torch.equal(chol_solve.chol_solve_real_spd(A2, B2),
                       chol_solve.chol_solve_real_spd(A2, B2))


def test_chol_solve_rejects_unsupported_inputs(cuda):
    A2, B2 = spd_system(2, 64, 3, seed=12, device=cuda)
    n = chol_solve.max_rows(3) + chol_solve.BLOCK
    before = chol_solve.chol_solve_real_spd.launches
    for args in ((A2.double(), B2), (A2, B2.cpu()), (A2[:, :48, :48], B2),
                 (A2.transpose(-2, -1), B2), (A2[:0], B2[:0]),
                 (torch.eye(n, device=cuda)[None],
                  torch.zeros((1, n, 3), device=cuda))):
        with pytest.raises(ValueError):
            chol_solve.chol_solve_real_spd(*args)
    assert chol_solve.chol_solve_real_spd.launches == before


# the complex instantiation (hermitian_solve_chol): d one above a panel
# (33), a padded last panel (40, 200, 240), whole panels (64, 256)
@pytest.mark.parametrize('refine', [0, 1], ids=['refine0', 'refine1'])
@pytest.mark.parametrize('E', [1, 3, 24])
@pytest.mark.parametrize('d', [33, 40, 64, 200, 240, 256])
def test_hermitian_solve_chol_matches_reference(cuda, d, E, refine):
    F = 513 if (d, E) == (240, 24) else 5
    A, B = hpd_system(F, d, E, seed=d + E, device=cuda)
    before = chol_solve.hermitian_solve_chol.launches
    X = chol_solve.hermitian_solve_chol(A, B, relative_load=1e-4,
                                        refine=refine)
    torch.cuda.synchronize()
    assert chol_solve.hermitian_solve_chol.launches == before + 1
    assert X.shape == B.shape and X.dtype == torch.complex64
    assert torch.isfinite(X).all()
    ref = chol_solve.hermitian_solve_chol_reference(
        A, B, relative_load=1e-4, refine=refine)
    assert frobenius_errors(X, ref) <= SOLVE_RTOL
    assert torch.equal(X, ref)          # the same operations, one for one
    X64 = linalg.hermitian_solve(A.to(torch.complex128),
                                 B.to(torch.complex128), relative_load=1e-4,
                                 refine=refine)
    assert frobenius_errors(X.to(torch.complex128), X64) <= SOLVE_F64_RTOL


def test_hermitian_solve_chol_relative_floor_pin(cuda):
    """Identity 40 x 40 with A[3, 3] = 0, no load: the pivot is floored
    at eps^2 max(diag) (the padding's ones counted), after the scale
    floor 1 / sqrt(eps) on row 3: X[3] = b / eps / eps^2, as the plain
    version (and JAX) give; every other row exact."""
    eps = torch.finfo(torch.float32).eps
    A = torch.eye(40, dtype=torch.complex64, device=cuda)[None].contiguous()
    A[0, 3, 3] = 0
    B = torch.zeros((1, 40, 2), dtype=torch.complex64, device=cuda)
    B[0, 3, 0] = 1e-20
    B[0, 7, 1] = 2
    X = chol_solve.hermitian_solve_chol(A, B, relative_load=0)
    ref = chol_solve.hermitian_solve_chol_reference(A, B, relative_load=0)
    assert abs(float(X[0, 3, 0].real) / (1e-20 / eps ** 3) - 1) <= 1e-5
    assert torch.equal(X, ref)
    rest = torch.cat([X[:, :3], X[:, 4:]], dim=1)
    want = torch.cat([B[:, :3], B[:, 4:]], dim=1)
    assert torch.equal(rest, want)


def test_hermitian_solve_chol_all_zero_matrix(cuda):
    """An all-zero matrix is not equilibrated: the load alone is solved,
    X = B / load, as the plain version gives."""
    A = torch.zeros((2, 48, 48), dtype=torch.complex64, device=cuda)
    _, B = hpd_system(2, 48, 3, seed=21, device=cuda)
    X = chol_solve.hermitian_solve_chol(A, B, relative_load=1e-4)
    ref = chol_solve.hermitian_solve_chol_reference(A, B, relative_load=1e-4)
    assert torch.isfinite(X).all()
    assert torch.equal(X, ref)


@pytest.mark.parametrize('refine', [0, 1])
def test_hermitian_solve_chol_is_deterministic_and_batch_independent(
        cuda, refine):
    A, B = hpd_system(40, 240, 24, seed=22, device=cuda)
    X = chol_solve.hermitian_solve_chol(A, B, relative_load=1e-4,
                                        refine=refine)
    assert torch.equal(X, chol_solve.hermitian_solve_chol(
        A, B, relative_load=1e-4, refine=refine))
    one = chol_solve.hermitian_solve_chol(
        A[17:18].contiguous(), B[17:18].contiguous(), relative_load=1e-4,
        refine=refine)
    assert torch.equal(one, X[17:18])


def test_hermitian_solve_chol_rejects_unsupported_inputs(cuda):
    A, B = hpd_system(2, 64, 3, seed=23, device=cuda)
    small = hpd_system(2, 32, 3, seed=23, device=cuda)
    large = hpd_system(1, 264, 3, seed=23, device=cuda)
    before = chol_solve.hermitian_solve_chol.launches
    for args in (small, large, (A.to(torch.complex128), B),
                 (A.transpose(-2, -1), B), (A, B.cpu()), (A[:0], B[:0]),
                 (A, B[:, :40])):
        with pytest.raises(ValueError):
            chol_solve.hermitian_solve_chol(*args, relative_load=1e-4)
    with pytest.raises(ValueError):
        chol_solve.hermitian_solve_chol(A, B, relative_load=1e-4, refine=-1)
    assert chol_solve.hermitian_solve_chol.launches == before
