"""The fused E+M CUDA kernel vs its plain PyTorch version, on the card.

Marked ``cuda`` and skipped without a CUDA device (the kernel has no CPU
or interpret mode); run on a machine with an H100 with
``python -m pytest --noconftest tests/test_torch_fused_em_cuda.py``
(``tests/conftest.py`` imports JAX).  ``chip_smoke.py`` makes the same
comparison at the headline shape, with the inputs and error measures
defined here.

Tolerance: relative Frobenius error per (f, k) of S <= 1e-4 and relative
error of den <= 1e-5.  Both versions accumulate in float32 over T frames
in different orders; the quadratic forms enter the responsibilities as
D * log q, so a rounding-level difference in q moves gamma by ~D * eps
per frame before the sums over T average it out.
"""

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch import _device
from pb_chime5_tpu_torch.ops.kernels import fused_em

pytestmark = pytest.mark.cuda

S_RTOL = 1e-4
DEN_RTOL = 1e-5
# den of one to a few hundred frames: nothing averages the per-frame
# rounding, and a q that differs by ~4e-7 relative between two float32
# orders moves gamma by ~D times that (2.4e-5 at D = 24; 1.05e-5 measured
# at T = 1)
DEN_RTOL_SHORT = 1e-4


def random_inputs(F, T, D, K, *, seed=0, identity=False, skew=0.0,
                  device='cpu'):
    """Seeded inputs at a given shape, made with NumPy: unit-norm z,
    random Hermitian PD precisions (or identities with zero log-weights
    and logdets when ``identity``: the EM's initial pass), an activity
    gate with one all-zero class and an always-on last class (or, when
    ``identity``, the floored column-normalized initialization), and a
    frame mask with a padded tail of T // 10 frames.  ``skew`` > 0 adds
    ``skew`` times a random anti-Hermitian matrix to each precision, drawn
    after everything else (the other inputs do not change)."""
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((F, T, D)) + 1j * rng.standard_normal((F, T, D))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    active = rng.random((K, T)) > 0.4
    active[-1] = True
    if K > 2:
        active[1] = False
    if identity:
        precision = np.broadcast_to(np.eye(D), (F, K, D, D))
        log_weight = np.zeros((F, K))
        logdet = np.zeros((F, K))
        act = np.where(active, 1.0, 1e-10)
        act = act / act.sum(axis=0, keepdims=True)
    else:
        A = rng.standard_normal((F, K, D, D)) \
            + 1j * rng.standard_normal((F, K, D, D))
        precision = A @ A.conj().swapaxes(-1, -2) / D + 0.1 * np.eye(D)
        w = rng.dirichlet(np.ones(K), size=F)
        log_weight = np.log(w)
        logdet = -np.linalg.slogdet(precision)[1]
        act = active.astype(np.float64)
    fm = np.ones(T)
    fm[T - T // 10:] = 0.0
    if skew:
        B = rng.standard_normal((F, K, D, D)) \
            + 1j * rng.standard_normal((F, K, D, D))
        precision = precision + skew * (B - B.conj().swapaxes(-1, -2)) / 2

    def t(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    params = (t(log_weight, torch.float32), t(precision, torch.complex64),
              t(logdet, torch.float32))
    return (t(z, torch.complex64), params, t(act, torch.float32),
            t(fm, torch.float32))


def scatter_errors(S, den, S_ref, den_ref):
    """Largest per-(f, k) relative Frobenius error of S, largest
    per-(f, k) relative error of den (both 0 where the reference and the
    result are exactly 0), and the largest absolute error of either."""
    tiny = torch.finfo(torch.float32).tiny
    dS = torch.linalg.matrix_norm(S - S_ref)
    nS = torch.linalg.matrix_norm(S_ref)
    rel_S = torch.where(dS == 0, torch.zeros_like(dS),
                        dS / torch.clamp_min(nS, tiny))
    dd = (den - den_ref).abs()
    rel_den = torch.where(dd == 0, torch.zeros_like(dd),
                          dd / torch.clamp_min(den_ref.abs(), tiny))
    max_abs = max(float((S - S_ref).abs().max()), float(dd.max()))
    return float(rel_S.max()), float(rel_den.max()), max_abs


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernel has no CPU mode')
    _device.assert_precision()
    return torch.device('cuda')


# shapes across the kernel's instantiations (register bound on D: 8, 16,
# 24), partial frame chunks and the size limits, plus the headline shape;
# odd D (9, 13, 17, 23) leave the M-step's blocks (2 x 2 below D = 17,
# 2 x 3 above) a ragged last row and column, at one class and at every
# class
@pytest.mark.parametrize('shape', [
    (3, 1, 1, 1), (7, 100, 4, 3), (5, 70, 12, 2), (4, 50, 16, 5),
    (4, 97, 20, 4), (16, 333, 24, 5), (513, 2504, 24, 5),
    *[(6, 90, D, K) for D in (9, 13, 17, 23) for K in (1, 5)],
], ids=lambda s: 'F{}-T{}-D{}-K{}'.format(*s))
@pytest.mark.parametrize('identity', [False, True])
def test_kernel_matches_reference(cuda, shape, identity):
    z, params, act, fm = random_inputs(*shape, seed=7, identity=identity,
                                       device=cuda)
    before = fused_em.fused_em_scatter.launches
    S, den = fused_em.fused_em_scatter(z, params, act, fm)
    torch.cuda.synchronize()
    assert fused_em.fused_em_scatter.launches == before + 1
    S_ref, den_ref = fused_em.fused_em_scatter_reference(z, params, act, fm)
    rel_S, rel_den, _ = scatter_errors(S, den, S_ref, den_ref)
    assert torch.isfinite(S).all() and torch.isfinite(den).all()
    assert rel_S <= S_RTOL, rel_S
    assert rel_den <= DEN_RTOL, rel_den


def check_against_reference(z, params, act, fm, den_rtol=DEN_RTOL):
    """One launch, counted, finite and within the tolerances of the plain
    version; returns (S, den)."""
    before = fused_em.fused_em_scatter.launches
    S, den = fused_em.fused_em_scatter(z, params, act, fm)
    torch.cuda.synchronize()
    assert fused_em.fused_em_scatter.launches == before + 1
    S_ref, den_ref = fused_em.fused_em_scatter_reference(z, params, act, fm)
    rel_S, rel_den, _ = scatter_errors(S, den, S_ref, den_ref)
    assert torch.isfinite(S).all() and torch.isfinite(den).all()
    assert rel_S <= S_RTOL, rel_S
    assert rel_den <= den_rtol, rel_den
    return S, den


def test_non_hermitian_precision(cuda):
    """HPD plus an anti-Hermitian part: the kernel forms the full product
    P z, as the plain version does."""
    check_against_reference(*random_inputs(16, 333, 24, 5, seed=10,
                                           skew=0.3, device=cuda))


def test_interior_masked_frames_and_zero_rows(cuda):
    z, params, act, fm = random_inputs(8, 300, 24, 5, seed=11, device=cuda)
    fm[40:75] = 0
    fm[130] = 0
    z[:, 10] = 0            # zero observations on valid frames
    z[:, 64:66] = 0
    z[:, 50] = 0            # and on a masked one
    check_against_reference(z, params, act, fm)


def test_silent_and_single_frame_classes(cuda):
    z, params, act, fm = random_inputs(8, 300, 24, 5, seed=12, device=cuda)
    act[0] = 0
    act[2] = 0
    act[2, 57] = 1
    S, den = check_against_reference(z, params, act, fm)
    assert not S[:, 0].any() and not den[:, 0].any()
    assert den[:, 2].gt(0).any()


# the last (partial) chunk on each rank of the cluster, T below one chunk
# and T = 1
CHUNK_SPAN = fused_em.CHUNK * fused_em.CLUSTER


@pytest.mark.parametrize('T', [1, 17, fused_em.CHUNK + 18,
                               2 * fused_em.CHUNK + 26,
                               3 * fused_em.CHUNK + 24,
                               CHUNK_SPAN + 22, 2 * CHUNK_SPAN + 3 * 32 + 1])
def test_partial_chunks(cuda, T):
    for identity in (False, True):
        check_against_reference(*random_inputs(6, T, 24, 5, seed=T,
                                               identity=identity,
                                               device=cuda),
                                den_rtol=DEN_RTOL_SHORT)


@pytest.mark.parametrize('T', [100, 333])
@pytest.mark.parametrize('extra', [1, 37, 300])
def test_padding_invariance(cuda, T, extra):
    """T padded with fm == 0 frames (garbage z, act on) gives the S and den
    of the unpadded T bit for bit: chunks sit at fixed frame offsets and
    masked frames are skipped."""
    z, params, act, fm = random_inputs(8, T, 24, 5, seed=13, device=cuda)
    rng = np.random.default_rng(14)
    pad = torch.as_tensor(rng.standard_normal((8, extra, 24)),
                          dtype=torch.complex64, device=cuda)
    z2 = torch.cat((z, pad), dim=1).contiguous()
    act2 = torch.cat((act, torch.ones((5, extra), device=cuda)),
                     dim=1).contiguous()
    fm2 = torch.cat((fm, torch.zeros(extra, device=cuda))).contiguous()
    S1, den1 = fused_em.fused_em_scatter(z, params, act, fm)
    S2, den2 = fused_em.fused_em_scatter(z2, params, act2, fm2)
    assert torch.equal(S1, S2) and torch.equal(den1, den2)


def test_kernel_is_deterministic(cuda):
    inputs = random_inputs(64, 1000, 24, 5, seed=8, device=cuda)
    S1, den1 = fused_em.fused_em_scatter(*inputs)
    S2, den2 = fused_em.fused_em_scatter(*inputs)
    assert torch.equal(S1, S2) and torch.equal(den1, den2)


@pytest.mark.parametrize('D,K', [(fused_em.MAX_D + 1, 2),
                                 (4, fused_em.MAX_K + 1)])
def test_kernel_rejects_sizes_out_of_range(cuda, D, K):
    inputs = random_inputs(2, 10, D, K, seed=9, device=cuda)
    before = fused_em.fused_em_scatter.launches
    with pytest.raises(ValueError):
        fused_em.fused_em_scatter(*inputs)
    assert fused_em.fused_em_scatter.launches == before


def batched_inputs(F, T, D, K, B, *, seed=0, identity=False,
                   device='cpu'):
    """B utterances of :func:`random_inputs` (seeds ``seed`` .. seed + B
    - 1) as one batch: z and params (B * F, ...), act (B, K, T) and fm
    (B, T), each utterance's frame mask with another padded tail and a
    masked interior frame, so that a row reading another utterance's gate
    or mask shows."""
    rows = [random_inputs(F, T, D, K, seed=seed + b, identity=identity,
                          device=device) for b in range(B)]
    for b, (_, _, _, fm) in enumerate(rows):
        fm[T - T // (b + 2):] = 0
        fm[(3 * b) % T] = 0
    z = torch.cat([r[0] for r in rows]).contiguous()
    params = tuple(torch.cat([r[1][i] for r in rows]).contiguous()
                   for i in range(3))
    act = torch.stack([r[2] for r in rows]).contiguous()
    fm = torch.stack([r[3] for r in rows]).contiguous()
    return z, params, act, fm


@pytest.mark.parametrize('B', [1, 3])
@pytest.mark.parametrize('shape', [(7, 100, 4, 3), (16, 333, 24, 5),
                                   (513, 2504, 24, 5)],
                         ids=lambda s: 'F{}-T{}-D{}-K{}'.format(*s))
def test_batched_kernel_matches_reference(cuda, B, shape):
    """The batched entry (each utterance's rows with its own gate and
    mask, one launch) against its plain version, at the gates above."""
    for identity in (False, True):
        check_against_reference(*batched_inputs(*shape, B, seed=21,
                                                identity=identity,
                                                device=cuda))


def test_batched_kernel_of_one_is_the_unbatched_kernel(cuda):
    """B = 1 (act (1, K, T), fm (1, T)) gives the unbatched entry's S and
    den bit for bit; and each utterance of a batch of 3 its own unbatched
    launch's."""
    z, params, act, fm = random_inputs(64, 1000, 24, 5, seed=22,
                                       device=cuda)
    S1, den1 = fused_em.fused_em_scatter(z, params, act, fm)
    S2, den2 = fused_em.fused_em_scatter(z, params, act[None].contiguous(),
                                         fm[None].contiguous())
    assert torch.equal(S1, S2) and torch.equal(den1, den2)
    F = 16
    z, params, act, fm = batched_inputs(F, 333, 24, 5, 3, seed=23,
                                        device=cuda)
    S, den = fused_em.fused_em_scatter(z, params, act, fm)
    for b in range(3):
        rows = slice(b * F, (b + 1) * F)
        Sb, denb = fused_em.fused_em_scatter(
            z[rows].contiguous(),
            tuple(p[rows].contiguous() for p in params), act[b], fm[b])
        assert torch.equal(S[rows], Sb) and torch.equal(den[rows], denb)
