"""The per-frequency ('xla') cacGMM EM, its chunked iteration and the
debug twin on the card against the CPU, with their kernel launches, and
the kernel wrappers' refusal of complex128 CUDA tensors.

Marked ``cuda`` and skipped without a CUDA device; run on a machine with
an H100 with ``python -m pytest --noconftest tests/test_torch_cacgmm_cuda.py``
(``tests/conftest.py`` imports JAX).

Tolerances: complex128 posteriors card vs CPU within 1e-9 at 20 + 1
iterations (the same float64 operations, cuBLAS's and the CPU's summation
orders), the chunked EM against the unfused one on the card within 1e-9;
complex64 at 2 + 0 within 1e-4 (float32 rounding through two M-steps,
the relative-floor Gauss-Jordan kernel against its plain version).

Launches: at 20 + 1 the complex64 'xla' EM inverts each of its 20
M-steps on the Gauss-Jordan kernel's relative entry, and launches neither
the fused E+M kernel nor ``em_finalize``; the chunked EM launches the
relative entry once (its first M-step) and ``em_finalize`` 19 times;
complex128 launches no kernel.
"""

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch import _device
from pb_chime5_tpu_torch.ops import cacgmm
from pb_chime5_tpu_torch.ops.kernels import (
    chol_solve, fused_em, gj_inverse, wpe_stats)

pytestmark = pytest.mark.cuda

F, T, D, K = 16, 400, 8, 3
F64_ATOL = 1e-9
F32_ATOL = 1e-4
ENTRIES = (fused_em.fused_em_scatter, gj_inverse.em_finalize,
           gj_inverse.gauss_jordan_inverse_and_logdet,
           gj_inverse.hermitian_inverse_and_logdet_2d,
           gj_inverse.hermitian_inverse_and_logdet,
           wpe_stats.wpe_statistics, chol_solve.hermitian_solve_chol,
           chol_solve.chol_solve_real_spd)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    _device.assert_precision()
    return torch.device('cuda')


def problem(dtype):
    """Y (F, T, D) with a padded tail, activity (K, T) with a garbage
    class, frame mask (T,)."""
    rng = np.random.default_rng(11)
    Y = rng.standard_normal((F, T, D)) + 1j * rng.standard_normal((F, T, D))
    Y[:, :, 0] *= 2.0
    Y[:, T - 30:] = 0
    act = np.zeros((K, T), bool)
    act[0, :250] = True
    act[1, 150:] = True
    act[2] = True
    return (torch.from_numpy(Y.astype(dtype)), torch.from_numpy(act),
            torch.arange(T) < T - 30)


def run(device, dtype, **kw):
    """(posteriors on the CPU, {entry: launches}) of one EM run."""
    Y, act, fm = (x.to(device) for x in problem(dtype))
    for entry in ENTRIES:
        entry.launches = 0
    out = cacgmm.cacgmm_posteriors(
        Y, act, config=cacgmm.CacgmmConfig(em_backend='xla', **kw),
        frame_mask=fm)
    torch.cuda.synchronize()
    return out.cpu(), {e.__name__: e.launches for e in ENTRIES if e.launches}


@pytest.mark.parametrize('chunk', [None, 64], ids=['unfused', 'chunked'])
def test_xla_em_complex128_card_matches_cpu(cuda, chunk):
    got, launches = run(cuda, np.complex128, em_chunk_size=chunk)
    want, _ = run('cpu', np.complex128, em_chunk_size=chunk)
    assert launches == {}
    assert got.dtype == torch.float64 and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F64_ATOL,
                               rtol=0)


def test_chunked_em_matches_unfused_on_card(cuda):
    chunked, _ = run(cuda, np.complex128, em_chunk_size=64)
    unfused, _ = run(cuda, np.complex128)
    np.testing.assert_allclose(chunked.numpy(), unfused.numpy(),
                               atol=F64_ATOL, rtol=0)


@pytest.mark.parametrize('inverse', ['auto', 'pallas_gj'])
def test_xla_em_complex64_launches(cuda, inverse):
    """20 + 1: the relative entry 20 times ('pallas_gj' included), nothing
    else; chunked: the relative entry once, ``em_finalize`` 19 times."""
    _, launches = run(cuda, np.complex64, inverse=inverse)
    assert launches == {'gauss_jordan_inverse_and_logdet': 20}
    _, launches = run(cuda, np.complex64, inverse=inverse, em_chunk_size=64)
    assert launches == {'gauss_jordan_inverse_and_logdet': 1,
                        'em_finalize': 19}


@pytest.mark.parametrize('chunk', [None, 64], ids=['unfused', 'chunked'])
def test_xla_em_complex64_card_matches_cpu(cuda, chunk):
    kw = dict(iterations=2, iterations_post=0, em_chunk_size=chunk)
    got, _ = run(cuda, np.complex64, **kw)
    want, _ = run('cpu', np.complex64, **kw)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=F32_ATOL,
                               rtol=0)


def test_debug_twin_card_matches_cpu(cuda):
    """complex128: posteriors and the four statistics, no launch."""
    outs = {}
    for device in (cuda, 'cpu'):
        Y, act, fm = (x.to(device) for x in problem(np.complex128))
        for entry in ENTRIES:
            entry.launches = 0
        outs[str(device)] = cacgmm.cacgmm_posteriors_debug(
            Y, act, config=cacgmm.CacgmmConfig(iterations=6), frame_mask=fm)
        assert not any(e.launches for e in ENTRIES)
    (got, stats), (want, stats_cpu) = outs['cuda'], outs['cpu']
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               atol=F64_ATOL, rtol=0)
    for key, value in stats.items():
        assert value.shape[0] == 6                # 1 + 5 M-steps
        np.testing.assert_allclose(value.cpu().numpy(),
                                   stats_cpu[key].numpy(), atol=F64_ATOL,
                                   rtol=1e-9)


def complex128_calls(device):
    """One call of every kernel wrapper on complex128 (float64) tensors on
    ``device``, each otherwise well-formed."""
    c128 = dict(dtype=torch.complex128, device=device)
    f64 = dict(dtype=torch.float64, device=device)
    z = torch.randn((4, 50, 6), **c128)
    params = (torch.zeros((4, 3), **f64),
              torch.eye(6, **c128).expand(4, 3, 6, 6).contiguous(),
              torch.zeros((4, 3), **f64))
    B = torch.eye(6, **c128).expand(4, 6, 6).contiguous()
    S = torch.eye(6, **c128).expand(4, 3, 6, 6).contiguous()
    A = torch.eye(40, **c128).expand(4, 40, 40).contiguous()
    return [
        lambda: fused_em.fused_em_scatter(
            z, params, torch.ones((3, 50), **f64), torch.ones(50, **f64)),
        lambda: gj_inverse.em_finalize(S, torch.ones((4, 3), **f64),
                                       diagonal_floor=1e-6),
        lambda: gj_inverse.gauss_jordan_inverse_and_logdet(B),
        lambda: gj_inverse.hermitian_inverse_and_logdet_2d(B),
        lambda: gj_inverse.hermitian_inverse_and_logdet(B),
        lambda: gj_inverse.hermitian_solve_gj(B, B),
        lambda: wpe_stats.wpe_statistics(
            torch.zeros((4, 60, 50), **c128), torch.zeros((4, 6, 50), **c128),
            torch.ones((4, 50), **f64)),
        lambda: chol_solve.hermitian_solve_chol(
            A, torch.ones((4, 40, 3), **c128)),
        lambda: chol_solve.chol_solve_real_spd(
            torch.eye(64, **f64).expand(4, 64, 64).contiguous(),
            torch.ones((4, 64, 3), **f64)),
    ]


def test_kernel_wrappers_raise_for_complex128_on_cuda(cuda):
    """complex128 (float64) CUDA tensors: every kernel wrapper raises
    (``ValueError``) instead of computing, and counts no launch; the
    float64 chain reaches plain PyTorch by dtype at its call sites."""
    for entry in ENTRIES:
        entry.launches = 0
    for call in complex128_calls(cuda):
        with pytest.raises(ValueError):
            call()
    assert not any(e.launches for e in ENTRIES)
