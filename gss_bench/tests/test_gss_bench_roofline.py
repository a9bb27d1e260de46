"""The least-work counts of ``gss_bench/roofline.py``: the K1 and K2 terms
against ``chip_smoke.py``'s bounds, and below the dense FLOP model of
``pb_chime5_tpu_torch/utils/flops.py`` for every stage."""

import inspect

import numpy as np
import pytest
import torch

import chip_smoke
from gss_bench import roofline
from pb_chime5_tpu_torch.ops.stft import stft_frame_count
from pb_chime5_tpu_torch.utils import flops


def k1_inputs(F, T, D, K, seed):
    """Seeded inputs of one K1 launch: a gate with inactive pairs and a
    frame mask with a masked tail."""
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((F, T, D), dtype=torch.complex64, generator=g)
    params = (torch.zeros((F, K)), torch.eye(D, dtype=torch.complex64)
              .expand(F, K, D, D).contiguous(), torch.zeros((F, K)))
    act = (torch.rand((K, T), generator=g) > 0.4).float()
    fm = torch.ones(T)
    fm[T - T // 5:] = 0
    return z, params, act, fm


@pytest.mark.parametrize('F, T, D, K, seed', [
    (513, 2048, 24, 5, 0), (513, 700, 4, 5, 1), (64, 300, 12, 3, 2)])
def test_k1_term_matches_chip_smoke(F, T, D, K, seed):
    z, params, act, fm = k1_inputs(F, T, D, K, seed)
    valid = fm > 0
    pairs = int(((act > 0) & valid[None]).sum())
    ops = roofline.k1_flops(F, int(valid.sum()), D, K, pairs)
    bound_ms, bound_by = chip_smoke.k1_bound(z, params, act, fm)
    if bound_by == 'operations':
        assert ops / roofline.FP32_FLOP_PER_S * 1e3 == pytest.approx(
            bound_ms, rel=1e-12)
    assert ops / roofline.FP32_FLOP_PER_S * 1e3 <= bound_ms * (1 + 1e-12)
    if D == 24:          # the headline is bound by its operations
        assert bound_by == 'operations'


def test_k2_term_matches_chip_smoke():
    """K2's count in ``chip_smoke.k2_vs_plain``, the formula as written
    there, evaluated on seeded shapes."""
    formula = ('flops = 8.0 * F * valid * (dim * (dim + 1) // 2 + dim * D)')
    assert formula in inspect.getsource(chip_smoke.k2_vs_plain)
    rng = np.random.default_rng(3)
    for _ in range(20):
        F = int(rng.integers(1, 600))
        valid = int(rng.integers(1, 5000))
        D = int(rng.integers(1, 25))
        taps = int(rng.integers(1, 12))
        dim = taps * D
        scope = {'F': F, 'valid': valid, 'dim': dim, 'D': D}
        exec(formula, scope)
        assert roofline.k2_flops(F, valid, D, taps) == scope['flops']


@pytest.mark.parametrize('D, seconds', [(24, 32.6), (24, 50.0), (4, 31.0)])
def test_dense_flop_model_counts_more(D, seconds):
    """``utils/flops.py`` counts both triangles, the full solve and every
    class's M-step: above the least count, stage by stage, also with
    every (frame, class) pair active."""
    K, F = 5, 513
    n = int(seconds * 16000)
    T = stft_frame_count(n, 1024, 256)
    dense = flops.gss_stage_flops(num_samples=n, D=D, K=K)
    wpe, _ = roofline.wpe_work(F, D, T, 10, 3)
    em, _ = roofline.em_work(F, D, T, K, K * T, 20, 1)
    assert wpe < dense['wpe_stats'] + dense['wpe_solve'] + dense['wpe_tail']
    assert em < dense['em']
    # the headline: about 1.1 TFLOP of WPE and 0.2 TFLOP of EM
    if (D, seconds) == (24, 32.6):
        assert 1.0e12 < wpe < 1.2e12
        em_typical, _ = roofline.em_work(F, D, T, K, int(2.5 * T), 20, 1)
        assert 1.5e11 < em_typical < 2.5e11


def test_least_seconds_takes_the_larger_bound():
    assert roofline.least_seconds(67e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(67e9, 3.35e12) == pytest.approx(1.0)


def test_em_passes_count_the_gated_pairs():
    F, D, T, K = 10, 4, 100, 3
    full, _ = roofline.em_work(F, D, T, K, K * T, 5, 1)
    gated, _ = roofline.em_work(F, D, T, K, T, 5, 1)
    assert full - gated == 4 * roofline.k1_flops(F, T, D, K, K * T - T) \
        - 4 * roofline.k1_flops(F, T, D, K, 0)
