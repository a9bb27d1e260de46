"""The port's tooling against the JAX package's: ``utils/profiling.py``
(twins of ``tests/test_aux.py::test_stage_timer``, ``test_device_sync``,
``test_profiler_trace``) and the FLOP model ``utils/flops.py``.

The FLOP model is the port's own formulation (full complex Grams, real
FFTs, the card's peak); its EM, inverse and beamformer terms are the JAX
model's, equal as integers; its WPE and STFT terms equal a count by hand
from the docstring's formulas.
"""

import json
import math

import numpy as np
import pytest
import torch

from pb_chime5_tpu.ops.stft import stft_frame_count as jax_frame_count
from pb_chime5_tpu.utils.flops import gss_stage_flops as jax_stage_flops
from pb_chime5_tpu.utils.profiling import StageTimer as JaxStageTimer
from pb_chime5_tpu_torch.utils import flops
from pb_chime5_tpu_torch.utils.profiling import StageTimer, device_sync, trace


def test_stage_timer():
    reports = []
    for cls in (StageTimer, JaxStageTimer):
        timer = cls()
        for name in ('a', 'a', 'b'):
            with timer(name):
                pass
        assert set(timer.totals()) == {'a', 'b'}
        reports.append([line.split()[0] + line.split('(')[1]
                        for line in timer.report().splitlines()])
    assert sorted(reports[0]) == sorted(reports[1]) == [
        'a2 calls)', 'b1 calls)']
    timer = StageTimer(sync=True)
    with timer('x', result={'y': torch.ones(3)}):
        pass
    assert timer.totals()['x'] >= 0.0


def test_device_sync():
    tree = {'x': torch.ones((3,)), 'y': [torch.zeros((2, 2))],
            'z': 'not-a-tensor', 'w': (np.ones(2), None)}
    assert device_sync(tree) is tree
    assert tree['z'] == 'not-a-tensor'


def test_profiler_trace(tmp_path):
    with trace(tmp_path / 'log') as prof:
        _ = torch.ones((8,)) * 2
    path = tmp_path / 'log' / 'trace.json'
    events = json.loads(path.read_text())['traceEvents']
    assert any(e.get('name') == 'aten::mul' for e in events)
    assert any(e.key == 'aten::mul' for e in prof.key_averages())


SHAPES = [dict(num_samples=640000, D=24, K=5),
          dict(num_samples=48000, D=7, K=3, wpe_taps=4, wpe_iterations=1,
               bss_iterations=5, bss_iterations_post=0),
          dict(num_samples=32000, D=4, K=3, stft_size=256, stft_shift=64,
               wpe_iterations=0, bss_iterations=2)]


@pytest.mark.parametrize('kw', SHAPES)
def test_flops_em_and_beamform_equal_jax(kw):
    got, want = flops.gss_stage_flops(**kw), jax_stage_flops(**kw)
    assert got['em'] == want['em'] and got['beamform'] == want['beamform']
    assert flops.gss_total_flops(**kw) == sum(got.values())


@pytest.mark.parametrize('kw', SHAPES)
def test_flops_wpe_and_stft_hand_count(kw):
    """Full complex Grams at every D (no lane padding: D = 7 does not
    divide 128, where the JAX model's real-form strips pad), real FFTs,
    the solve at its leading terms."""
    got = flops.gss_stage_flops(**kw)
    S = kw.get('stft_size', 1024)
    F = S // 2 + 1
    T = jax_frame_count(kw['num_samples'], S, kw.get('stft_shift', 256),
                        fading=True)
    D, iters = kw['D'], kw.get('wpe_iterations', 3)
    d = kw.get('wpe_taps', 10) * D
    assert got['wpe_stats'] == (8 * d * d * T + 8 * d * D * T) * F * iters
    assert got['wpe_tail'] == 8 * D * d * T * F * iters
    assert got['wpe_solve'] == (8 * d ** 3 // 3 + 16 * d * d * D) * F * iters
    fft = 2.5 * S * math.log2(S)
    assert got['stft'] == D * T * fft and got['istft'] == T * fft


def test_flops_p06_and_mfu():
    """P06 (T = 2628, D = 24, K = 5, d = 240): ~3.7 TFLOP an utterance,
    WPE ~2.3 and the EM ~1.4."""
    num_samples = 2628 * 256 - (1024 - 256)
    assert jax_frame_count(num_samples, 1024, 256, fading=True) == 2628
    f = flops.gss_stage_flops(num_samples=num_samples, D=24, K=5)
    wpe = f['wpe_stats'] + f['wpe_solve'] + f['wpe_tail']
    assert 2.2e12 < wpe < 2.4e12 and 1.3e12 < f['em'] < 1.45e12
    assert 3.6e12 < sum(f.values()) < 3.8e12
    achieved, share = flops.mfu(3.35e12, 0.1)
    assert achieved == pytest.approx(33.5)
    assert share == pytest.approx(33.5 / flops.H100_FP32_PEAK_TFLOPS)
    assert flops.H100_FP32_PEAK_TFLOPS == 67.0
