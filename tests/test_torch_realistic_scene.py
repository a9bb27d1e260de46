"""Full-chain quality of the port on the realistic reverberant scenes — the
twin of tests/test_realistic_scene.py through the port's ``gss_enhance``
on the CPU (the kernels' plain versions): the same scenes (the port's
copy of ``testing/rooms.py``, seeds 0, 1, 2), the same chain (WPE +
cacGMM at 10 EM iterations + MVDR-Souden with BAN, postfilter None and
'mask_mul') and the same pins, as medians over the three seeds:

  * every run finite and non-silent,
  * median SIR gain bf-only > 1.5 dB and mask_mul > 10 dB,
  * median mask_mul STOI in the two-talker overlap > 0.5,
  * median (mask_mul - raw) STOI in the overlap > 0.02,
  * median (mask_mul - bf) STOI over the target span > -0.05.

The EM is trajectory-chaotic on these scenes (single seeds swing by
several dB under rounding-level changes), which is why the pins are
medians (the JAX test's docstring has the measured distributions).
``chip_smoke.py`` holds the port to the same pins on the card.
"""

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch.models.gss import GssConfig, gss_enhance
from pb_chime5_tpu_torch.testing.metrics import stoi
from pb_chime5_tpu_torch.testing.rooms import make_reverberant_scene
from pb_chime5_tpu_torch.utils import activity_time_to_frequency

pytestmark = pytest.mark.slow

FS = 16000
SEEDS = (0, 1, 2)
SCENE = dict(num_speakers=2, duration=8.0, rt60=0.45, noise_snr_db=20.0)
# each median over SEEDS must exceed its pin
PINS = {'sir_bf_db': 1.5, 'sir_mm_db': 10.0, 'stoi_mm_ovl': 0.5,
        'stoi_mm_minus_raw_ovl': 0.02, 'stoi_mm_minus_bf_span': -0.05}


def make_scene(seed):
    return make_reverberant_scene(np.random.default_rng(seed), **SCENE)


def _sir_db(x, only_target, only_interf):
    e_t = float(np.mean(x[only_target] ** 2))
    e_i = float(np.mean(x[only_interf] ** 2))
    return float(10.0 * np.log10(e_t / max(e_i, 1e-30)))


def chain_quality(scene, device='cpu', **config):
    """The chain on ``device`` at ``GssConfig(**config)`` for postfilter
    None ('bf') and 'mask_mul' ('mm'): SIR gains in dB over raw ch0
    (``sir_bf_db``, ``sir_mm_db``) and STOI ``{raw,bf,mm}_{span,ovl}``
    against the target's reverberant image at mic 0, over the target span
    and the two-talker overlap.  Every run must be finite and
    non-silent."""
    obs = scene['obs'].astype(np.float32)
    (a0, a1), (b0, b1) = scene['spans']
    N = obs.shape[1]
    only0 = np.zeros(N, bool)
    only0[a0:max(0, b0 - 1000)] = True
    only1 = np.zeros(N, bool)
    only1[a1:b1] = True
    assert only0.sum() > FS and only1.sum() > FS
    ref = scene['images'][0, 0]
    span = slice(a0, a1)
    lo, hi = max(a0, b0), min(a1, b1)
    assert hi - lo > FS, hi - lo
    ovl = slice(lo, hi)

    sir_raw = _sir_db(obs[0], only0, only1)
    out = {'raw_span': stoi(ref[span], obs[0][span]),
           'raw_ovl': stoi(ref[ovl], obs[0][ovl])}
    for tag, postfilter in (('bf', None), ('mm', 'mask_mul')):
        cfg = GssConfig(postfilter=postfilter, **config)
        act_f = activity_time_to_frequency(
            scene['activity'], cfg.stft_size, cfg.stft_shift,
            stft_fading=cfg.stft_fading, stft_pad=True).astype(np.int8)
        x_hat, _ = gss_enhance(torch.from_numpy(obs).to(device),
                               torch.from_numpy(act_f).to(device), 0,
                               config=cfg)
        x_hat = x_hat.cpu().numpy()
        assert np.isfinite(x_hat).all(), postfilter
        assert np.abs(x_hat).max() > 0, postfilter
        out[f'sir_{tag}_db'] = _sir_db(x_hat, only0, only1) - sir_raw
        out[f'{tag}_span'] = stoi(ref[span], x_hat[span])
        out[f'{tag}_ovl'] = stoi(ref[ovl], x_hat[ovl])
    return out


def medians(per_seed):
    """{seed: chain_quality(...)} -> the medians of PINS' quantities."""
    def med(fn):
        return float(np.median([fn(q) for q in per_seed.values()]))
    return {'sir_bf_db': med(lambda q: q['sir_bf_db']),
            'sir_mm_db': med(lambda q: q['sir_mm_db']),
            'stoi_mm_ovl': med(lambda q: q['mm_ovl']),
            'stoi_mm_minus_raw_ovl': med(lambda q: q['mm_ovl'] - q['raw_ovl']),
            'stoi_mm_minus_bf_span': med(
                lambda q: q['mm_span'] - q['bf_span'])}


@pytest.fixture(scope='module')
def results():
    torch.set_num_threads(4)
    per_seed = {seed: chain_quality(make_scene(seed), bss_iterations=10)
                for seed in SEEDS}
    print(f'\nport, realistic scenes {SEEDS} on the CPU: {per_seed}; '
          f'medians {medians(per_seed)}')
    return per_seed


@pytest.mark.parametrize('names', [('sir_bf_db', 'sir_mm_db'), (
    'stoi_mm_ovl', 'stoi_mm_minus_raw_ovl', 'stoi_mm_minus_bf_span')],
    ids=['sir', 'stoi'])
def test_quality_on_reverberant_harmonic_scenes(results, names):
    med = medians(results)
    for name in names:
        assert med[name] > PINS[name], (name, med, results)
