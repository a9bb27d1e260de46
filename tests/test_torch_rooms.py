"""The port's NumPy-only copies of the JAX package's scene generator and
quality metric (``pb_chime5_tpu_torch/testing/rooms.py``, ``metrics.py``)
against the originals: the same ``rng`` seed gives equal scenes (obs,
images, activity, spans, noise) and RIRs, bit for bit; STOI agrees to
1e-12.  Scenes are cut to 2 s here (the generator's cost is the sources'
resonator loops; the code path is the same at any length); the quality
gate's 8 s scenes run in tests/test_torch_realistic_scene.py.
"""

import numpy as np
import pytest

from pb_chime5_tpu.testing import metrics as jax_metrics
from pb_chime5_tpu.testing import rooms as jax_rooms
from pb_chime5_tpu_torch.testing import metrics, rooms


@pytest.mark.parametrize('seed,kw', [
    (0, dict()), (1, dict(num_speakers=3, num_arrays=3, mics_per_array=2,
                          rt60=0.3, noise_snr_db=10.0))])
def test_reverberant_scene_equals_jax(seed, kw):
    got = rooms.make_reverberant_scene(np.random.default_rng(seed),
                                       duration=2.0, **kw)
    want = jax_rooms.make_reverberant_scene(np.random.default_rng(seed),
                                            duration=2.0, **kw)
    assert set(got) == set(want)
    for key in ('obs', 'images', 'activity', 'noise'):
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    assert got['spans'] == want['spans'] and got['fs'] == want['fs']
    assert np.isfinite(got['obs']).all()


def test_image_source_rir_and_sources_equal_jax():
    room = np.array([5.0, 4.0, 2.8])
    src = np.array([1.5, 2.0, 1.2])
    mics = np.array([[3.0, 2.0, 1.1], [3.1, 2.0, 1.1]])
    for rng_seed in (None, 4):
        def rng():
            return None if rng_seed is None else \
                np.random.default_rng(rng_seed)
        assert np.array_equal(
            rooms.image_source_rir(room, src, mics, rt60=0.25, rng=rng()),
            jax_rooms.image_source_rir(room, src, mics, rt60=0.25,
                                       rng=rng()))
    assert np.array_equal(
        rooms.harmonic_source(np.random.default_rng(5), 0.5),
        jax_rooms.harmonic_source(np.random.default_rng(5), 0.5))
    assert np.array_equal(
        rooms.diffuse_noise(np.random.default_rng(6), mics, 0.5),
        jax_rooms.diffuse_noise(np.random.default_rng(6), mics, 0.5))


def test_stoi_equals_jax():
    scene = rooms.make_reverberant_scene(np.random.default_rng(2),
                                         duration=2.0)
    ref = scene['images'][0, 0]
    rng = np.random.default_rng(7)
    for degraded in (scene['obs'][0], ref + 0.3 * rng.standard_normal(
            ref.shape), scene['obs'][3][:-100], np.zeros_like(ref)):
        got = metrics.stoi(ref, degraded)
        want = jax_metrics.stoi(ref, degraded)
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert abs(got - want) <= 1e-12, (got, want)
    assert metrics.stoi(ref, ref) == pytest.approx(1.0, abs=1e-9)
