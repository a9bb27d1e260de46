"""The port's session soak (``testing/soak.py``) against the JAX package's.

The two slow twins of ``tests/test_session_soak.py`` drive the port's
``enhance_session`` on the CPU over a 1,000-utterance session (serial)
and a 400-utterance one (a mesh of 8 CPU slots), with that file's bounds
on windowed flatness, RSS growth after the first window and the cache's
refills and hits (its docstring gives the measured envelope they were set
from).  On the card, ``chip_smoke.py`` phase 13 holds the same gates.

The tier-1 test runs 40 utterances through both packages' soaks at the
same seed: the return dict has the JAX keys, every utterance is written,
and the WAVs agree to 2e-2 of full scale (the CLI-vs-JAX tolerance of
``tests/test_torch_enhancer.py``: the same float32 math in another
summation order; 2 EM iterations here).
"""

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from pb_chime5_tpu.io import load_audio
from pb_chime5_tpu.testing.soak import run_session_soak as jax_soak
from pb_chime5_tpu_torch.testing.soak import (
    read_rss_mb, run_session_soak, windowed_means)

torch.set_num_threads(2)

WINDOW = 100


@pytest.fixture
def work():
    base = '/dev/shm' if Path('/dev/shm').is_dir() else None
    d = Path(tempfile.mkdtemp(prefix='soak_test_', dir=base))
    yield d
    shutil.rmtree(d, ignore_errors=True)


def test_session_soak_40_matches_jax(work):
    n = 40
    r = run_session_soak(work / 'port', num_utterances=n, device='cpu',
                         rss_every=10)
    want = jax_soak(work / 'jax', num_utterances=n, rss_every=10)
    assert set(want) <= set(r)
    assert r['num_examples'] == r['num_wavs'] == n
    assert len(r['deltas_s']) == n and np.all(r['deltas_s'] >= 0)
    assert [i for i, _ in r['rss_mb']] == [i for i, _ in want['rss_mb']]
    assert r['device_mb'] == []              # no card
    assert r['span_s'] == want['span_s']
    assert r['cache']['direct'] == 0 and r['cache']['refills'] >= 1
    assert r['cache']['hits'] + r['cache']['refills'] == n
    wavs = sorted((work / 'port' / 'out').rglob('*.wav'))
    assert [w.name for w in wavs] == sorted(
        w.name for w in (work / 'jax' / 'out').rglob('*.wav'))
    for wav in wavs:
        got = load_audio(wav)
        ref = load_audio(work / 'jax' / 'out' / wav.parent.name / wav.name)
        assert got.shape == ref.shape and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, atol=2e-2)


def test_windowed_means_and_rss():
    np.testing.assert_array_equal(windowed_means(np.arange(7.0), 3),
                                  [1.0, 4.0])
    assert read_rss_mb() > 0


def test_soak_needs_card_unless_asked(work):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        run_session_soak(work, num_utterances=4)


@pytest.mark.slow
def test_serial_session_soak_1000_utterances(work):
    n = 1000
    r = run_session_soak(work, num_utterances=n, device='cpu')
    assert r['num_examples'] == n
    assert r['num_wavs'] == n

    wm = windowed_means(r['deltas_s'], WINDOW)
    steady = wm[1:]                    # window 0 pays the first calls
    assert steady[-1] / steady[0] < 1.6, wm
    assert steady.max() / steady.min() < 2.0, wm

    after_warm = [m for i, m in r['rss_mb'] if i >= WINDOW]
    assert after_warm[-1] - after_warm[0] < 120.0, r['rss_mb']

    assert r['cache']['refills'] >= 5, r['cache']
    assert r['cache']['hits'] > 0.9 * n, r['cache']


@pytest.mark.slow
def test_mesh_session_soak(work):
    from pb_chime5_tpu_torch.parallel import make_mesh

    n = 400
    mesh = make_mesh(data=8, freq=1, devices=[torch.device('cpu')] * 8)
    r = run_session_soak(work, num_utterances=n, mesh=mesh, device='cpu')
    assert r['num_examples'] == n
    assert r['num_wavs'] == n

    wm = windowed_means(r['deltas_s'], WINDOW)
    assert wm[1:].max() / wm[1:].min() < 3.0, wm

    after_warm = [m for i, m in r['rss_mb'] if i >= WINDOW]
    assert after_warm[-1] - after_warm[0] < 450.0, r['rss_mb']

    assert r['cache']['hits'] > 0.9 * n, r['cache']


NO_JAX = '''
import sys, tempfile
from pathlib import Path
from pb_chime5_tpu_torch.dryrun import dryrun_multichip, entry
from pb_chime5_tpu_torch.testing.soak import run_session_soak
dryrun_multichip(2, device='cpu')
r = run_session_soak(Path(tempfile.mkdtemp()), num_utterances=4,
                     device='cpu')
assert r['num_wavs'] == 4, r
loaded = {name.split('.')[0] for name in sys.modules}
assert not loaded & {'jax', 'pb_chime5_tpu'}, sorted(loaded)
print('NO_JAX_OK')
'''


def test_soak_and_dryrun_import_no_jax():
    proc = subprocess.run([sys.executable, '-c', NO_JAX], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert 'NO_JAX_OK' in proc.stdout
