"""The port's twin of ``__graft_entry__.py`` (``pb_chime5_tpu_torch/
dryrun.py``) against the JAX entry points (``tests/test_graft_entry.py``).

Tolerance: ``entry()``'s input is white noise on 8 channels for 2 s, so
its WPE solves 80 x 80 systems from 129 frames, held only by the 1e-4
load, and float32 rounding there moves the output: each package's chain
lies 1.2e-2 of the peak from the port's float64 chain, and the two
float32 chains differ by 1.8e-2 (measured on this CPU).  So the waveform
is held to 3e-2 of its peak, and the same chain without WPE, where the
two agree to 7e-7, to 1e-5.  The dry run's cached leg equals its direct
leg bit for bit, as the JAX dry run asserts.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch.dryrun import dryrun_multichip, entry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


def test_entry_matches_jax_entry():
    import jax
    sys.path.insert(0, REPO)
    try:
        import __graft_entry__
    finally:
        sys.path.remove(REPO)
    jax_fn, jax_args = __graft_entry__.entry()
    want = np.asarray(jax.jit(jax_fn)(*jax_args))

    fn, args = entry(device='cpu')
    np.testing.assert_array_equal(args[0].numpy(), np.asarray(jax_args[0]))
    np.testing.assert_array_equal(args[1].numpy(), np.asarray(jax_args[1]))
    got = fn(*args)
    assert got.dtype == torch.float32 and got.shape == want.shape
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=3e-2 * np.abs(want).max())

    from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig
    from pb_chime5_tpu.models.gss import gss_enhance as jax_gss_enhance
    from pb_chime5_tpu_torch.models.gss import GssConfig, gss_enhance
    want = np.asarray(jax.jit(lambda o, a: jax_gss_enhance(
        o, a, 0, config=JaxGssConfig(bss_iterations=5, wpe=False))[0])(
            *jax_args[:2]))
    got = gss_enhance(*args[:2], 0, config=GssConfig(
        bss_iterations=5, wpe=False))[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize('n_devices', [1, 2, 3, 4])
def test_dryrun_multichip_cpu_slots(n_devices):
    dryrun_multichip(n_devices, device='cpu')


def test_entry_points_need_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        entry()
    with pytest.raises(RuntimeError):
        dryrun_multichip(2)


@pytest.mark.slow
def test_dryrun_multichip_fresh_subprocess():
    env = {k: v for k, v in os.environ.items()
           if k not in ('JAX_PLATFORMS', 'XLA_FLAGS')}
    code = ('import sys\n'
            'from pb_chime5_tpu_torch.dryrun import dryrun_multichip\n'
            "dryrun_multichip(8, device='cpu')\n"
            "loaded = {m.split('.')[0] for m in sys.modules}\n"
            "assert not loaded & {'jax', 'pb_chime5_tpu'}, sorted(loaded)\n"
            "print('DRYRUN_OK')\n")
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert 'DRYRUN_OK' in proc.stdout
    proc = subprocess.run(
        [sys.executable, '-m', 'pb_chime5_tpu_torch.dryrun', '4',
         '--device', 'cpu'], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert 'dry run on 4 cpu slots: OK' in proc.stdout
