#!/usr/bin/env python3
"""The JAX package's float32 WPE statistics on the stress scene, on the
CPU: how far its R lies from float64 sums, and its margin above the
solve's 1e-4 load, where one float32 sum over all T failed on the card.

    JAX_PLATFORMS=cpu python scripts_dev/diag_jax_wpe_margin_cpu.py

The stress scene of tests/test_torch_stress_headline.py (seed 0, 67 s,
D = 24, T = 4191) at frequencies 12, 68 and 93 (the WPE treats each
frequency alone, so these three give the whole scene's values there).
Each package runs its own float32 WPE's first iteration; on the second
iteration's inputs this prints, per frequency, R's relative Frobenius
distance from complex128 sums of the same inputs (R hermitized) and the
smallest eigenvalue of the equilibrated R (against the 1e-4 load):

* ``jax``: the JAX default statistics (``stats_backend='auto'``, the
  real-form tap-group staircase, ``Precision.HIGHEST``);
* ``port``: the port's route on the CPU (256-frame tiles into
  complex128, ``wpe_stats_backend='xla'`` on the card);
* ``port_one_sum``: one complex64 matmul pair over all T, the port's
  route before the tiles (on the CPU, MKL's own blocking).

Imports both packages; no card.
"""

import importlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pb_chime5_tpu_torch.ops import wpe as port  # noqa: E402
from pb_chime5_tpu_torch.ops.kernels import wpe_stats  # noqa: E402
from pb_chime5_tpu_torch.ops.linalg import equilibrate  # noqa: E402
from pb_chime5_tpu_torch.ops.stft import stft  # noqa: E402
from tests.test_torch_stress_headline import (  # noqa: E402
    make_production_scene)

jax_wpe = importlib.import_module('pb_chime5_tpu.ops.wpe')
FREQUENCIES = (12, 68, 93)
TAPS, DELAY, LOAD = 10, 2, 1e-4


def readings(R, Yt, w):
    a = Yt.to(torch.complex128)
    R64 = (a * w[:, None, :].double()) @ a.conj().transpose(-2, -1)
    Rh = torch.as_tensor(R).to(torch.complex128)
    Rh = (Rh + Rh.conj().transpose(-2, -1)) / 2
    err = torch.linalg.matrix_norm(Rh - R64) / torch.linalg.matrix_norm(R64)
    eig = torch.linalg.eigvalsh(equilibrate(Rh, Rh[..., :1])[0]).amin(-1)
    eig64 = torch.linalg.eigvalsh(equilibrate(R64, R64[..., :1])[0]).amin(-1)
    return dict(distance=[float(e) for e in err],
                smallest_eigenvalue=[float(e) for e in eig],
                float64_smallest_eigenvalue=[float(e) for e in eig64],
                plus_load_positive=bool(((eig + LOAD) > 0).all()))


def main():
    jax.config.update('jax_platforms', 'cpu')
    obs, _, _ = make_production_scene(np.random.default_rng(0))
    bins = [stft(torch.from_numpy(c), 1024, 256, fading=True)
            [:, list(FREQUENCIES)] for c in obs.astype(np.float32)]
    Y = torch.stack(bins).permute(2, 0, 1).contiguous()      # (3, 24, T)
    print(f'frequencies {FREQUENCIES}: Y {tuple(Y.shape)}', flush=True)

    # JAX: its own first iteration, then its default statistics
    Yj = jnp.asarray(Y.numpy())
    X1 = jax_wpe.wpe(Yj, taps=TAPS, delay=DELAY, iterations=1)
    w = jax_wpe.get_power_inverse(X1)
    Yr, Yi = jnp.real(Yj), jnp.imag(Yj)
    groups = jax_wpe._tap_groups(TAPS, Y.shape[1])
    U = [jax_wpe._build_strip(Yr, g, DELAY) for g in groups]
    V = [jax_wpe._build_strip(Yi, g, DELAY) for g in groups]
    R, _ = jax_wpe._real_form_stats(U, V, Yr, Yi, w,
                                    jax_wpe._PRECISIONS['highest'])
    Yt = port.build_y_tilde(Y, TAPS, DELAY)
    rows = {'jax': readings(np.asarray(R), Yt,
                            torch.from_numpy(np.asarray(w)))}

    # the port on the CPU: its own first iteration, then both routes
    w = port.get_power_inverse(port.wpe(Y, taps=TAPS, delay=DELAY,
                                        iterations=1))
    rows['port'] = readings(
        wpe_stats.wpe_statistics_reference(Yt, Y, w)[0], Yt, w)
    weighted = Yt * w[:, None, :].to(Yt.dtype)
    rows['port_one_sum'] = readings(
        weighted @ Yt.conj().transpose(-2, -1), Yt, w)
    for name, row in rows.items():
        print(name, json.dumps(row), flush=True)


if __name__ == '__main__':
    main()
