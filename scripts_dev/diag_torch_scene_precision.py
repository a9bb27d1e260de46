"""Where float32 decides the chain's output: the PyTorch port and the JAX
package on the two-speaker scene of ``tests/test_gss_pipeline.py`` (seed
0, 4 channels, 3 s) at 10 EM iterations, on the CPU.

    JAX_PLATFORMS=cpu python scripts_dev/diag_torch_scene_precision.py

Per configuration, the largest waveform difference over the peak of:

* ``jax32-jax64``: the JAX chain in float32 against itself in float64;
* ``port-jax64``: the port (float32; GEV and LCMV beamform in float64)
  against the JAX float64 chain, and ``port(bf32)-jax64`` with the port's
  beamformer kept in float32;
* ``ulp``: the port's output moved by a 1-ulp relative change of the
  input (a stand-in for any second float32 summation order, such as the
  card's), with the beamformer in float64 and in float32.

Then LCMV per frequency (the worst bins of its float32 vector: the noise
class's mask mass and the condition of its equilibrated PSD); GEV without
BAN against MVDR + BAN on the EM's posteriors moved by a small additive or
multiplicative perturbation (both beamformers in float64); and GEV with
WPE with the WPE stage in float64.  Takes ~2 minutes.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
jax.config.update('jax_enable_x64', True)

from pb_chime5_tpu.models import GssConfig as JaxGssConfig  # noqa: E402
from pb_chime5_tpu.models import gss_enhance as jax_gss_enhance  # noqa: E402
from pb_chime5_tpu_torch.models import gss  # noqa: E402
from pb_chime5_tpu_torch.ops import beamform as bf  # noqa: E402
from tests.test_gss_pipeline import activity_to_freq, make_scene  # noqa: E402

ITERATIONS = 10
CONFIGS = {
    'lcmv': dict(wpe=False, bf='lcmv'),
    'lcmv_ban': dict(wpe=False, bf='lcmv_ban'),
    'gev': dict(wpe=False, bf='gev'),
    'gev_ban': dict(wpe=False, bf='gev_ban'),
    'mvdr': dict(wpe=False),
    'gev_ban+wpe': dict(bf='gev_ban'),
    'lcmv+wpe': dict(bf='lcmv'),
    'mvdr+wpe': dict(),
    'eigh': dict(wpe=False, bss_inverse='eigh'),
    'eigh+wpe': dict(bss_inverse='eigh'),
    'cholesky+wpe': dict(bss_inverse='cholesky'),
    'wpe_options': dict(wpe_psd_context=1, wpe_chunk_size=64,
                        wpe_solve_refine=1),
}

obs, activity, _ = make_scene(np.random.default_rng(0))
act_f = activity_to_freq(activity, JaxGssConfig())
obs_ulp = (obs * (1 + 2.0 ** -23 * np.random.default_rng(1).standard_normal(
    obs.shape))).astype(np.float32)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def port(fields, x=obs, bf32=False):
    kept = gss.FLOAT64_BEAMFORMERS
    if bf32:
        gss.FLOAT64_BEAMFORMERS = ()
    try:
        cfg = gss.GssConfig(bss_iterations=ITERATIONS, **fields)
        return gss.gss_enhance(torch.from_numpy(x), torch.from_numpy(act_f),
                               0, config=cfg)[0].numpy()
    finally:
        gss.FLOAT64_BEAMFORMERS = kept


def jax_chain(fields, dtype):
    cfg = JaxGssConfig(bss_iterations=ITERATIONS, **fields)
    return np.asarray(jax_gss_enhance(
        jnp.asarray(obs.astype(dtype)), jnp.asarray(act_f, jnp.int8),
        jnp.int32(0), config=cfg)[0])


def chains():
    print(f'two-speaker scene, {ITERATIONS} EM iterations; waveform '
          f'differences over the peak')
    for name, fields in CONFIGS.items():
        j32, j64 = jax_chain(fields, np.float32), jax_chain(fields, np.float64)
        x, x32 = port(fields), port(fields, bf32=True)
        ulp = rel(port(fields, obs_ulp), x)
        ulp32 = rel(port(fields, obs_ulp, bf32=True), x32)
        print(f'{name:13s} jax32-jax64 {rel(j32, j64):.3e}  port-jax64 '
              f'{rel(x, j64):.3e}  port(bf32)-jax64 {rel(x32, j64):.3e}  '
              f'ulp {ulp:.3e} (bf32 {ulp32:.3e})', flush=True)


def lcmv_bins():
    """The LCMV vector in float32 vs float64 on the same masks, per bin."""
    cfg = gss.GssConfig(wpe=False, bss_iterations=ITERATIONS, bf='lcmv')
    Obs = gss._stft_and_mask(torch.from_numpy(obs), None, cfg)[0]
    masks = gss._em_stage(Obs, torch.from_numpy(act_f), cfg, None)
    w, covs = {}, None
    for dtype in (torch.complex64, torch.complex128):
        Y, m = Obs.to(dtype), masks.to(dtype.to_real())
        target, noise = m[:, 0], m[:, -1]
        cov = [bf.psd_matrix(Y, target),
               bf.psd_matrix(Y, m.sum(1) - target - noise),
               bf.psd_matrix(Y, noise)]
        w[dtype] = bf.lcmv_vector(*cov).to(torch.complex128)
        covs = cov
    err = ((w[torch.complex64] - w[torch.complex128]).norm(dim=-1)
           / w[torch.complex128].norm(dim=-1))
    d = torch.sqrt(torch.diagonal(covs[2], dim1=-2, dim2=-1).real)
    cond = torch.linalg.cond(covs[2] / d[:, :, None] / d[:, None, :])
    print('LCMV vector, float32 vs float64 on the same masks: median '
          f'{float(err.median()):.3e}; worst bins:')
    for f in err.argsort(descending=True)[:4].tolist():
        print(f'  f={f}: {float(err[f]):.3e}, noise-class mass '
              f'{float(masks[f, -1].sum()):.1f} of {masks.shape[-1]} frames, '
              f'condition of the equilibrated noise PSD {float(cond[f]):.2e}')
    print(f'  median condition over F: {float(cond.median()):.2e}')


def gev_posteriors():
    """GEV without BAN vs MVDR + BAN (both in float64) on the EM's
    posteriors moved by an additive or a multiplicative perturbation."""
    cfg = gss.GssConfig(wpe=False, bss_iterations=ITERATIONS)
    Obs = gss._stft_and_mask(torch.from_numpy(obs), None, cfg)[0]
    masks = gss._em_stage(Obs, torch.from_numpy(act_f), cfg, None).double()
    Y = Obs.to(torch.complex128)

    def chain(m, kind):
        target = m[:, 0]
        cov_x = bf.psd_matrix(Y, target)
        cov_n = bf.psd_matrix(Y, m.sum(1) - target)
        if kind == 'gev':
            w = bf.gev_vector(cov_x, cov_n)
        else:
            w = bf.blind_analytic_normalization(
                bf.mvdr_souden_vector(cov_x, cov_n), cov_n)
        X = bf.apply_beamforming_vector(w, Y)
        x = gss.istft(X.T, cfg.stft_size, cfg.stft_shift, fading=True,
                      num_samples=obs.shape[1]).numpy()
        return x, X, w, cov_x

    x, X, w, cov_x = chain(masks, 'gev')
    energy = (X.abs() ** 2).sum(-1)
    lam = torch.einsum('fd,fde,fe->f', w.conj(), cov_x, w).real
    top = energy.argsort(descending=True)[:3].tolist()
    print('GEV without BAN: output energy share, generalized eigenvalue:',
          ', '.join(f'f={f} {float(energy[f] / energy.sum()):.2f} '
                    f'{float(lam[f]):.2e}' for f in top))
    rng = np.random.default_rng(3)
    for label, moved in (
            ('additive 1e-7', masks + 1e-7 * torch.from_numpy(
                rng.random(masks.shape))),
            ('additive 1e-6', masks + 1e-6 * torch.from_numpy(
                rng.random(masks.shape))),
            ('multiplicative 1e-4', masks * (1 + 1e-4 * torch.from_numpy(
                rng.standard_normal(masks.shape))))):
        moved = moved / moved.sum(1, keepdim=True)
        print(f'posteriors moved, {label}: gev '
              f'{rel(chain(moved, "gev")[0], x):.3e}, mvdr+ban '
              f'{rel(chain(moved, "mvdr")[0], chain(masks, "mvdr")[0]):.3e}')


def gev_wpe_source():
    """GEV with WPE: the 1-ulp change with the WPE stage in float64."""
    wpe_stage = gss._wpe_stage

    def wpe64(Obs, config, frame_mask):
        return wpe_stage(Obs.to(torch.complex128), config,
                         frame_mask).to(Obs.dtype)
    gss._wpe_stage = wpe64
    try:
        for name in ('gev', 'gev_ban'):
            fields = dict(bf=name)
            print(f'{name}+wpe with WPE in float64: ulp '
                  f'{rel(port(fields, obs_ulp), port(fields)):.3e}')
    finally:
        gss._wpe_stage = wpe_stage


if __name__ == '__main__':
    torch.set_num_threads(4)
    chains()
    lcmv_bins()
    gev_posteriors()
    gev_wpe_source()
