"""Card vs CPU on ``chip_smoke.py``'s small two-speaker scene at 10 EM
iterations, per option, with and without WPE, and with the GEV / LCMV
beamformer in float64 (as the port runs it) and in float32.

    python scripts_dev/diag_torch_scene_card.py    # needs one CUDA card

Prints, per line, the largest waveform difference between the card and
the CPU path (the kernels' plain versions) over the CPU's peak, and the
card output's SIR gain.  Imports the port only, never JAX.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from pb_chime5_tpu_torch.models import gss  # noqa: E402
from pb_chime5_tpu_torch.utils import activity_time_to_frequency  # noqa: E402

ITERATIONS = 10
OPTIONS = {
    'mvdr': {}, 'gev': dict(bf='gev'), 'gev_ban': dict(bf='gev_ban'),
    'lcmv': dict(bf='lcmv'), 'lcmv_ban': dict(bf='lcmv_ban'),
    'ch2': dict(bf='ch2'), 'sum': dict(bf='sum'),
    'wpe_options': dict(wpe_psd_context=1, wpe_chunk_size=512,
                        wpe_solve_refine=1),
    'cholesky': dict(bss_inverse='cholesky'), 'eigh': dict(bss_inverse='eigh'),
}


def main():
    if not torch.cuda.is_available():
        sys.exit('diag_torch_scene_card: needs a CUDA card')
    obs, activity, (b0, b1) = chip_smoke.small_scene()
    act = torch.from_numpy(activity_time_to_frequency(
        activity, 1024, 256, stft_fading=True, stft_pad=True))
    kept = gss.FLOAT64_BEAMFORMERS
    for wpe in (False, True):
        for name, fields in OPTIONS.items():
            for bf64 in ((True, False) if fields.get('bf') in kept
                         else (True,)):
                gss.FLOAT64_BEAMFORMERS = kept if bf64 else ()
                cfg = gss.GssConfig(bss_iterations=ITERATIONS, wpe=wpe,
                                    **fields)
                x = {dev: gss.gss_enhance(
                    torch.from_numpy(obs).to(dev), act.to(dev), 0,
                    config=cfg)[0].cpu().numpy() for dev in ('cuda', 'cpu')}
                err = (np.abs(x['cuda'] - x['cpu']).max()
                       / np.abs(x['cpu']).max())
                gain = chip_smoke.sir_gain(obs, x['cuda'], b0, b1)
                label = '' if bf64 else ' (beamformer in float32)'
                print(f'{ITERATIONS} iterations, wpe={wpe}, {name}{label}: '
                      f'card vs CPU {err:.3e} of the peak, SIR gain '
                      f'{gain:.1f}x', flush=True)
    gss.FLOAT64_BEAMFORMERS = kept


if __name__ == '__main__':
    main()
