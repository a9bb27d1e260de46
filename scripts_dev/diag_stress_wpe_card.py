#!/usr/bin/env python3
"""Where the port's float32 WPE leaves finite values on the stress scene
(``tests/test_torch_stress_headline.py``: D = 24, T = 4191, d = 240), on
one card.

    python scripts_dev/diag_stress_wpe_card.py [--seconds 67] [--cpu-check]

Runs the STFT and the float32 WPE by its tile route
(``wpe_stats_backend='xla'``: cuBLAS over 256-frame tiles) on the card
with the WPE solve's inputs and outputs captured (every iteration), then prints, per
iteration, the frequencies whose power weights, R, P or filter G hold a
non-finite value, and for the first bad system: its diagonal's range,
the filter by K5 (``hermitian_solve_chol``), by its plain version on the
card and by ``solve_floored`` (``cholesky_ex`` + ``cholesky_solve``),
and each one's finiteness; then R of that iteration's bad systems by
cuBLAS (the tiles), by K2 (the default route) and with float64 sums, from the same inputs:
each one's smallest eigenvalue after equilibration (against the relative
load) and its distance from the float64 sums.  ``--cpu-check`` re-solves the first bad
system's R, P on the CPU with the plain version; ``--save FILE`` keeps
that iteration's bad systems for a CPU analysis.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pb_chime5_tpu_torch.models.gss import (  # noqa: E402
    GssConfig, _stft_and_mask, _wpe_stage)
from pb_chime5_tpu_torch.ops import wpe  # noqa: E402
from pb_chime5_tpu_torch.ops.kernels import chol_solve, wpe_stats  # noqa
from pb_chime5_tpu_torch.ops.linalg import equilibrate  # noqa: E402
from tests.test_torch_stress_headline import (  # noqa: E402
    make_production_scene)


def bad_rows(x):
    """Indices of the leading axis that hold a non-finite value."""
    flat = x.reshape(x.shape[0], -1)
    return torch.nonzero(~torch.isfinite(flat).all(dim=1)).flatten() \
        .cpu().tolist()


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('--seconds', type=float, default=67.0)
    parser.add_argument('--cpu-check', action='store_true')
    parser.add_argument('--save', default=None,
                        help='a .pt file for the first bad iteration\'s '
                             'bad systems (R, P, G)')
    args = parser.parse_args()
    obs, _, _ = make_production_scene(np.random.default_rng(0),
                                      seconds=args.seconds)
    config = GssConfig(wpe_stats_backend='xla')
    O, fm, _ = _stft_and_mask(
        torch.from_numpy(obs.astype(np.float32)).cuda(), None, config)
    print(f'{torch.cuda.get_device_name(0)}; Obs {tuple(O.shape)}, '
          f'max |Obs| {O.abs().max().item():.4g}, finite '
          f'{bool(torch.isfinite(O).all())}', flush=True)

    systems, weights, stats_inputs = [], [], []
    real_solve, real_power = wpe.hermitian_solve_chol, wpe.get_power_inverse
    real_stats = wpe.wpe_statistics_reference

    def stats(Y_tilde, Y, inv_power):
        stats_inputs.append((Y_tilde.clone(), Y.clone(), inv_power.clone()))
        return real_stats(Y_tilde, Y, inv_power)

    def solve(A, B, **kw):
        G = real_solve(A, B, **kw)
        systems.append((A.clone(), B.clone(), G.clone(), kw))
        return G

    def power(*a, **kw):
        w = real_power(*a, **kw)
        weights.append(w.clone())
        return w
    wpe.hermitian_solve_chol, wpe.get_power_inverse = solve, power
    wpe.wpe_statistics_reference = stats
    try:
        Y = _wpe_stage(O, config, fm)
    finally:
        wpe.hermitian_solve_chol, wpe.get_power_inverse = real_solve, \
            real_power
        wpe.wpe_statistics_reference = real_stats
    torch.cuda.synchronize()
    print(f'WPE output finite: {bool(torch.isfinite(Y).all())}; bad '
          f'frequencies {bad_rows(Y)[:20]}', flush=True)
    first = None
    for i, ((R, P, G, kw), w) in enumerate(zip(systems, weights)):
        row = dict(iteration=i, kw=str(kw), weights_bad=bad_rows(w)[:10],
                   weights_max=w.abs().max().item(),
                   R_bad=bad_rows(R)[:10], P_bad=bad_rows(P)[:10],
                   G_bad=bad_rows(G)[:10],
                   R_diag_max=R.diagonal(dim1=-2, dim2=-1).real.max().item())
        print('iteration', json.dumps(row), flush=True)
        if first is None and row['G_bad']:
            first = (i, row['G_bad'][0], R, P, kw)
    if first is None:
        return
    i, f, R, P, kw = first
    Rf, Pf = R[f:f + 1], P[f:f + 1]
    diag = Rf.diagonal(dim1=-2, dim2=-1).real
    print(f'first bad system: iteration {i}, frequency {f}: diagonal '
          f'{diag.min().item():.4g} .. {diag.max().item():.4g}, max |P| '
          f'{Pf.abs().max().item():.4g}', flush=True)
    load = kw.get('relative_load', config.wpe_regularization)
    candidates = {
        'K5': lambda: real_solve(Rf.contiguous(), Pf.contiguous(), **kw),
        'K5 plain, card': lambda: chol_solve.hermitian_solve_chol_reference(
            Rf, Pf, **kw),
        'solve_floored': lambda: wpe.solve_floored(Rf, Pf,
                                                   relative_load=load)}
    if args.cpu_check:
        candidates['K5 plain, CPU'] = lambda: \
            chol_solve.hermitian_solve_chol_reference(
                Rf.cpu(), Pf.cpu(), **kw)
    for name, fn in candidates.items():
        G = fn()
        finite = torch.isfinite(G)
        print(f'{name}: finite {finite.sum().item()} of {G.numel()}, max '
              f'|G| {G[finite].abs().max().item() if finite.any() else 0:.4g}',
              flush=True)
    # R of the bad systems by each formulation, from the same inputs: the
    # smallest eigenvalue of the equilibrated (unit-diagonal) matrix
    # against the solve's relative load, and the distance from float64
    bad = bad_rows(systems[i][2])
    Yt, Yo, w = (x[bad] for x in stats_inputs[i])
    R64 = ((Yt.to(torch.complex128) * w[:, None, :].double())
           @ Yt.to(torch.complex128).conj().transpose(-2, -1))
    forms = {'cuBLAS (the tiles)': real_stats(Yt, Yo, w)[0],
             'K2': wpe_stats.wpe_statistics(Yt, Yo, w)[0],
             'float64 sums': R64}
    for name, Rx in forms.items():
        Rx = Rx.to(torch.complex128)
        Rx = (Rx + Rx.conj().transpose(-2, -1)) / 2
        As0 = equilibrate(Rx, Rx[..., :1])[0]
        eig = torch.linalg.eigvalsh(As0).amin(dim=-1).cpu().tolist()
        err = ((Rx - R64).norm(dim=(-2, -1)) / R64.norm(dim=(-2, -1)))
        print(f'R by {name}: smallest equilibrated eigenvalue '
              f'{[f"{e:.3e}" for e in eig]} (load {load}), relative error '
              f'{[f"{e:.2e}" for e in err.cpu().tolist()]}', flush=True)
    if args.save:
        bad = bad_rows(systems[i][2])
        torch.save({'iteration': i, 'frequencies': bad, 'kw': kw,
                    'R': R[bad].cpu(), 'P': P[bad].cpu(),
                    'G': systems[i][2][bad].cpu()}, args.save)
        print(f'saved the {len(bad)} bad systems of iteration {i} to '
              f'{args.save}', flush=True)


if __name__ == '__main__':
    main()
