"""K5's library call on the card: ``torch.linalg.cholesky_ex`` +
``torch.cholesky_solve`` on the equilibrated WPE systems, the
``library_ms`` of K5's row in ``chip_smoke.py``, timed in turns with each
of PyTorch's linear-algebra backends preferred (``default``,
``cusolver``, ``magma``), beside the kernel ``hermitian_solve_chol`` on
the same systems, over several rounds.

    python scripts_dev/diag_k5_library_card.py [--rounds 3]

Shapes: the headline (513 HPD systems of 240 x 240, 24 right-hand
sides, ``chip_smoke.py``'s inputs, load 1e-4) and the RTTM path's WPE
solve (513 of 120 x 120, 12 right-hand sides).  The real block form of
each shape (480 x 480 real at the headline) is timed beside them.  Also printed: the
first call of each backend (its handles and workspaces made then), and
whether each backend's solve agrees with the default one.

Needs one CUDA card; imports the port only, never JAX.
"""

import argparse
import statistics
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from pb_chime5_tpu_torch.ops import linalg  # noqa: E402
from pb_chime5_tpu_torch.ops.kernels import chol_solve  # noqa: E402
from tests.test_torch_kernels_cuda import hpd_system  # noqa: E402

BACKENDS = ('default', 'cusolver', 'magma')


def library(As, Bs):
    L, _ = torch.linalg.cholesky_ex(As)
    return torch.cholesky_solve(Bs, L)


def real_block(A, B):
    """[[Re, -Im], [Im, Re]] of each system and [Re; Im] of its
    right-hand sides: the real form of the same solve."""
    top = torch.cat([A.real, -A.imag], -1)
    bottom = torch.cat([A.imag, A.real], -1)
    return (torch.cat([top, bottom], -2).contiguous(),
            torch.cat([B.real, B.imag], -2).contiguous())


def timed(fn, backend, reps):
    torch.backends.cuda.preferred_linalg_library(backend)
    return chip_smoke.cuda_ms(torch, fn, reps)


def shape_times(label, F, D, E, rounds):
    A, B = hpd_system(F, D, E, seed=14, device='cuda')
    _, As, Bs, _ = linalg.equilibrate(A, B, chip_smoke.WPE_LOAD)
    Ar, Br = real_block(As, Bs)
    first, backends = {}, []
    for backend in BACKENDS:
        torch.backends.cuda.preferred_linalg_library(backend)
        torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            X = library(As, Bs)
            torch.cuda.synchronize()
        except RuntimeError as error:
            print(f'{label}: {backend} unavailable: {error}', flush=True)
            continue
        backends.append(backend)
        first[backend] = (time.perf_counter() - start) * 1e3
        if backend == 'default':
            X_default = X
        rel = float((torch.linalg.matrix_norm(X - X_default)
                     / torch.linalg.matrix_norm(X_default)).max())
        print(f'{label}: {backend} first call {first[backend]:.3f} ms '
              f'(wall), vs default {rel:.3e}', flush=True)
    fns = {f'complex {b}': (lambda b=b: timed(
               lambda: library(As, Bs), b, 3)) for b in backends}
    fns.update({f'real {b}': (lambda b=b: timed(
        lambda: library(Ar, Br), b, 3)) for b in backends})
    fns['kernel'] = lambda: timed(lambda: chol_solve.hermitian_solve_chol(
        A, B, relative_load=chip_smoke.WPE_LOAD), 'default', 10)
    times = {name: [] for name in fns}
    for _ in range(rounds):
        for name in list(fns) + list(fns)[::-1]:
            times[name].append(fns[name]())
    torch.backends.cuda.preferred_linalg_library('default')
    for name, v in times.items():
        print(f'{label} at F, d, E = ({F}, {D}, {E}): {name} median '
              f'{statistics.median(v):.4f} ms, min {min(v):.4f}, max '
              f'{max(v):.4f} ({len(v)} windows)', flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--rounds', type=int, default=3)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA card')
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    shape_times('headline', chip_smoke.HEADLINE[0],
                chip_smoke.WPE_TAPS * chip_smoke.HEADLINE[2],
                chip_smoke.HEADLINE[2], args.rounds)
    shape_times('RTTM path', chip_smoke.HEADLINE[0],
                chip_smoke.WPE_TAPS * 12, 12, args.rounds)


if __name__ == '__main__':
    main()
