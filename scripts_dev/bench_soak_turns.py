"""``testing/soak.py``'s session soak through the port's ``enhance_session``
in turns between this tree and another tree of the port, on one card,
with the time the host readers take inside it.

    python scripts_dev/bench_soak_turns.py --parent build/parent_tree
    python scripts_dev/bench_soak_turns.py --parent build/parent_tree \
        --device cpu --utterances 8        # a rehearsal on the CPU

The soak is ``run_session_soak`` at its defaults (1,000 utterances of
~0.5-0.8 s, 1 array x 4 mics, no WPE, a 2 + 1 EM, a 45 s session-audio
window, seed 11): the port's host-bound case.  One process per turn, in
the order parent, this tree, this tree, parent (``--rounds`` times), each
importing the port from its tree and building the soak's corpus anew;
each tree's libraries are built by a process of their own before the
first turn.  In each process the WAV reads (``io.audio._read``), the
WAV writes (the enhancer's ``dump_audio``) and the activity intervals
(``ArrayInterval``'s item get and set, ``intervals`` and
``normalized_intervals``) are timed, outermost calls of each thread only.
Each turn prints one JSON line (the soak's wall, utterances a second, the
mean of the windowed wall after the first window, the host readers'
calls and seconds, their share of the wall); the end prints each tree's
walls, median and range.
"""

import argparse
import contextlib
import io
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
WINDOW = 100


def instrument(spent):
    """Wrap the host readers of the imported port with timers that count
    each thread's outermost calls into ``spent`` ({key: [calls,
    seconds]})."""
    from pb_chime5_tpu_torch.io import audio
    from pb_chime5_tpu_torch.models import enhancer
    from pb_chime5_tpu_torch.utils.array_interval import ArrayInterval
    local = threading.local()

    def timed(key, fn):
        def call(*args, **kw):
            depth = getattr(local, 'depth', 0)
            local.depth = depth + 1
            start = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                local.depth = depth
                if depth == 0:
                    spent[key][0] += 1
                    spent[key][1] += time.perf_counter() - start
        return call
    audio._read = timed('reads', audio._read)
    enhancer.dump_audio = timed('writes', enhancer.dump_audio)
    for name in ('__getitem__', '__setitem__'):
        setattr(ArrayInterval, name,
                timed('intervals', getattr(ArrayInterval, name)))
    for name in ('intervals', 'normalized_intervals'):
        prop = ArrayInterval.__dict__.get(name)
        if isinstance(prop, property):
            setattr(ArrayInterval, name,
                    property(timed('intervals', prop.fget), prop.fset))


def run_turn(tree, work, label, utterances, device):
    """One process's soak (imports the port from ``tree``)."""
    sys.path.insert(0, str(tree))
    import torch
    from pb_chime5_tpu_torch.testing.soak import (
        run_session_soak, windowed_means)
    spent = {'reads': [0, 0.0], 'writes': [0, 0.0], 'intervals': [0, 0.0]}
    instrument(spent)
    if device == 'cpu':
        torch.set_num_threads(2)
    with contextlib.redirect_stdout(io.StringIO()):
        r = run_session_soak(work, num_utterances=utterances, device=device)
    steady = windowed_means(r['deltas_s'], WINDOW)[1:]
    print('TURN ' + json.dumps(dict(
        tree=label, utterances=utterances, wavs=r['num_wavs'],
        wall_s=r['wall_s'], utterances_per_s=utterances / r['wall_s'],
        steady_ms=1e3 * float(statistics.mean(steady)) if len(steady)
        else None,
        **spent, readers_share=sum(v[1] for v in spent.values())
        / r['wall_s'])), flush=True)


def build_tree(tree):
    """Build (or load) every library of the port in ``tree``."""
    sys.path.insert(0, str(tree))
    from pb_chime5_tpu_torch.ops.kernels import _build
    _build.load_libraries(_build.LIBRARIES
                          + getattr(_build, 'HOST_LIBRARIES', ()))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--parent', required=True,
                        help='another tree of the port (holds '
                             'pb_chime5_tpu_torch/)')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--utterances', type=int, default=1000)
    parser.add_argument('--device', default='cuda')
    parser.add_argument('--run', nargs=3, help=argparse.SUPPRESS)
    parser.add_argument('--build', help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.build:
        build_tree(Path(args.build))
        return
    if args.run:
        tree, work, label = args.run
        run_turn(Path(tree), Path(work), label, args.utterances,
                 args.device)
        return
    (REPO / 'build').mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix='soak_turns_', dir=REPO / 'build'))
    try:
        trees = {'parent': Path(args.parent).resolve(), 'this': REPO}
        if args.device == 'cuda':
            for tree in trees.values():
                subprocess.run([sys.executable, __file__, '--parent',
                                args.parent, '--build', str(tree)],
                               check=True)
        rows = []
        for i in range(args.rounds):
            for j, label in enumerate(('parent', 'this', 'this', 'parent')):
                proc = subprocess.run(
                    [sys.executable, __file__, '--parent', args.parent,
                     '--utterances', str(args.utterances), '--device',
                     args.device, '--run',
                     str(trees[label]), str(work / f'{i}_{j}'), label],
                    capture_output=True, text=True, check=False)
                for line in proc.stdout.splitlines():
                    if line.startswith('TURN '):
                        print(line, flush=True)
                        rows.append(json.loads(line[5:]))
                if proc.returncode:
                    sys.exit(f'{label}: rc {proc.returncode}\n'
                             f'{proc.stderr[-3000:]}')
                shutil.rmtree(work / f'{i}_{j}', ignore_errors=True)
        for label in ('parent', 'this'):
            walls = [r['wall_s'] for r in rows if r['tree'] == label]
            print(f'{label} tree: soak walls {walls} s, median '
                  f'{statistics.median(walls):.4f}, range '
                  f'{min(walls):.4f}-{max(walls):.4f}', flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == '__main__':
    main()
