"""``bench.py``'s session through the port's ``enhance_session`` in turns
between this tree and another tree of the port, on one card.

    python scripts_dev/bench_session_turns.py --parent build/parent_tree

The session (S02, 420 s, 25 utterances a speaker, 6 arrays x 4 mics,
PCM16, seed 3: ``bench.py:202-205``) is made once; then one process per
turn, in the order parent, this tree, this tree, parent (``--rounds``
times), each importing the port from its tree.  A process runs a warm-up
pass and then its passes at the default config: this tree with the
session-audio cache on, off, off, on; a tree whose ``get_enhancer`` has
no cache (before it was ported) off, off.  Each pass prints one JSON line
(wall, the sum of the chains' stage windows from ``record_stage_times``,
the share of the wall outside them, the cache's stats where it runs);
the end prints each (tree, cache) group's walls, median and range.
"""

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SESSION = dict(session_ids=('S02',), duration_seconds=420.0,
               utterances_per_speaker=25, num_arrays=6, num_array_mics=4,
               seed=3, pcm16=True)


def make_corpus(root):
    sys.path.insert(0, str(REPO))
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    from pb_chime5_tpu_torch.testing import create_synthetic_chime5
    create_synthetic_chime5(root / 'CHiME5', **SESSION)
    dump_json(create_database(root / 'CHiME5'), root / 'chime5.json')
    return root / 'chime5.json'


def run_passes(tree, db, out, label):
    """One process's passes (imports the port from ``tree``)."""
    sys.path.insert(0, str(tree))
    import inspect
    import torch
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    kw = dict(multiarray=True, database_path=str(db), device='cuda')
    cached = inspect.signature(get_enhancer).parameters[
        'device_audio_cache'].default is True
    modes = ('on', 'off', 'off', 'on') if cached else ('off', 'off')
    enhancers = {'off': get_enhancer(**{**kw, 'device_audio_cache': False})}
    if cached:
        enhancers['on'] = get_enhancer(**kw)
    n = len(list(enhancers['off'].get_iterator('S02')))

    def one_pass(mode, name):
        enhancer = enhancers[mode]
        cache = getattr(enhancer, '_audio_cache', None)
        before = dict(cache.stats) if cache is not None else None
        torch.cuda.synchronize()
        with gss.record_stage_times() as times:
            start = time.perf_counter()
            enhancer.enhance_session(['S02'], out / name,
                                     audio_dir_exist_ok=True)
            wall = time.perf_counter() - start
        chain_s = sum(sum(t.values()) for t in times) / 1e3
        row = dict(tree=label, cache=mode, utterances=n, wall_s=wall,
                   chain_s=chain_s, outside_chains=1 - chain_s / wall)
        if cache is not None:
            row['stats'] = {k: v - before[k] for k, v in cache.stats.items()}
        return row

    one_pass(modes[0], 'warm')
    for i, mode in enumerate(modes):
        print('PASS ' + json.dumps(one_pass(mode, f'{label}_{i}')),
              flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--parent', required=True,
                        help='another tree of the port (holds '
                             'pb_chime5_tpu_torch/)')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--run', nargs=4, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.run:
        tree, db, out, label = args.run
        run_passes(Path(tree), Path(db), Path(out), label)
        return
    (REPO / 'build').mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix='session_turns_', dir=REPO / 'build'))
    try:
        start = time.perf_counter()
        db = make_corpus(work)
        print(f'session corpus: {time.perf_counter() - start:.2f} s',
              flush=True)
        trees = {'parent': Path(args.parent).resolve(), 'this': REPO}
        rows = []
        for _ in range(args.rounds):
            for label in ('parent', 'this', 'this', 'parent'):
                proc = subprocess.run(
                    [sys.executable, __file__, '--parent', args.parent,
                     '--run', str(trees[label]), str(db), str(work / 'out'),
                     label], capture_output=True, text=True, check=False)
                for line in proc.stdout.splitlines():
                    if line.startswith('PASS '):
                        print(line, flush=True)
                        rows.append(json.loads(line[5:]))
                if proc.returncode:
                    sys.exit(f'{label}: rc {proc.returncode}\n'
                             f'{proc.stderr[-3000:]}')
        groups = {}
        for row in rows:
            groups.setdefault((row['tree'], row['cache']), []).append(row)
        for (label, mode), group in sorted(groups.items()):
            walls = [r['wall_s'] for r in group]
            outside = [r['outside_chains'] for r in group]
            print(f'{label} tree, cache {mode}: walls {walls} s, median '
                  f'{statistics.median(walls):.4f}, range '
                  f'{min(walls):.4f}-{max(walls):.4f}; outside the chains '
                  f'{min(outside):.4f}-{max(outside):.4f}', flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == '__main__':
    main()
