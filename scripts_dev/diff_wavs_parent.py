"""The WAVs of one ``enhance_session`` by this tree of the port and by
another tree of it, byte for byte.

    python scripts_dev/diff_wavs_parent.py --parent build/parent_tree
    python scripts_dev/diff_wavs_parent.py --parent build/parent_tree \
        --device cpu

On the card: ``bench.py``'s session (S02, 420 s, 25 utterances a speaker,
6 arrays x 4 mics, PCM16, seed 3; ``bench.py:202-205``) at the default
config.  On the CPU: a 24 s session of 2 arrays x 4 mics, one utterance a
speaker (seed 0), with 2 s of context and one 12 s length bucket.  The
corpus is made once; each tree runs in its own process, which imports the
port from that tree.  Prints the number of WAVs and the names of any that
differ; exits 1 if one does.
"""

import argparse
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CORPUS = {
    'cuda': dict(session_ids=('S02',), duration_seconds=420.0,
                 utterances_per_speaker=25, num_arrays=6, num_array_mics=4,
                 seed=3, pcm16=True),
    'cpu': dict(session_ids=('S02',), duration_seconds=24.0,
                utterances_per_speaker=1, num_arrays=2, num_array_mics=4,
                seed=0, pcm16=True)}
CONFIG = {'cuda': {},
          'cpu': dict(context_samples=32000, length_buckets=(192000,))}


def make_corpus(root, device):
    sys.path.insert(0, str(REPO))
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    from pb_chime5_tpu_torch.testing import create_synthetic_chime5
    create_synthetic_chime5(root / 'CHiME5', **CORPUS[device])
    dump_json(create_database(root / 'CHiME5'), root / 'chime5.json')
    return root / 'chime5.json'


def run_tree(tree, db, out, device):
    """One session through the port imported from ``tree``."""
    sys.path.insert(0, str(tree))
    import pb_chime5_tpu_torch
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    enhancer = get_enhancer(multiarray=True, database_path=str(db),
                            device=device, **CONFIG[device])
    start = time.perf_counter()
    enhancer.enhance_session(['S02'], out)
    print(f'{pb_chime5_tpu_torch.__file__}: {time.perf_counter() - start:.2f}'
          f' s', flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--parent', required=True,
                        help='another tree of the port (holds '
                             'pb_chime5_tpu_torch/)')
    parser.add_argument('--device', choices=tuple(CORPUS), default='cuda')
    parser.add_argument('--run', nargs=3, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.run:
        tree, db, out = args.run
        run_tree(Path(tree), Path(db), Path(out), args.device)
        return
    (REPO / 'build').mkdir(exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix='diff_wavs_', dir=REPO / 'build'))
    try:
        db = make_corpus(work, args.device)
        outs = {}
        for label, tree in (('parent', Path(args.parent).resolve()),
                            ('this', REPO)):
            outs[label] = work / label
            subprocess.run([sys.executable, __file__, '--parent', args.parent,
                            '--device', args.device, '--run', str(tree),
                            str(db), str(outs[label])], check=True)
        names = sorted(p.relative_to(outs['this'])
                       for p in outs['this'].rglob('*.wav'))
        parent = sorted(p.relative_to(outs['parent'])
                        for p in outs['parent'].rglob('*.wav'))
        differ = [str(n) for n in names if n not in parent or
                  (outs['this'] / n).read_bytes()
                  != (outs['parent'] / n).read_bytes()]
        print(f'{len(names)} WAVs ({len(parent)} by the parent); '
              f'byte-identical: {not differ and names == parent}; '
              f'differ: {differ}', flush=True)
        if differ or names != parent or not names:
            sys.exit(1)
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == '__main__':
    main()
