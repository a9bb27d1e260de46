"""A stub Kaldi installation and a fake alignment directory, for the
Kaldi bridge's tests and smoke runs without Kaldi.

:func:`make_fake_kaldi_root` writes executables that speak the real
tools' protocol (argv conventions including Kaldi's ``ark:cmd |`` pipe
rspecifiers; the ``Done N utterances`` / ``Converted N alignments``
stderr lines the bridge cross-checks): ``ali-to-phones`` (transition id i
-> phone (i - 1) // 6 + 1), ``ali-to-pdf`` (pdf (i - 1) // 3), the
lattice sweep (``lattice-scale``, ``lattice-add-penalty``,
``lattice-best-path``: the acoustic arm of a ``<ac> | <lm>`` text lattice
up to an LM weight of 10, the LM arm above), ``int2sym.pl`` and a
``compute-wer`` that computes the edit distance.  Set ``KALDI_ROOT`` to
the directory it returns.

:func:`write_fake_alignment` writes what ``activity_alignment``'s CLI
reads from ``--worn-ali-path`` for a corpus's worn utterances:
``phones.txt``, ``final.mdl`` and ``ali.1.gz``, silence over the first
and last ``edge`` of each utterance's 10 ms frames and a speech phone
between.
"""

import gzip
import stat
import textwrap
from pathlib import Path

__all__ = ['make_fake_kaldi_root', 'write_fake_alignment', 'kaldi_frames']

_READ_RSPEC = '''
def read_rspecifier(src):
    import subprocess
    assert src.startswith('ark:'), src
    inner = src[4:]
    if inner.rstrip().endswith('|'):
        return subprocess.run(inner.rstrip()[:-1], shell=True, text=True,
                              capture_output=True, check=True).stdout
    return open(inner).read()
'''

_TOOLS = {
    'src/bin/ali-to-phones': '''
        args = sys.argv[1:]
        per_frame = '--per-frame' in args
        args = [a for a in args if not a.startswith('--')]
        model, src, out = args
        assert out == 'ark,t:-', out
        open(model)   # the model file must exist, like the real tool
        n = 0
        for line in read_rspecifier(src).splitlines():
            parts = line.split()
            if not parts:
                continue
            ids = [int(x) for x in parts[1:]]
            phones = [(i - 1) // 6 + 1 for i in ids]
            if not per_frame:
                phones = [p for j, p in enumerate(phones)
                          if j == 0 or p != phones[j - 1]]
            print(parts[0], *phones)
            n += 1
        print(f'LOG (ali-to-phones) Done {n} utterances.', file=sys.stderr)
    ''',
    'src/bin/ali-to-pdf': '''
        model, src, out = sys.argv[1:]
        assert out == 'ark,t:-', out
        open(model)
        n = 0
        for line in read_rspecifier(src).splitlines():
            parts = line.split()
            if not parts:
                continue
            print(parts[0], *[(int(x) - 1) // 3 for x in parts[1:]])
            n += 1
        print(f'LOG (ali-to-pdf) Converted {n} alignments.', file=sys.stderr)
    ''',
    'src/latbin/lattice-scale': '''
        scale = [a for a in sys.argv[1:]
                 if a.startswith('--inv-acoustic-scale=')][0]
        lmwt = int(scale.split('=')[1])
        srcs = [a for a in sys.argv[1:] if a.startswith('ark:')]
        for line in read_rspecifier(srcs[0]).splitlines():
            if line.strip():
                print(lmwt, line)
    ''',
    'src/latbin/lattice-add-penalty': '''
        sys.stdout.write(sys.stdin.read())
    ''',
    'src/latbin/lattice-best-path': '''
        out = [a for a in sys.argv[1:] if a.startswith('ark,t:')][0][6:]
        with open(out, 'w') as fd:
            for line in sys.stdin.read().splitlines():
                parts = line.split()
                if not parts:
                    continue
                lmwt, utt = int(parts[0]), parts[1]
                rest = ' '.join(parts[2:])
                ac, lm = [arm.split() for arm in rest.split('|')]
                print(utt, *(ac if lmwt <= 10 else lm), file=fd)
        print('LOG lattice-best-path done.', file=sys.stderr)
    ''',
    'egs/wsj/s5/utils/int2sym.pl': '''
        assert sys.argv[1] == '-f' and sys.argv[2] == '2-', sys.argv
        sym = {}
        for line in open(sys.argv[3]):
            word, idx = line.split()
            sym[idx] = word
        for line in sys.stdin:
            parts = line.split()
            if parts:
                print(parts[0], *[sym[i] for i in parts[1:]])
    ''',
    'src/bin/compute-wer': '''
        ref_spec = [a for a in sys.argv[1:] if a.startswith('ark:')][0]
        ref = {}
        for line in open(ref_spec[4:]):
            parts = line.split()
            if parts:
                ref[parts[0]] = parts[1:]
        ins = dl = sub = words = 0
        for line in sys.stdin:
            parts = line.split()
            if not parts:
                continue
            r, h = ref.get(parts[0], []), parts[1:]
            words += len(r)
            # Levenshtein with op counts: (cost, ins, del, sub)
            prev = [(j, j, 0, 0) for j in range(len(h) + 1)]
            for i in range(1, len(r) + 1):
                cur = [(i, 0, i, 0)]
                for j in range(1, len(h) + 1):
                    miss = r[i - 1] != h[j - 1]
                    cur.append(min(
                        (prev[j][0] + 1, prev[j][1], prev[j][2] + 1,
                         prev[j][3]),
                        (cur[j - 1][0] + 1, cur[j - 1][1] + 1,
                         cur[j - 1][2], cur[j - 1][3]),
                        (prev[j - 1][0] + miss, prev[j - 1][1],
                         prev[j - 1][2], prev[j - 1][3] + miss)))
                prev = cur
            _, i_, d_, s_ = prev[len(h)]
            ins += i_
            dl += d_
            sub += s_
        errors = ins + dl + sub
        wer = 100.0 * errors / max(words, 1)
        print(f'%WER {wer:.2f} [ {errors} / {words}, {ins} ins, '
              f'{dl} del, {sub} sub ]')
    ''',
}


def make_fake_kaldi_root(root):
    """Write the stub tools under ``root``; returns it as a Path."""
    root = Path(root)
    (root / 'egs/wsj/s5/utils').mkdir(parents=True, exist_ok=True)
    (root / 'tools/openfst/lib').mkdir(parents=True, exist_ok=True)
    for rel, body in _TOOLS.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text('#!/usr/bin/env python3\nimport sys\n'
                        + _READ_RSPEC + textwrap.dedent(body))
        path.chmod(path.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP)
    return root


def kaldi_frames(num_samples):
    """Kaldi's 10 ms feature frames (window 400, shift 160, no padding)
    of ``num_samples``."""
    return (num_samples - 400 + 160) // 160


def write_fake_alignment(ali_dir, examples, *, edge=0.1,
                         location='KITCHEN', channel='L'):
    """A Kaldi alignment directory for ``examples`` (database example
    dicts with their ``example_id``) on their speakers' worn mics:
    ``sil`` (phone 1) over the first and last ``edge`` of the frames,
    ``ae_B`` (phone 2) between.  Returns {Kaldi id: phone ids}."""
    ali_dir = Path(ali_dir)
    ali_dir.mkdir(parents=True, exist_ok=True)
    (ali_dir / 'phones.txt').write_text('<eps> 0\nsil 1\nae_B 2\n')
    (ali_dir / 'final.mdl').write_text('fake model\n')
    phones = {}
    for ex in examples:
        speaker, session, times = ex['example_id'].split('_')
        start, end = times.split('-')
        kaldi_id = f'{speaker}_{session}_{location}.{channel}-{start}-{end}'
        T = kaldi_frames(ex['num_samples']['worn'][speaker])
        sil = int(round(edge * T))
        phones[kaldi_id] = [1] * sil + [2] * (T - 2 * sil) + [1] * sil
    with gzip.open(ali_dir / 'ali.1.gz', 'wt') as fd:
        for kaldi_id, ids in phones.items():
            # transition ids: ali-to-phones maps i -> (i - 1) // 6 + 1
            fd.write(' '.join([kaldi_id] + [str((p - 1) * 6 + 1)
                                            for p in ids]) + '\n')
    return phones
