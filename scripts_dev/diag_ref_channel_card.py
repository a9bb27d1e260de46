"""The MVDR reference channel of a benchmark cell's utterances by each
WPE statistics route, against the harness's float64 reference chain (one
card; ``--device cpu`` runs the tiles on both routes):

    python scripts_dev/diag_ref_channel_card.py --workload <cell> \
        --seeds <n> [<n> ...] [--min-seconds 3] [--limit N] \
        [--stop-after S] [--wpe64]

For each seed the cell's session is made as ``gss_bench`` makes it, and
each of its utterances of at least ``--min-seconds`` (the first
``--limit`` by id) is enhanced by the port twice, with the WPE statistics
by K2 (the default ``GssConfig``) and by the tiles
(``wpe_stats_backend='xla'``).  One JSON line an utterance: the float64
reference's channel and its margin over the runner-up (the relative gap
of their frequency-summed SNRs), and for each route its channel, margin,
error against the float64 reference's output (``gss_bench.check``'s
measure, on the output rounded to PCM16 as the WAV holds it) and
``snr_err``, the largest relative error of its 24 SNRs against the
float64 reference's.  Where a route's error passes the cell's
``err_second_stable`` limit, and on the cell's sample (below),
``sensitivity`` is the float32 reference's error, as ``gss_bench.check``
reads it (the utterance is stable at or under ``correct.stable_below``).
Both chains' SNRs are read where they pick the channel: the port's
``beamform.reference_channel`` and the reference's one ``torch.argmax``.
``--wpe64`` adds each route's WPE output against the port's own WPE in
complex128 on the same STFT (median and largest relative error per
frequency).  No seed is started after ``--stop-after`` seconds.
Without ``--limit``, and with ``--min-seconds`` at most the cell's
``correct.min_seconds``, one line a seed reads ``gss_bench.check``'s
numbers and verdict for each route on the sample the cell draws from
that seed, all of the session written (a session cell's window writes it
whole).  The last line counts, per route, the utterances whose channel
is not the float64 reference's (``flips``), whose error passes the limit
(``over``), those of them that are stable (``stable_over``, what
``err_second_stable`` counts) and the seeds whose sample fails
(``incorrect_seeds``).  Imports ``gss_bench`` and the port, never JAX.
"""
import argparse
import dataclasses
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from gss_bench import check, corpus, reference, run  # noqa: E402
from gss_bench.reference import chain  # noqa: E402
from pb_chime5_tpu_torch.database.create_json import create_database  # noqa
from pb_chime5_tpu_torch.io import dump_json  # noqa: E402
from pb_chime5_tpu_torch.models import gss  # noqa: E402
from pb_chime5_tpu_torch.models.enhancer import get_enhancer  # noqa: E402
from pb_chime5_tpu_torch.ops import beamform  # noqa: E402


class _ArgmaxSeen:
    """``torch`` as ``gss_bench.reference.chain`` sees it, but each
    ``argmax`` keeps its input: the chain's one argmax picks the MVDR
    reference channel from the frequency-summed SNRs."""

    def __init__(self):
        self.seen = []

    def __getattr__(self, name):
        return getattr(torch, name)

    def argmax(self, x, *args, **kwargs):
        self.seen.append(x.detach().clone())
        return torch.argmax(x, *args, **kwargs)


def top2(ratio):
    """(channel, relative margin over the runner-up) of an SNR ratio."""
    top = torch.topk(ratio, 2)
    return int(top.indices[0]), float((top.values[0] - top.values[1])
                                      / top.values[0])


def main():
    p = argparse.ArgumentParser()
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--min-seconds', type=float, default=3.0)
    p.add_argument('--limit', type=int, default=None)
    p.add_argument('--stop-after', type=float, default=None)
    p.add_argument('--wpe64', action='store_true')
    p.add_argument('--device', default='cuda')
    args = p.parse_args()
    started = time.perf_counter()
    bench = run._load_json(REPO / 'BENCHMARK.json')
    cell, config, traffic = run.load_cell(bench, args.workload)
    correct = config['correct']
    limit = correct['limits']['err_second_stable']
    stable_below = correct['stable_below']
    whole = args.limit is None and args.min_seconds <= correct['min_seconds']

    def sync():
        if args.device.startswith('cuda'):
            torch.cuda.synchronize()

    port_snrs, wpe_io = [], []
    real_ref = beamform.reference_channel

    def ref_channel(num, den, eps):
        port_snrs.append(num / torch.clamp_min(den, eps))
        return real_ref(num, den, eps)
    beamform.reference_channel = ref_channel
    ref_snrs = _ArgmaxSeen()
    chain.torch = ref_snrs
    real_wpe = gss._wpe_stage

    def wpe_stage(O, config, fm):
        out = real_wpe(O, config, fm)
        if args.wpe64:
            wpe_io.append((O.detach().clone(), fm, out.detach().clone()))
        return out
    gss._wpe_stage = wpe_stage

    def ref_in(utt, name):
        t = time.perf_counter()
        out = check.normalized(reference.enhance_utterance(
            utt, intervals, config, reference.Precision(name), args.device))
        return out, time.perf_counter() - t

    totals = {label: dict(flips=0, over=0, stable_over=0, utterances=0,
                          incorrect_seeds=0)
              for label in ('k2', 'tiles')}
    seed_seconds = 0.0
    for seed in args.seeds:
        spent = time.perf_counter() - started
        if args.stop_after is not None and \
                spent + seed_seconds > args.stop_after:
            print('stopped before seed', seed, f'after {spent:.0f} s',
                  flush=True)
            break
        seed_start = time.perf_counter()
        work = Path(tempfile.mkdtemp(prefix='diag_flips_'))
        root = work / 'CHiME5'
        corpus.make_session(root, config, traffic, seed, args.device)
        dump_json(create_database(root), work / 'chime5.json')
        utterances, intervals = reference.load_session(root, config)
        enhancer = get_enhancer(database_path=str(work / 'chime5.json'),
                                device=args.device,
                                **run._enhancer_kwargs(config))
        routes = {'k2': enhancer, 'tiles': dataclasses.replace(
            enhancer, gss_config=dataclasses.replace(
                enhancer.gss_config, wpe_stats_backend='xla'))}
        it = enhancer.get_iterator(config['session']['session_id'])
        ids = sorted(e for e, u in utterances.items()
                     if u.emitted_seconds >= args.min_seconds)[:args.limit]
        sample = check.draw_sample(
            ids, {i: utterances[i].emitted_seconds for i in ids}, seed,
            correct['sample'], correct['min_seconds']) if whole else []
        seed_rows = {}
        for eid in ids:
            utt = utterances[eid]
            ref_snrs.seen.clear()
            ref64, t_ref = ref_in(utt, 'float64')
            assert len(ref_snrs.seen) == 1, len(ref_snrs.seen)
            snr64 = ref_snrs.seen[0].double().cpu()
            row = dict(seed=seed, id=eid, seconds=utt.emitted_seconds,
                       t_ref64=t_ref)
            row['ch64'], row['margin64'] = top2(snr64)
            X64 = None
            for label, e in routes.items():
                port_snrs.clear()
                wpe_io.clear()
                t = time.perf_counter()
                x = check.normalized(np.asarray(e.enhance_example(it[eid]),
                                                np.float64))
                x = np.round(x * 2 ** 15) / 2 ** 15     # as its WAV holds it
                sync()
                row[f't_{label}'] = time.perf_counter() - t
                row[f'err_{label}'] = float(np.linalg.norm(x - ref64)
                                            / np.linalg.norm(ref64))
                snr = port_snrs[-1].double().cpu().reshape(
                    -1, snr64.shape[-1])[0]
                row[f'ch_{label}'], row[f'margin_{label}'] = top2(snr)
                row[f'snr_err_{label}'] = float((snr / snr64 - 1).abs().max())
                if args.wpe64:
                    O, fm, X = wpe_io[-1]
                    if X64 is None:
                        X64 = real_wpe(O.to(torch.complex128), e.gss_config,
                                       fm)
                    rel = (torch.linalg.matrix_norm(
                        X.to(torch.complex128) - X64)
                        / torch.linalg.matrix_norm(X64)).reshape(-1)
                    row[f'wpe64_{label}'] = [float(rel.median()),
                                             float(rel.max())]
            if eid in sample or max(row['err_k2'], row['err_tiles']) > limit:
                ref32, row['t_ref32'] = ref_in(utt, 'float32')
                row['sensitivity'] = float(np.linalg.norm(ref32 - ref64)
                                           / np.linalg.norm(ref64))
            for label, count in totals.items():
                over = row[f'err_{label}'] > limit
                count['flips'] += int(row[f'ch_{label}'] != row['ch64'])
                count['over'] += int(over)
                count['stable_over'] += int(
                    over and row['sensitivity'] <= stable_below)
                count['utterances'] += 1
            seed_rows[eid] = row
            print('utterance', json.dumps(row), flush=True)
        if whole:
            line = dict(seed=seed)
            for label, count in totals.items():
                values = check.numbers(
                    {i: seed_rows[i][f'err_{label}'] for i in sample},
                    {i: seed_rows[i]['sensitivity'] for i in sample},
                    stable_below)
                ok, _ = check.verdict(values, {
                    k: v for k, v in correct['limits'].items()
                    if k in values})
                line[label] = dict(values, correct=ok)
                count['incorrect_seeds'] += int(not ok)
            print('seed', json.dumps(line), flush=True)
        del enhancer, routes, it
        if args.device.startswith('cuda'):
            torch.cuda.empty_cache()
        seed_seconds = max(seed_seconds, time.perf_counter() - seed_start)
    print('flips', json.dumps(totals), flush=True)


if __name__ == '__main__':
    main()
