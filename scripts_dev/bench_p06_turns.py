"""P06 end to end, in turns across two trees of the port: the default and
all-Pallas EM and WPE windows, the wall of ``enhance_example``, and the default
path's kernel launches and device busy time per utterance.

    python scripts_dev/bench_p06_turns.py --parent DIR [--rounds N]

``DIR`` holds another tree of the port (its ``pb_chime5_tpu_torch/``,
e.g. ``git archive <commit> pb_chime5_tpu_torch | tar -x -C DIR``).
``chip_smoke.py``'s synthetic session (6 arrays x 4 mics, PCM16, 64 s,
seed 0) is made once; then one process a tree runs, in the order parent,
change, change, parent (``N`` times), each building its own kernels.  In
each, for the default and the all-Pallas configurations, warm: the walls
of 3 ``enhance_example`` calls of P06 (the longer of the CLI
``test_run``'s two utterances) and the stage windows (CUDA events) of 2
more, of which the EM and WPE windows are summarized (median and range a
tree), and the peak device memory those calls add above what the warm
enhancer holds; then one default call under ``torch.profiler``: its CUDA kernel
launches, memory copies and sets, the union of their device intervals
(busy time) and the span from the first to the last; then the WPE
statistics call alone, by the default route (``wpe_statistics_reference``)
and by K2 (``wpe_statistics``), on ``chip_smoke.py``'s K2 inputs (F = 513,
dim = 240, D = 24) at the headline's T = 2504 and the stress scene's
T = 4191: its time (``chip_smoke.cuda_ms``) and the peak device memory
one call adds.  Each process prints one JSON line; the medians per tree
close the run.

Needs one CUDA card; imports the port only, never JAX.
"""

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OUT = REPO / 'build' / 'p06_turns'
ALL_PALLAS = dict(bss_em_backend='pallas', bss_inverse='pallas_gj',
                  wpe_stats_backend='pallas')


def observation_seconds(ex):
    ra = ex['reference_array']
    return (ex['end']['observation'][ra]
            - ex['start']['observation'][ra]) / 16000


def profile_call(torch, enhancer, ex):
    """Kernel launches and device intervals of one ``enhance_example``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        enhancer.enhance_example(ex)
        torch.cuda.synchronize()
        wall = time.perf_counter() - start
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    copies = [e for e in device if e.name.startswith(('Memcpy', 'Memset'))]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    busy, end = 0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return dict(kernels=len(device) - len(copies), copies_and_sets=len(copies),
                busy_ms=busy / 1e3,
                span_ms=(spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0,
                wall_ms=wall * 1e3)


def statistics_calls(torch):
    """The statistics call by each route: ms and the GiB one call adds."""
    sys.path.insert(1, str(REPO))      # after the tree: its port comes first
    import chip_smoke
    from pb_chime5_tpu_torch.ops.kernels import wpe_stats
    from tests.test_torch_kernels_cuda import wpe_inputs
    routes = {'default': wpe_stats.wpe_statistics_reference,
              'k2': wpe_stats.wpe_statistics}
    F, T, D, _ = chip_smoke.HEADLINE
    out = {}
    for frames in (T, 4191):
        Yt, Y, w, _ = wpe_inputs(F, D, frames, taps=chip_smoke.WPE_TAPS,
                                 seed=11, device='cuda')
        for name, fn in routes.items():
            ms = chip_smoke.cuda_ms(torch, lambda fn=fn: fn(Yt, Y, w), 2)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            result = fn(Yt, Y, w)
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
            del result
            out[f'{name}_T{frames}'] = dict(ms=ms, peak_gib=peak)
        del Yt, Y, w
    return out


def worker(tree, db):
    sys.path.insert(0, tree)
    import torch
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.models.gss import GssConfig
    enhancer = get_enhancer(multiarray=True, database_path=db, device='cuda')
    ex = max(list(enhancer.get_iterator('S02')[:2]), key=observation_seconds)
    result = {'tree': tree, 'utterance': ex['example_id'],
              'device': torch.cuda.get_device_name(0)}
    configs = {'default': enhancer, 'all_pallas': dataclasses.replace(
        enhancer, gss_config=GssConfig(**ALL_PALLAS))}
    for name, e in configs.items():
        e.enhance_example(ex)                    # warm-up, kernel builds
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            start = time.perf_counter()
            e.enhance_example(ex)
            walls.append(time.perf_counter() - start)
        stages = []
        for _ in range(2):
            with gss.record_stage_times() as times:
                e.enhance_example(ex)
            stages.append({k: round(v, 3) for k, v in times[0].items()})
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        result[name] = dict(walls_s=walls, em_ms=[s['em'] for s in stages],
                            wpe_ms=[s['wpe'] for s in stages],
                            peak_gib=[peak], stages=stages)
    result['default_profile'] = profile_call(torch, enhancer, ex)
    result['statistics'] = statistics_calls(torch)
    print(json.dumps(result), flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--parent')
    parser.add_argument('--rounds', type=int, default=1)
    parser.add_argument('--worker')
    parser.add_argument('--db')
    args = parser.parse_args()
    if args.worker:
        return worker(args.worker, args.db)
    import torch
    if not torch.cuda.is_available():
        sys.exit('bench_p06_turns: needs a CUDA card')
    if not args.parent:
        sys.exit('bench_p06_turns: --parent DIR is required')
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True).stdout,
        flush=True)
    sys.path.insert(0, str(REPO))
    import chip_smoke
    OUT.mkdir(parents=True, exist_ok=True)
    db = chip_smoke.make_corpus(OUT)
    trees = {'parent': str(Path(args.parent).resolve()), 'change': str(REPO)}
    runs = {name: [] for name in trees}
    for name in ['parent', 'change', 'change', 'parent'] * args.rounds:
        proc = subprocess.run(
            [sys.executable, __file__, '--worker', trees[name], '--db',
             str(db)], capture_output=True, text=True, timeout=900)
        if proc.returncode:
            sys.exit(f'{name} failed:\n{proc.stdout[-4000:]}\n'
                     f'{proc.stderr[-4000:]}')
        line = proc.stdout.strip().splitlines()[-1]
        print(name, line, flush=True)
        runs[name].append(json.loads(line))
    for name, results in runs.items():
        summary = {'tree': name}
        for config in ('default', 'all_pallas'):
            for key, field in (('wall_s', 'walls_s'), ('em_ms', 'em_ms'),
                               ('wpe_ms', 'wpe_ms'), ('peak_gib', 'peak_gib')):
                values = [v for r in results for v in r[config][field]]
                summary[f'{config}_{key}'] = statistics.median(values)
                summary[f'{config}_{key}_range'] = [min(values), max(values)]
        for key in ('kernels', 'busy_ms', 'span_ms', 'wall_ms'):
            summary[f'default_{key}'] = statistics.median(
                r['default_profile'][key] for r in results)
        for call in results[0]['statistics']:
            for key in ('ms', 'peak_gib'):
                values = [r['statistics'][call][key] for r in results]
                summary[f'statistics_{call}_{key}'] = statistics.median(values)
                summary[f'statistics_{call}_{key}_range'] = [min(values),
                                                              max(values)]
        print('median', json.dumps(summary), flush=True)


if __name__ == '__main__':
    main()
