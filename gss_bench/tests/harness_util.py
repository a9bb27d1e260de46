"""A tiny copy of the benchmark for CPU tests: the repository's
``gss_bench`` plus a configuration, two traffic mixes, a metric and their
cells, added as files and entries only, as a later change would add
them."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

from gss_bench import run

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / 'gss_bench'

TINY_CELLS = ('tiny.session', 'tiny.jobs')
# the tiny session on two ranks (``gss_bench/ranks.py``), on the CPU
TINY_RANKS = 'tiny.ranks'
TINY_METRIC = '''"""The WAVs written inside the window (a metric added as a file)."""


def read(record):
    return float(len(record['written']))
'''


def tiny_config(**enhancer):
    """The single-array configuration at a size the CPU runs in seconds:
    a 40 s session, 0.5 s of context, every iteration of the chain."""
    config = json.loads((BENCH / 'configs' / 'chime5_single_array.json')
                        .read_text())
    config['name'] = 'tiny'
    config['session_duration_s'] = 40
    config['enhancer'].update(context_samples=8000, **enhancer)
    config['correct']['sample'] = 4
    return config


def tiny_traffic(name, **own):
    traffic = run.load_traffic(name)
    traffic.update(rate_per_s=0.2, edge_s=1.0, **own)
    traffic['length'].update(mean_s=1.2, max_s=3.0)
    return traffic


def tiny_copy(root, **enhancer):
    """``root``: ``BENCHMARK.json`` and ``gss_bench`` with the tiny cells."""
    root = Path(root)
    shutil.copytree(BENCH, root / 'gss_bench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    (root / 'gss_bench' / 'configs' / 'tiny.json').write_text(
        json.dumps(tiny_config(**enhancer)))
    for traffic, name, own in (('s02_dense', 'tiny_session', {}),
                               ('kaldi_jobs', 'tiny_jobs', {}),
                               ('s02_dense_4gpu', 'tiny_ranks',
                                {'processes': 2})):
        (root / 'gss_bench' / 'traffic' / f'{name}.json').write_text(
            json.dumps(tiny_traffic(traffic, **own)))
    (root / 'gss_bench' / 'metrics' / 'tiny_wavs.py').write_text(TINY_METRIC)
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    bench['configs'].append({'name': 'tiny', 'source': 'a test',
                             'file': 'gss_bench/configs/tiny.json',
                             'reduced': [], 'why': 'a test'})
    bench['workloads'] += [
        {'name': 'tiny.session', 'config': 'tiny', 'traffic': 'tiny_session',
         'chips': 1, 'why': 'a test'},
        {'name': 'tiny.jobs', 'config': 'tiny', 'traffic': 'tiny_jobs',
         'chips': 1, 'why': 'a test'},
        {'name': TINY_RANKS, 'config': 'tiny', 'traffic': 'tiny_ranks',
         'chips': 2, 'why': 'a test'}]
    for metric in bench['per_layer']:
        metric['workloads'] += (['tiny.jobs']
                                if metric['name'] == 'job_latency_p95_ms'
                                else list(TINY_CELLS))
        if 'chime5_multiarray.s02_dense_4gpu' in metric['workloads']:
            metric['workloads'].append(TINY_RANKS)
    bench['per_layer'].append({
        'name': 'tiny_wavs', 'unit': 'count', 'better': 'higher',
        'source': 'host_clock', 'layer': 'session loop',
        'moves': 'xrt_emitted', 'workloads': list(TINY_CELLS)})
    (root / 'BENCHMARK.json').write_text(json.dumps(bench))
    return root


def run_cpu(root, workload, *, seed=2 ** 31 + 11, seconds=4, trace=0,
            patch='', rank_patch=''):
    """One run of the copy's harness on the CPU, in a fresh process;
    ``patch`` is Python run first (a planted fault), ``rank_patch`` Python
    that every process started from ``root`` runs first, the ranks'
    included (``root/sitecustomize.py``)."""
    if rank_patch:
        (Path(root) / 'sitecustomize.py').write_text(rank_patch)
    code = (f'{patch}\nimport sys\nfrom gss_bench import run\n'
            f'sys.exit(run.main(["--workload", "{workload}", "--seed", '
            f'"{seed}", "--seconds", "{seconds}", "--trace", "{trace}"], '
            f'device="cpu"))')
    return subprocess.run(
        [sys.executable, '-c', code], cwd=root, capture_output=True,
        text=True, timeout=900,
        env={**os.environ, 'PYTHONPATH': f'{root}{os.pathsep}{REPO}',
             'OMP_NUM_THREADS': '4'})


def result(proc):
    """The result line of a run, or None."""
    lines = proc.stdout.strip().splitlines()
    if not lines:
        return None
    try:
        return json.loads(lines[-1])
    except json.JSONDecodeError:
        return None
