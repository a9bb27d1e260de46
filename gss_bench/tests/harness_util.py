"""A tiny copy of the benchmark for CPU tests: the repository's
``gss_bench`` plus a CHiME-5 configuration, a CHiME-6 track-1 deployment
(``chime6_track1.py``) and its configuration, three traffic mixes, a
metric and their cells, added as files and entries only, as a later
change would add them."""

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
# the CHiME-6 deployment's session, jobs and two-rank cells
CHIME6_CELLS = ('tiny_chime6.session', 'tiny_chime6.jobs')
CHIME6_RANKS = 'tiny_chime6.ranks'
CHIME6_SOURCE = BENCH / 'tests' / 'chime6_track1.py'
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


def tiny_chime6_config():
    """The tiny session as CHiME-6 track 1 deploys it: the
    ``chime6_track1`` deployment, each array's outer microphones; two
    arrays (D = 4), so that the CPU runs it in seconds."""
    config = tiny_config(multiarray='outer_array_mics')
    config.update(name='tiny_chime6', deployment_module='chime6_track1')
    config['session']['arrays'] = ['U01', 'U02']
    # the configuration's own sample, not tiny_config's 4: a median of
    # four reads off the one or two ill-conditioned utterances that a short
    # window may write
    config['correct']['sample'] = json.loads(
        (BENCH / 'configs' / 'chime5_single_array.json').read_text()
    )['correct']['sample']
    return config


def write_chime6_deployment(root, source=None):
    """``chime6_track1.py`` (or ``source``) as the copy ``root``'s
    deployment ``chime6_track1``."""
    (Path(root) / 'gss_bench' / 'deployments' / 'chime6_track1.py') \
        .write_text(CHIME6_SOURCE.read_text() if source is None else source)


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
    (root / 'gss_bench' / 'configs' / 'tiny_chime6.json').write_text(
        json.dumps(tiny_chime6_config()))
    write_chime6_deployment(root)
    for traffic, name, own in (('s02_dense', 'tiny_session', {}),
                               ('kaldi_jobs', 'tiny_jobs', {}),
                               ('s02_dense_4gpu', 'tiny_ranks',
                                {'processes': 2})):
        (root / 'gss_bench' / 'traffic' / f'{name}.json').write_text(
            json.dumps(tiny_traffic(traffic, **own)))
    (root / 'gss_bench' / 'metrics' / 'tiny_wavs.py').write_text(TINY_METRIC)
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    for name in ('tiny', 'tiny_chime6'):
        bench['configs'].append({'name': name, 'source': 'a test',
                                 'file': f'gss_bench/configs/{name}.json',
                                 'reduced': [], 'why': 'a test'})
        bench['workloads'] += [
            {'name': f'{name}.session', 'config': name,
             'traffic': 'tiny_session', 'chips': 1, 'why': 'a test'},
            {'name': f'{name}.jobs', 'config': name, 'traffic': 'tiny_jobs',
             'chips': 1, 'why': 'a test'},
            {'name': f'{name}.ranks', 'config': name,
             'traffic': 'tiny_ranks', 'chips': 2, 'why': 'a test'}]
    for metric in bench['per_layer']:
        jobs_only = metric['name'] == 'job_latency_p95_ms'
        metric['workloads'] += [c for c in TINY_CELLS + CHIME6_CELLS
                                if c.endswith('.jobs') or not jobs_only]
        if 'chime5_multiarray.s02_dense_4gpu' in metric['workloads']:
            metric['workloads'] += [TINY_RANKS, CHIME6_RANKS]
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
