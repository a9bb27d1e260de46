"""The harness on the CPU: the traffic generator, the window's
accounting, the metrics' arithmetic, the result line, the look-up of
cells, configurations, traffic and metrics by name, a tiny session end to
end, and the runs that must fail.  The test marked ``cuda`` runs a cell on
the card and skips without one."""

import hashlib
import json
import subprocess
import sys
import time
import types

import numpy as np
import pytest

from gss_bench import corpus, drive, run, trace
from gss_bench.tests.harness_util import (
    REPO, result, run_cpu, tiny_config, tiny_copy, tiny_traffic)

RESULT_KEYS = ['correct', 'attempted', 'failed', 'metrics', 'device']


def digest(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(
        p.read_bytes()).hexdigest() for p in sorted(root.rglob('*'))
        if p.is_file()}


def test_corpus_same_seed_same_files(tmp_path):
    config, traffic = tiny_config(), tiny_traffic('s02_dense')
    seeds = (2 ** 31 + 3, 2 ** 31 + 3, 2 ** 31 + 4)
    for i, seed in enumerate(seeds):
        corpus.make_session(tmp_path / str(i), config, traffic, seed, 'cpu')
    first, again, other = (digest(tmp_path / str(i)) for i in range(3))
    assert first == again
    assert set(first) == set(other)
    assert all(first[k] != other[k] for k in first)
    wavs = [k for k in first if k.endswith('.wav')]
    assert sorted(wavs) == [f'audio/dev/S02_U01.CH{m}.wav'
                            for m in range(1, 5)]


def test_traffic_base_and_processes():
    """A mix with a ``base`` is that mix with its own keys over it, and
    every cell runs as many processes as it has cards."""
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    base, four = run.load_traffic('s02_dense'), run.load_traffic(
        's02_dense_4gpu')
    assert 'base' not in four and four['processes'] == 4
    assert {k: v for k, v in four.items() if k not in ('processes', 'why')} \
        == {k: v for k, v in base.items() if k != 'why'}
    for cell in bench['workloads']:
        traffic = run.load_cell(bench, cell['name'])[2]
        assert traffic.get('processes', 1) == cell['chips'], cell['name']


@pytest.mark.parametrize('traffic_name',
                         ['s02_dense', 'kaldi_jobs', 's02_dense_4gpu'])
def test_traffic_density_and_lengths(traffic_name):
    """The cells' traffic: 0.45 utterances a second over 600 s, the same
    lengths on every seed (the distribution's quantiles, 2.6 s on
    average), each speaker's turns apart, contexts inside the session."""
    config = run.load_cell(
        {'workloads': [{'name': 'c', 'config': 'chime5_multiarray',
                        'traffic': traffic_name}]}, 'c')[1:]
    config, traffic = config
    lengths = corpus.utterance_lengths(traffic, config['session_duration_s'])
    assert len(lengths) == 270
    assert 2.4 < lengths.mean() / 16000 < 2.7
    assert lengths.min() >= 0.5 * 16000 and lengths.max() <= 20 * 16000
    N = corpus.session_num_samples(config)
    edge = int(traffic['edge_s'] * 16000)
    for seed in (1, 2 ** 31 + 9):
        turns = corpus.place_turns(np.random.default_rng([seed, 0]),
                                   lengths, 4, N, edge)
        assert sorted(e - s for _, s, e in turns) == sorted(lengths.tolist())
        assert min(s for _, s, _ in turns) >= edge
        assert max(e for _, _, e in turns) <= N - edge
        for k in range(4):
            own = sorted((s, e) for j, s, e in turns if j == k)
            assert all(a[1] <= b[0] for a, b in zip(own, own[1:]))
    assert edge >= config['enhancer']['context_samples']


def test_window_counts_only_writes_before_the_deadline():
    window = drive.Window(2.0)
    window.open()
    window.written = [(window.start + 0.5, 'a'), (window.start + 1.9, 'b'),
                      (window.deadline + 0.01, 'c')]
    window.jobs = [(window.start, window.start + 1.0),
                   (window.start + 1.5, window.deadline + 0.2)]
    assert [e for _, e in window.written_in_window()] == ['a', 'b']
    assert len(window.jobs_in_window()) == 1
    record = {'written': window.written_in_window(), 'window_s': 2.0,
              'emitted_s': {'a': 1.0, 'b': 3.0, 'c': 100.0}}
    assert run.load_metric('xrt_emitted')(record) == pytest.approx(2.0)


def test_window_closes_and_traces_its_last_seconds():
    class Profiler:
        def __init__(self):
            self.calls = []

        def start(self):
            self.calls.append('start')

        def stop(self):
            self.calls.append('stop')
    profiler = Profiler()
    window = drive.Window(0.3, profiler, trace_seconds=0.1)
    window.open()
    polls = 0
    while window.poll():
        polls += 1
        time.sleep(0.01)
    window.close()
    assert profiler.calls == ['start', 'stop']
    start, stop = window.trace_host_span
    assert start >= window.deadline - 0.1 and stop >= window.deadline
    assert polls > 10


def test_ranks_slice_starts_at_a_call_boundary(monkeypatch):
    """On several cards the profiled slice starts at the first share's
    end from which it ends before the deadline and the next one would
    not (one and a half passes on), runs ``trace_seconds`` and is not
    started again."""
    now = [100.0]
    monkeypatch.setattr(drive, 'time',
                        types.SimpleNamespace(perf_counter=lambda: now[0]))

    class Profiler:
        def __init__(self):
            self.calls = []

        def start(self):
            self.calls.append(('start', now[0]))

        def stop(self):
            self.calls.append(('stop', now[0]))

    def at(t):
        now[0] = 100.0 + t

    profiler = Profiler()
    window = drive.Window(45.0, profiler, trace_seconds=3.0)
    window.open()
    for end in (6.0, 12.0, 18.0, 24.0, 30.0):   # 30 + 1.5 x 6 + 3 < 45
        at(end)
        window.boundary()
        assert window.poll() and profiler.calls == []
    at(36.0)                                    # 36 + 9 + 3 > 45
    window.boundary()
    assert profiler.calls == [('start', 136.0)]
    at(38.5)
    assert window.poll() and len(profiler.calls) == 1
    at(39.1)
    assert window.poll()
    assert profiler.calls == [('start', 136.0), ('stop', 139.1)]
    at(42.0)
    window.boundary()
    at(43.0)
    assert window.poll()
    at(45.0)
    assert not window.poll()
    window.close()
    assert len(profiler.calls) == 2
    assert window.trace_host_span == (136.0, 139.1)
    # a boundary too late for a whole slice: the window's last seconds
    window = drive.Window(45.0, Profiler(), trace_seconds=3.0)
    at(0.0)
    window.open()
    at(42.5)
    window.boundary()
    assert window.profiler.calls == []
    at(42.6)
    assert window.poll() and window.profiler.calls == [('start', 142.6)]


def test_job_latency_p95_over_all_jobs():
    read = run.load_metric('job_latency_p95_ms')
    jobs = list(np.random.default_rng(0).permutation(np.arange(1, 201)))
    assert read({'jobs_ms': [float(j) for j in jobs]}) == 190.0
    assert read({'jobs_ms': [5.0]}) == 5.0
    assert read({'jobs_ms': []}) is None
    assert read({'jobs_ms': None}) is None


def test_union_and_idle_arithmetic():
    assert trace.union_of([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3],
                                                               [5, 8]]
    idle, by_op = trace.idle_attribution(
        [(0, 2), (5, 8)], [('a', 1, 6), ('b', 9, 10)], (0, 10))
    assert idle == 5
    assert by_op == {'a': 3, 'no host op': 1, 'b': 1}
    summary = trace.summarize(
        [('k1', 0, 2e6), ('k2', 1e6, 3e6), ('k1', 5e6, 12e6)],
        [('op', 0, 10e6)], (0, 10e6))
    assert summary['busy_s'] == 8.0 and summary['window_s'] == 10.0
    assert summary['device_ops'] == [['k1', 7.0], ['k2', 2.0]]
    assert summary['idle_gaps'] == [['op', 2.0]]
    record = {'trace': summary}
    assert run.load_metric('device_idle_pct')(record) == pytest.approx(20.0)


def test_stage_and_cache_metrics():
    stages = [{'stft': 1.0, 'wpe': 60.0, 'em': 30.0, 'beamform': 3.0,
               'istft': 1.0}] * 4
    record = {'stages': stages, 'stages_wall_s': 0.5,
              'least': {'wpe': 4 * 0.015, 'em': 4 * 0.003},
              'cache': {'hits': 97, 'refills': 3, 'direct': 0,
                        'refill_s': 0.25, 'prefetch_s': 0.15},
              'written_all': 100}
    read = {name: run.load_metric(name) for name in (
        'outside_chains_pct', 'wpe_ms_per_utt', 'em_ms_per_utt',
        'wpe_roofline_pct', 'em_roofline_pct', 'cache_hit_pct',
        'cache_refill_ms_per_utt')}
    assert read['outside_chains_pct'](record) == pytest.approx(24.0)
    assert read['wpe_ms_per_utt'](record) == pytest.approx(60.0)
    assert read['em_ms_per_utt'](record) == pytest.approx(30.0)
    assert read['wpe_roofline_pct'](record) == pytest.approx(25.0)
    assert read['em_roofline_pct'](record) == pytest.approx(10.0)
    assert read['cache_hit_pct'](record) == pytest.approx(97.0)
    assert read['cache_refill_ms_per_utt'](record) == pytest.approx(4.0)
    empty = dict(record, stages=None, cache=None, least=None)
    assert all(r(empty) is None for r in read.values())


def test_result_line_keys():
    import json
    line = json.loads(run.result_line(
        True, 10, 0, {'xrt_emitted': {'value': 1.5, 'unit': 's/s'}},
        {'platform': 'gpu'}, {'device_ops': [], 'idle_gaps': []},
        [('err_median', 1e-4, 1e-3)]))
    assert list(line) == RESULT_KEYS + ['breakdown', 'checks']
    assert line['checks'] == {'err_median': {'value': 1e-4, 'limit': 1e-3}}
    line = json.loads(run.result_line(False, 1, 1, {}, {}, None, []))
    assert list(line) == RESULT_KEYS + ['checks']


def test_forbidden_modules_compares_whole_names():
    assert run.forbidden_modules({'pb_chime5_tpu_torch.models': 0,
                                  'jaxtyping': 0, 'numpy': 0}) == []
    assert run.forbidden_modules({'pb_chime5_tpu.models.gss': 0,
                                  'jax._src': 0, 'jaxlib': 0}) == [
        'jax', 'jaxlib', 'pb_chime5_tpu']


def test_benchmark_json_names_files_that_exist():
    import json
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    for cell in bench['workloads']:
        run.load_cell(bench, cell['name'])
    for metric in bench['end_to_end'] + bench['per_layer']:
        assert callable(run.load_metric(metric['name']))
    for config in bench['configs']:
        assert (REPO / config['file']).exists()


@pytest.mark.parametrize('workload, trace_flag, seconds', [
    ('tiny.session', 1, 4), ('tiny.jobs', 0, 4), ('tiny.jobs', 1, 12)])
def test_tiny_run_end_to_end(tmp_path, workload, trace_flag, seconds):
    """The added cell, configuration, traffic and metric are found by name;
    the run enhances, checks and prints its line."""
    root = tiny_copy(tmp_path)
    proc = run_cpu(root, workload, trace=trace_flag, seconds=seconds)
    line = result(proc)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert line is not None, proc.stdout[-2000:]
    assert list(line)[:5] == RESULT_KEYS and list(line)[-1] == 'checks'
    assert line['correct'] is True, proc.stderr[-3000:]
    assert line['attempted'] > 0 and line['failed'] == 0
    assert line['device']['platform'] == 'cpu'
    metrics = line['metrics']
    if trace_flag:
        assert metrics['tiny_wavs']['value'] > 0
        assert metrics['tiny_wavs']['unit'] == 'count'
        assert 'cache_hit_pct' in metrics
        assert ('job_latency_p95_ms' in metrics) == (workload == 'tiny.jobs')
        assert 'xrt_emitted' not in metrics
    else:
        assert {'xrt_emitted', 'setup_s'} <= set(metrics)
        assert 'peak_device_gib' not in metrics     # no card: no reading
    lines = proc.stderr.strip().splitlines()
    assert [s.split()[1] for s in lines[-len(line['checks']):]] == list(
        line['checks'])


def test_measuring_run_without_a_card_fails():
    proc = subprocess.run(
        [sys.executable, '-m', 'gss_bench.run', '--workload',
         'chime5_single_array.s02_dense', '--seed', '1', '--seconds', '1',
         '--trace', '0'], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'CUDA card' in proc.stderr


def test_run_with_only_the_benchmark_fails(tmp_path):
    """A checkout holding only BENCHMARK.json and gss_bench: the program
    cannot be imported, the run fails and prints no result."""
    import os
    import shutil
    shutil.copytree(REPO / 'gss_bench', tmp_path / 'gss_bench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(REPO / 'BENCHMARK.json', tmp_path)
    code = ('import sys\nfrom gss_bench import run\nsys.exit(run.main(['
            '"--workload", "chime5_single_array.s02_dense", "--seed", "1", '
            '"--seconds", "1"], device="cpu"))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, 'PYTHONPATH': str(tmp_path)})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ''
    assert 'pb_chime5_tpu_torch' in proc.stderr


def test_run_that_loads_jax_fails(tmp_path):
    root = tiny_copy(tmp_path)
    proc = run_cpu(root, 'tiny.jobs', seconds=1, patch=(
        'import sys, types\nsys.modules["jax"] = types.ModuleType("jax")'))
    assert proc.returncode != 0
    assert result(proc) is None
    assert "forbidden modules loaded: ['jax']" in proc.stderr


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of each cell that the machine's cards hold: it prints
    a correct line with its end-to-end metrics."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    import json
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    cells = [c for c in bench['workloads']
             if c['chips'] <= torch.cuda.device_count()]
    for cell in cells:
        proc = subprocess.run(
            [sys.executable, '-m', 'gss_bench.run', '--workload',
             cell['name'], '--seed', str(2 ** 31 + 101), '--seconds', '5',
             '--trace', '0'], cwd=REPO, capture_output=True, text=True,
            timeout=900)
        line = result(proc)
        assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
        assert line['correct'] is True, proc.stderr[-3000:]
        assert line['device']['platform'] == 'gpu'
        assert line['device']['count'] == cell['chips']
        assert {'xrt_emitted', 'setup_s', 'peak_device_gib'} <= set(
            line['metrics'])

