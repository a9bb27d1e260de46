"""The span metrics' readers (``gss_bench/metrics/``, over
``pb_chime5_tpu_torch.utils.profiling.recorded_spans()``) on hand-made
spans and records: the cut at the first span the profiler saw, None
without spans or without the recorder, and ``idle_outside_spans_pct``
from ``idle_gaps`` with and without the calling thread's spans.  The
test marked ``cuda`` runs a traced cell on the card and skips without
one."""

import json
import subprocess
import sys

import pytest

from gss_bench import run
from gss_bench.tests.harness_util import REPO, result
from pb_chime5_tpu_torch.utils import profiling
from pb_chime5_tpu_torch.utils.profiling import Span

MS = 1_000_000
SPAN_METRICS = ('prepare_wait_ms_per_utt', 'dispatch_host_ms_per_utt',
                'write_wait_ms_per_utt', 'session_setup_ms_per_call')
NEW_METRICS = SPAN_METRICS + ('idle_outside_spans_pct',)


def spans_of(rows):
    """(name, thread, start ms, end ms, profiled) -> top-level spans."""
    return [Span(name, thread, int(start * MS),
                 None if end is None else int(end * MS), None, 'u', profiled)
            for name, thread, start, end, profiled in rows]


# the calling thread 1, the prefetch thread 2, the writer thread 3; the
# profiler starts at 100 ms: the spans from there on are not read
ROWS = [
    ('gss.session_setup', 1, 0, 4, False),
    ('gss.prepare', 2, 0, 10, False),
    ('gss.prepare_wait', 1, 4, 10, False),
    ('gss.dispatch', 1, 10, 13, False),
    ('gss.prepare', 2, 10, 12, False),
    ('gss.prepare_wait', 1, 13, 13.5, False),
    ('gss.dispatch', 1, 13.5, 18.5, False),
    ('gss.write', 3, 20, 30, False),
    ('gss.write_wait', 1, 18.5, 30, False),
    ('gss.session_setup', 1, 40, 46, False),
    ('gss.prepare_wait', 1, 46, 99, False),
    ('gss.dispatch', 1, 99, 101, False),   # ends in the slice: not read
    ('gss.write', 3, 90, 110, False),      # ends in the slice: not read
    ('gss.prepare_wait', 1, 100, 103, True),
    ('gss.dispatch', 1, 103, 200, True),
    ('gss.write_wait', 1, 200, 300, True),
    ('gss.session_setup', 1, 300, 400, True),
    ('gss.dispatch', 1, 400, None, True),  # still open
]


@pytest.fixture
def recorded(monkeypatch):
    def use(rows):
        spans = spans_of(rows)
        monkeypatch.setattr(profiling, 'recorded_spans', lambda: spans,
                            raising=False)
    return use


def read(name, record=None):
    return run.load_metric(name)(record or {'trace': None})


def test_span_metrics_read_only_the_spans_before_the_profiled_slice(
        recorded):
    recorded(ROWS)
    assert read('prepare_wait_ms_per_utt') == pytest.approx(
        (6 + 0.5 + 53) / 3)
    assert read('dispatch_host_ms_per_utt') == pytest.approx((3 + 5) / 2)
    assert read('write_wait_ms_per_utt') == pytest.approx(11.5 / 2)
    assert read('session_setup_ms_per_call') == pytest.approx((4 + 6) / 2)


def test_span_metrics_without_a_profiled_span_read_every_closed_one(
        recorded):
    recorded([row[:4] + (False,) for row in ROWS])
    assert read('dispatch_host_ms_per_utt') == pytest.approx(
        (3 + 5 + 2 + 97) / 4)
    assert read('session_setup_ms_per_call') == pytest.approx(
        (4 + 6 + 100) / 3)


def test_span_metrics_none_without_spans(recorded, monkeypatch):
    record = {'trace': {'busy_s': 1.0, 'window_s': 3.0,
                        'idle_gaps': [['gss.dispatch', 1.0]]}}
    recorded([])
    assert all(read(name, record) is None for name in NEW_METRICS)
    # a program without the recorder (the parent of the spans)
    monkeypatch.delattr(profiling, 'recorded_spans')
    assert all(read(name, record) is None for name in NEW_METRICS)
    # spans, but none of the metric's own
    recorded([('gss.prepare', 2, 0, 10, False)])
    assert all(read(name) is None for name in SPAN_METRICS)


def test_idle_outside_spans_pct(recorded):
    recorded(ROWS)
    trace = {'busy_s': 2.0, 'window_s': 3.0, 'idle_gaps': [
        ['gss.write_wait', 0.5], ['cudaEventSynchronize', 0.7],
        ['gss.dispatch', 0.25], ['no host op', 0.15],
        ['gss.prepare_wait', 0.05]]}
    assert read('idle_outside_spans_pct', {'trace': trace}) == \
        pytest.approx(20.0)
    # a writer-thread span the profiler saw after all is not the calling
    # thread's: it overlaps the others and is not added
    with_writer = dict(trace, idle_gaps=trace['idle_gaps']
                       + [['gss.write', 0.6]])
    assert read('idle_outside_spans_pct', {'trace': with_writer}) == \
        pytest.approx(20.0)
    no_spans = dict(trace, idle_gaps=[['cudaEventSynchronize', 0.7],
                                      ['no host op', 0.3]])
    assert read('idle_outside_spans_pct', {'trace': no_spans}) == \
        pytest.approx(100.0)
    for empty in (None, dict(trace, busy_s=0.0),
                  dict(trace, busy_s=3.0)):
        assert read('idle_outside_spans_pct', {'trace': empty}) is None


def test_new_metrics_in_benchmark_json():
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    entries = {m['name']: m for m in bench['per_layer']}
    cells = [w['name'] for w in bench['workloads']]
    # a call a job, or a call a pass on several cards, which meet there
    calls = ['chime5_single_array.kaldi_jobs'] + [
        w['name'] for w in bench['workloads'] if w['chips'] > 1]
    for name in NEW_METRICS:
        entry = entries[name]
        assert entry['source'] == 'program_span'
        assert entry['moves'] == 'xrt_emitted'
        assert entry['workloads'] == (
            calls if name == 'session_setup_ms_per_call' else cells)


@pytest.mark.cuda
def test_traced_cell_on_the_card_prints_the_span_metrics():
    """A short traced run of the single-array session cell on the card
    prints every new metric beside the ones it had."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    cell = 'chime5_single_array.s02_dense'
    proc = subprocess.run(
        [sys.executable, '-m', 'gss_bench.run', '--workload', cell,
         '--seed', str(2 ** 31 + 203), '--seconds', '8', '--trace', '1'],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    line = result(proc)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line['correct'] is True, proc.stderr[-3000:]
    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    expected = {m['name'] for m in run.cell_metrics(bench, cell, 1)}
    assert set(NEW_METRICS) - {'session_setup_ms_per_call'} <= expected
    assert expected == set(line['metrics']), proc.stderr[-3000:]
