"""The port's host spans (``pb_chime5_tpu_torch/utils/profiling.py``:
``span``, ``timed_span``, ``record_spans``, ``recorded_spans`` and the
spans ``trace`` writes) on the CPU: the shared no-op with no recording
open, the parent of nested spans on one thread and on two, the
utterance a child inherits, ``record_stage_times`` as the switch, the
profiler's record of a calling-thread span at the span's own clock
stamps, and the worker-thread spans in ``trace.json``."""

import json
import threading

import pytest
import torch

from pb_chime5_tpu_torch.models import gss
from pb_chime5_tpu_torch.utils import profiling
from pb_chime5_tpu_torch.utils.profiling import (
    record_spans, recorded_spans, span, timed_span, trace)


def by_name(spans):
    return {s.name: (i, s) for i, s in enumerate(spans)}


def test_span_without_recording_is_the_shared_noop():
    with record_spans():
        with span('inside'):
            pass
    before = recorded_spans()
    assert [s.name for s in before] == ['inside']
    first, second = span('a'), span('b', 'utt-1')
    assert first is second is profiling._NOOP
    with first:
        with span('c'):
            pass
    assert recorded_spans() == before       # the last recording, unchanged


def test_timed_span_reads_the_clock_with_no_recording():
    with record_spans():
        pass
    with timed_span('cache.refill') as timed:
        pass
    assert timed.seconds >= 0 and timed.end_ns >= timed.start_ns
    assert recorded_spans() == []


def test_nesting_gives_the_parent_and_the_utterance():
    with record_spans():
        with span('outer', 'u1'):
            with span('middle'):
                with span('inner', 'u2'):
                    pass
            with span('sibling'):
                pass
        with span('top'):
            pass
    spans = recorded_spans()
    names = by_name(spans)
    assert [s.name for s in spans] == ['outer', 'middle', 'inner',
                                       'sibling', 'top']
    outer, middle = names['outer'][0], names['middle'][0]
    assert names['outer'][1].parent is None
    assert names['middle'][1].parent == outer
    assert names['inner'][1].parent == middle
    assert names['sibling'][1].parent == outer
    assert names['top'][1].parent is None
    assert [names[n][1].utt for n in ('outer', 'middle', 'inner', 'sibling',
                                      'top')] == ['u1', 'u1', 'u2', 'u1',
                                                  None]
    for s in spans:
        assert s.thread == threading.get_native_id()
        assert s.start_ns <= s.end_ns and not s.profiled
    inner, middle_span = names['inner'][1], names['middle'][1]
    assert middle_span.start_ns <= inner.start_ns <= inner.end_ns \
        <= middle_span.end_ns


def test_two_threads_keep_separate_stacks():
    """Spans of two threads, interleaved: each child's parent is its own
    thread's open span, never the other thread's."""
    opened, child_done = threading.Barrier(2), threading.Barrier(2)

    def work(name):
        with span(f'{name}.outer', name):
            opened.wait(timeout=30)
            with span(f'{name}.child'):
                pass
            child_done.wait(timeout=30)

    with record_spans():
        threads = [threading.Thread(target=work, args=(n,))
                   for n in ('a', 'b')]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
    spans = recorded_spans()
    names = by_name(spans)
    assert len(spans) == 4
    for n in ('a', 'b'):
        outer_index, outer = names[f'{n}.outer']
        child = names[f'{n}.child'][1]
        assert outer.parent is None
        assert child.parent == outer_index
        assert child.thread == outer.thread
        assert child.utt == n
    assert names['a.outer'][1].thread != names['b.outer'][1].thread


def test_record_spans_nests_into_one_recording():
    with record_spans():
        with span('outer-recording'):
            pass
        with record_spans():
            with span('inner-recording'):
                pass
        with span('after-inner'):
            pass
    assert [s.name for s in recorded_spans()] == [
        'outer-recording', 'inner-recording', 'after-inner']


def test_record_stage_times_records_spans():
    """The benchmark's traced switch opens the recording; its own yield
    (a list of ``{stage: ms}`` dicts, empty off the card) is unchanged."""
    with gss.record_stage_times() as times:
        with span('gss.dispatch', 'u'):
            pass
        assert profiling._recording is not None
    assert times == []
    assert profiling._recording is None
    assert [(s.name, s.utt) for s in recorded_spans()] == [
        ('gss.dispatch', 'u')]


def test_profiled_span_is_a_profiler_event_at_its_own_stamps():
    """A span on the profiler's thread opens a profiler range of its name:
    the profiler's event lies at the span's ``time.time_ns()``
    stamps (the events' Unix time: the trace's start plus the range)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    worker = {}

    def off_thread():
        with span('worker.span'):
            worker['profiled'] = torch._C._autograd._profiler_enabled()

    with record_spans():
        with torch.profiler.profile(activities=activities) as prof:
            for i in range(3):
                with span(f'calling.{i}', 'u'):
                    torch.ones(64).add_(1)
            t = threading.Thread(target=off_thread)
            t.start()
            t.join(timeout=30)
    spans = {s.name: s for s in recorded_spans()}
    assert all(spans[f'calling.{i}'].profiled for i in range(3))
    assert not spans['worker.span'].profiled and not worker['profiled']
    base = prof.profiler.kineto_results.trace_start_ns()
    events = {e.name: e for e in prof.events()}
    assert 'worker.span' not in events
    for i in range(3):
        s, e = spans[f'calling.{i}'], events[f'calling.{i}']
        start = base + e.time_range.start * 1000
        end = base + e.time_range.end * 1000
        assert abs(start - s.start_ns) < 1e6, (i, start - s.start_ns)
        assert abs(end - s.end_ns) < 1e6, (i, end - s.end_ns)


def test_trace_writes_worker_thread_spans(tmp_path):
    """``trace`` adds the spans the profiler cannot see (other threads)
    to ``trace.json``, on its time base, on their own thread ids."""
    worker = {}

    def off_thread():
        worker['tid'] = threading.get_native_id()
        with span('gss.write', 'utt-7'):
            with span('gss.inner'):
                torch.ones(8).sum()

    with trace(tmp_path / 'log'):
        with span('gss.dispatch', 'utt-7'):
            torch.ones(8).sum()
        t = threading.Thread(target=off_thread)
        t.start()
        t.join(timeout=30)
    spans = {s.name: s for s in recorded_spans()}
    doc = json.loads((tmp_path / 'log' / 'trace.json').read_text())
    base = doc.get('baseTimeNanoseconds', 0)
    added = {e['name']: e for e in doc['traceEvents']
             if e.get('cat') == 'span'}
    assert set(added) == {'gss.write', 'gss.inner'}
    for name in ('gss.write', 'gss.inner'):
        event, s = added[name], spans[name]
        assert event['ph'] == 'X' and event['tid'] == worker['tid']
        assert event['args']['utt'] == 'utt-7'
        assert event['ts'] == pytest.approx((s.start_ns - base) / 1e3,
                                            abs=1e-3)
        assert event['dur'] == pytest.approx((s.end_ns - s.start_ns) / 1e3,
                                             abs=1e-3)
    # the calling thread's span is the profiler's own event, once
    dispatch = [e for e in doc['traceEvents']
                if e.get('name') == 'gss.dispatch']
    assert len(dispatch) == 1 and dispatch[0].get('cat') != 'span'
    assert abs(dispatch[0]['ts'] - (spans['gss.dispatch'].start_ns - base)
               / 1e3) < 1e3
