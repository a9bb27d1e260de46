"""Per-stage wall timing, the profiler trace and the host spans — the
port of ``pb_chime5_tpu/utils/profiling.py``: ``StageTimer`` unchanged,
``trace`` on ``torch.profiler``, ``device_sync`` as a CUDA
synchronization of the devices a tree's tensors lie on.

Spans: ``with span(name, utt):`` around a host step of the program.  With
no recording open it is a shared no-op.  Inside :func:`record_spans`
(opened by ``models.gss.record_stage_times`` and by :func:`trace`) each
span is kept in memory as a :class:`Span`, on any thread, stamped with
``time.time_ns()``, the clock of the profiler's events; where the
profiler runs on the span's thread it also opens a profiler range of
the same name (``record_function``'s), so the span is a host op of the
profiler's trace.
:func:`recorded_spans` returns the last recording's spans.
"""

import collections
import contextlib
import json
import os
import threading
import time
from pathlib import Path

import torch

__all__ = ['StageTimer', 'trace', 'device_sync', 'Span', 'span',
           'timed_span', 'record_spans', 'recorded_spans']

Span = collections.namedtuple(
    'Span', 'name thread start_ns end_ns parent utt profiled')
Span.__doc__ = """One recorded span: ``thread`` the native thread id,
``start_ns`` / ``end_ns`` Unix nanoseconds (``end_ns`` None while open),
``parent`` the index of the enclosing span of the same thread (None at
the top), ``utt`` the utterance (inherited from the parent when not
given), ``profiled`` whether the profiler ran on that thread at its
start."""

_NOOP = contextlib.nullcontext()
_lock = threading.Lock()
_local = threading.local()        # .stack: the thread's open spans
_recording = None                 # the open recording's list, or None
_depth = 0                        # nesting of record_spans
_spans = []                       # the last recording's list


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def device_sync(tree):
    """Wait for the work queued on every CUDA device that a tensor of
    ``tree`` (nested dicts, lists and tuples) lies on; CPU tensors and
    other leaves need none.  Returns ``tree``."""
    devices = {t.device for t in _tensors(tree) if t.device.type == 'cuda'}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


class StageTimer:
    """Accumulate wall-clock per named stage.

    >>> timer = StageTimer()
    >>> with timer('stft'):
    ...     pass
    >>> 'stft' in timer.totals()
    True
    """

    def __init__(self, sync=False):
        self._acc = {}
        self._counts = {}
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name, result=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None:
                device_sync(result)
            dt = time.perf_counter() - start
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self):
        return dict(self._acc)

    def report(self):
        width = max((len(k) for k in self._acc), default=0)
        return '\n'.join(
            f'{k:<{width}}  {v:8.3f} s  ({self._counts[k]} calls)'
            for k, v in sorted(self._acc.items(), key=lambda kv: -kv[1]))


class _Span:
    """A span that reads the clock whether or not a recording is open
    (``seconds`` after the block) and records itself where one is; the
    clock is read outside its profiler range, which lies within it."""
    __slots__ = ('name', 'utt', 'start_ns', 'end_ns', '_spans', '_index',
                 '_parent', '_profiled', '_function')

    def __init__(self, name, utt=None):
        self.name, self.utt = name, utt
        self.start_ns = self.end_ns = self._spans = self._function = None

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self):
        spans = _recording
        if spans is not None:
            stack = _local.__dict__.setdefault('stack', [])
            top = stack[-1] if stack and stack[-1]._spans is spans else None
            self._parent = None if top is None else top._index
            if self.utt is None and top is not None:
                self.utt = top.utt
            self._profiled = torch._C._autograd._profiler_enabled()
            stack.append(self)
            self._spans = spans
        self.start_ns = time.time_ns()
        if spans is not None:
            if self._profiled:
                # record_function's range without its dispatched op: it
                # opens within a few us of the clock read, not ~30 us
                self._function = torch._C._profiler._RecordFunctionFast(
                    self.name)
                self._function.__enter__()
            with _lock:
                self._index = len(spans)
                spans.append(self._span())
        return self

    def __exit__(self, *exc):
        if self._function is not None:
            self._function.__exit__(*exc)
        self.end_ns = time.time_ns()
        if self._spans is not None:
            with _lock:
                self._spans[self._index] = self._span()
            _local.stack.pop()
        return False

    def _span(self):
        return Span(self.name, threading.get_native_id(), self.start_ns,
                    self.end_ns, self._parent, self.utt, self._profiled)


def span(name, utt=None):
    """``with span(name, utt):`` records the block as a :class:`Span`
    while a recording is open; otherwise the shared no-op (no clock read,
    no allocation)."""
    if _recording is None:
        return _NOOP
    return _Span(name, utt)


def timed_span(name, utt=None):
    """:func:`span` that always reads the clock: its ``seconds`` after
    the block are the span's own duration, recorded or not."""
    return _Span(name, utt)


@contextlib.contextmanager
def record_spans():
    """Record the spans of every thread over the block, in memory, where
    they stay until the next recording opens; an inner ``record_spans``
    adds to the outer one's recording."""
    global _recording, _depth, _spans
    with _lock:
        if _depth == 0:
            _spans = _recording = []
        _depth += 1
    try:
        yield
    finally:
        with _lock:
            _depth -= 1
            if _depth == 0:
                _recording = None


def recorded_spans():
    """The spans of the last recording (the open one, if any), in the
    order they opened; a :class:`Span`'s ``parent`` indexes this list."""
    with _lock:
        return list(_spans)


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block, host ops and (where there is a
    card) CUDA kernels, written as a Chrome trace
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing),
    with the block's spans of the threads the profiler does not see
    (the pump's prefetch and writer threads, the cache's prefetch
    worker) added as complete events of category ``span`` on the
    trace's time base.  Yields the profiler, whose ``key_averages()``
    sums by op and kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    start_ns = time.time_ns()
    with record_spans():
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()  # the block's kernels end inside
        spans = recorded_spans()
    path = log_dir / 'trace.json'
    prof.export_chrome_trace(str(path))
    _add_spans(path, [s for s in spans if not s.profiled
                      and s.end_ns is not None and s.end_ns >= start_ns])


def _add_spans(path, spans):
    """Append ``spans`` to the Chrome trace at ``path``: microseconds
    since its ``baseTimeNanoseconds`` (since the epoch where it has
    none), the profiler's own process id and native thread ids."""
    doc = json.loads(Path(path).read_text())
    base = doc.get('baseTimeNanoseconds', 0)
    pid = os.getpid()
    doc['traceEvents'].extend(
        {'ph': 'X', 'cat': 'span', 'name': s.name, 'pid': pid,
         'tid': s.thread, 'ts': (s.start_ns - base) / 1e3,
         'dur': (s.end_ns - s.start_ns) / 1e3, 'args': {'utt': s.utt}}
        for s in spans)
    Path(path).write_text(json.dumps(doc, default=str))
