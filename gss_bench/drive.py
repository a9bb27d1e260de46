"""The measured window: the traffic's closed loop over the program's entry,
``Enhancer.enhance_session``, until the deadline.

* ``session`` traffic: each call enhances the whole session in session
  time order, and calls repeat.  The shard hands the calling thread one
  utterance at a time and stops at the deadline, so at most the pump's
  prefetched and in-flight utterances (a few) finish after it.
* ``session`` traffic on N cards (:func:`run_rank`, one process a card,
  joined in a process group): each rank's call takes the program's
  default split, ``length_balanced_shard``, and enhances its share in
  session time order; after each call the ranks agree whether the window
  is still open, so all start the next call or none does.
* ``kaldi_jobs`` traffic: upstream's Kaldi jobs, ``number_of_jobs =
  ceil(utterances / utterances_per_job)``; job j is
  ``enhance_session(dataset_slice=slice(j - 1, None, number_of_jobs),
  shard_fn=serial_shard)``.  Jobs run one after another in job order and
  repeat; a job in flight at the deadline finishes after it.

Each written WAV is timed by the ``progress`` hook (the writer thread, once
the file is written).  In a traced run the profiler traces
``trace_seconds`` of the window, started and stopped on the calling
thread: on one card the window's last seconds; on N cards from the moment
a rank's share of a call is all dispatched (:meth:`Window.boundary`), so
that every run's slice holds the same phase of a call: the last chains
draining, the ranks meeting and the next call's start.
"""

import math
import time

__all__ = ['Window', 'run']


class Window:
    """The window's clock, its written utterances, its jobs and the
    profiler slice."""

    def __init__(self, seconds, profiler=None, trace_seconds=0.0):
        self.seconds = seconds
        self.profiler = profiler
        self.trace_seconds = min(trace_seconds, seconds)
        self.written = []          # (time, example_id), every call's
        self.jobs = []             # (start, end) of each job
        self.calls = []            # (end, WAVs written by then, cut)
        self.dispatched = 0
        self.tracing = False
        self.trace_host_span = None
        self.start = self.deadline = self.end = None
        self._boundary = None      # the last call boundary (N cards)

    def open(self, start=None):
        """Open at ``start`` (``time.perf_counter()``, the host's monotonic
        clock, which every process shares), else now."""
        self.start = time.perf_counter() if start is None else start
        self.deadline = self.start + self.seconds

    def progress(self, example_id):
        self.written.append((time.perf_counter(), example_id))

    def poll(self):
        """Whether the window is still open; starts the profiler at the
        window's last ``trace_seconds`` unless a call boundary started it,
        and stops it once it has run ``trace_seconds`` or at the
        deadline."""
        now = time.perf_counter()
        if now >= self.deadline:
            self._stop_trace(now)
            return False
        if self.tracing:
            if now >= self.trace_host_span[0] + self.trace_seconds:
                self._stop_trace(now)
        elif (self.profiler is not None and self.trace_host_span is None
                and now >= self.deadline - self.trace_seconds):
            self._start_trace(now)
        return True

    def boundary(self):
        """A rank's share of a call is all dispatched (its last chains
        drain, the ranks meet, the next call starts): the profiled slice
        starts here at the first such boundary from which it ends before
        the deadline and the next one, one and a half passes on as the
        last pass predicts, would not."""
        now = time.perf_counter()
        previous = self.start if self._boundary is None else self._boundary
        self._boundary = now
        if (self.profiler is not None and self.trace_host_span is None
                and now + self.trace_seconds <= self.deadline
                and now + 1.5 * (now - previous) + self.trace_seconds
                > self.deadline):
            self._start_trace(now)

    def _start_trace(self, now):
        self.profiler.start()
        self.tracing = True
        self.trace_host_span = (now, None)

    def _stop_trace(self, now):
        if self.tracing:
            self.profiler.stop()
            self.tracing = False
            self.trace_host_span = (self.trace_host_span[0], now)

    def close(self):
        self._stop_trace(time.perf_counter())
        self.end = time.perf_counter()

    def written_in_window(self):
        return [(t, e) for t, e in self.written if t <= self.deadline]

    def jobs_in_window(self):
        return [(s, e) for s, e in self.jobs if e <= self.deadline]


def _session_time(ex):
    """An utterance's position on the session timeline (its earliest
    array start), the order the session-audio cache is filled in."""
    return min(ex['start']['observation'].values())


def _until_deadline(window, examples, cut=None):
    """``examples`` in session time order, one at a time, until the
    deadline; ``cut`` (a list) gets True if the deadline stopped them."""
    for ex in sorted(examples, key=_session_time):
        if not window.poll():
            if cut is not None:
                cut.append(True)
            return
        window.dispatched += 1
        yield ex


def run(enhancer, session_id, audio_dir, traffic, window, num_utterances):
    """Drive ``enhancer`` until ``window``'s deadline."""
    from pb_chime5_tpu_torch.parallel.scheduler import serial_shard

    def deadline_shard(examples, _length_fn):
        return _until_deadline(window, examples)

    window.open()
    if traffic['drive'] == 'session':
        while window.poll():
            enhancer.enhance_session(
                session_id, audio_dir, audio_dir_exist_ok=True,
                shard_fn=deadline_shard, progress=window.progress)
    elif traffic['drive'] == 'kaldi_jobs':
        jobs = math.ceil(num_utterances / traffic['utterances_per_job'])
        j = 0
        while window.poll():
            before = len(window.written)
            start = time.perf_counter()
            enhancer.enhance_session(
                session_id, audio_dir, dataset_slice=slice(j % jobs, None,
                                                            jobs),
                audio_dir_exist_ok=True, shard_fn=serial_shard,
                progress=window.progress)
            window.jobs.append((start, time.perf_counter()))
            window.dispatched += len(window.written) - before
            j += 1
    else:
        raise ValueError(f"unknown drive {traffic['drive']!r}")
    window.close()


def run_rank(enhancer, session_id, audio_dir, traffic, window, start,
             agree):
    """Drive ``enhancer`` on one rank of a process group until
    ``window``'s deadline, from the ranks' common ``start``.  ``agree(open)``
    is every rank's verdict on "the window is still open" (all true or
    none), taken before each call, so that no rank enters the program's
    collective at a call's start (``raise_together``) alone.  Each call's
    end, the WAVs written by then and whether the deadline cut its shard
    go to ``window.calls``; a share's end that the deadline did not cut is
    a call boundary for the profiled slice (:meth:`Window.boundary`)."""
    from pb_chime5_tpu_torch.parallel import distributed
    from pb_chime5_tpu_torch.parallel.scheduler import length_balanced_shard

    if traffic['drive'] != 'session':
        raise ValueError(f"drive {traffic['drive']!r} runs on one card only")
    cut = []

    def rank_shard(examples, length_fn):
        yield from _until_deadline(
            window, length_balanced_shard(examples, length_fn), cut)
        if not cut:
            window.boundary()

    window.open(start)
    while agree(window.poll()):
        cut.clear()
        enhancer.enhance_session(
            session_id, audio_dir, audio_dir_exist_ok=True,
            is_master=distributed.is_master(), shard_fn=rank_shard,
            progress=window.progress)
        window.calls.append((time.perf_counter(), len(window.written),
                             bool(cut)))
    window.close()
