"""The measured window: the traffic's closed loop over the program's entry,
``Enhancer.enhance_session``, until the deadline.

* ``session`` traffic: each call enhances the whole session in session
  time order, and calls repeat.  The shard hands the calling thread one
  utterance at a time and stops at the deadline, so at most the pump's
  prefetched and in-flight utterances (a few) finish after it.
* ``kaldi_jobs`` traffic: upstream's Kaldi jobs, ``number_of_jobs =
  ceil(utterances / utterances_per_job)``; job j is
  ``enhance_session(dataset_slice=slice(j - 1, None, number_of_jobs),
  shard_fn=serial_shard)``.  Jobs run one after another in job order and
  repeat; a job in flight at the deadline finishes after it.

Each written WAV is timed by the ``progress`` hook (the writer thread, once
the file is written).  In a traced run the profiler traces the last
``trace_seconds`` of the window, started and stopped on the calling
thread.
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
        self.dispatched = 0
        self.tracing = False
        self.trace_host_span = None
        self.start = self.deadline = self.end = None

    def open(self):
        self.start = time.perf_counter()
        self.deadline = self.start + self.seconds

    def progress(self, example_id):
        self.written.append((time.perf_counter(), example_id))

    def poll(self):
        """Whether the window is still open; starts the profiler at the
        traced slice and stops it at the deadline."""
        now = time.perf_counter()
        if now >= self.deadline:
            self._stop_trace(now)
            return False
        if (self.profiler is not None and not self.tracing
                and self.trace_host_span is None
                and now >= self.deadline - self.trace_seconds):
            self.profiler.start()
            self.tracing = True
            self.trace_host_span = (now, None)
        return True

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


def run(enhancer, session_id, audio_dir, traffic, window, num_utterances):
    """Drive ``enhancer`` until ``window``'s deadline."""
    from pb_chime5_tpu_torch.parallel.scheduler import serial_shard

    def deadline_shard(examples, _length_fn):
        for ex in sorted(examples, key=_session_time):
            if not window.poll():
                return
            window.dispatched += 1
            yield ex

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
