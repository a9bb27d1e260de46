"""The device's idle time in the profiled slice (the window's last
seconds) that no span of the program's calling thread covers:
100 x (1 - the ``idle_gaps`` charged to its spans / idle).  The calling
thread's spans (``gss.session_setup``, ``gss.prepare_wait``,
``gss.dispatch``, ``gss.write_wait``) are top-level host ops of the
profiler's trace there and never overlap, so their entries add up to the
idle time they cover; spans of other threads, which the profiler does
not see, are left out should it see them.  None where the program
recorded no spans (``pb_chime5_tpu_torch.utils.profiling.
recorded_spans()``, opened by ``record_stage_times()`` in ``--trace 1``
runs only) or the slice has no device time."""

from gss_bench.metrics.dispatch_host_ms_per_utt import kept

CALLING_THREAD = ('gss.session_setup', 'gss.prepare_wait', 'gss.dispatch',
                  'gss.write_wait')


def read(record):
    trace = record['trace']
    if not trace or trace['busy_s'] <= 0 or kept(record) is None:
        return None
    idle = trace['window_s'] - trace['busy_s']
    if idle <= 0:
        return None
    covered = sum(s for name, s in trace['idle_gaps']
                  if name in CALLING_THREAD)
    return 100.0 * (1.0 - covered / idle)
