"""The mean ``gss.prepare_wait`` span: how long the calling thread of
``async_session_pump`` waited for an utterance's ``gss.prepare`` on the
prefetch thread (its read, or the session-audio cache's lookup with its
``cache.refill`` or ``cache.adopt_wait``).  From
``pb_chime5_tpu_torch.utils.profiling.recorded_spans()``, recorded by
``record_stage_times()`` in ``--trace 1`` runs only, over the spans
that ended before the profiled slice (``dispatch_host_ms_per_utt.py``)."""

from gss_bench.metrics.dispatch_host_ms_per_utt import mean_ms


def read(record):
    return mean_ms(record, 'gss.prepare_wait')
