"""The mean ``gss.session_setup`` span, one an ``enhance_session`` call:
the session iterator, the dataset slice, the shard, the time-order
sort, the output directories and the cache's ``new_run``.  From
``pb_chime5_tpu_torch.utils.profiling.recorded_spans()``, recorded by
``record_stage_times()`` in ``--trace 1`` runs only, over the spans
that ended before the profiled slice (``dispatch_host_ms_per_utt.py``)."""

from gss_bench.metrics.dispatch_host_ms_per_utt import mean_ms


def read(record):
    return mean_ms(record, 'gss.session_setup')
