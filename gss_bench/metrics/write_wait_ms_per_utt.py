"""The calling thread's ``gss.write_wait`` spans (its waits for the
writer thread to write an utterance ``write_ahead`` back, and the final
ones of each call), summed, over the count of ``gss.dispatch`` spans:
the drains are not one an utterance.  From
``pb_chime5_tpu_torch.utils.profiling.recorded_spans()``, recorded by
``record_stage_times()`` in ``--trace 1`` runs only, over the spans
that ended before the profiled slice (``dispatch_host_ms_per_utt.py``)."""

from gss_bench.metrics.dispatch_host_ms_per_utt import kept


def read(record):
    spans = kept(record)
    if spans is None:
        return None
    dispatched = sum(s.name == 'gss.dispatch' for s in spans)
    if not dispatched:
        return None
    return sum(s.end_ns - s.start_ns for s in spans
               if s.name == 'gss.write_wait') / dispatched / 1e6
