"""The mean ``gss.dispatch`` span: the calling thread's host time to
dispatch an utterance, its children inside (``gss.activity``, the
activity and context frames; ``gss.upload``; ``gss.enqueue``, the
chain's host side and the download's enqueue).

The span metrics read ``pb_chime5_tpu_torch.utils.profiling.
recorded_spans()``, recorded over the window by
``models.gss.record_stage_times()``, which the harness opens in
``--trace 1`` runs only.  Kept are the spans that ended before the
first span the profiler saw (``profiled``, the calling thread's in the
window's last seconds): the chains the stage metrics read, with none of
the profiler's own cost.  A program without spans gives None; the other
span metrics import ``kept`` and ``mean_ms`` from here.  A cell on
several cards reads the spans that its ranks kept, each at its own cut,
all in one pool (the record's ``spans``, ``gss_bench/ranks.py``): a
mean is then over every rank's spans."""

import collections

Kept = collections.namedtuple('Kept', 'name start_ns end_ns')


def kept(record):
    """The kept spans, or None where the program recorded none: the
    record's ``spans`` where it carries them, else the process's."""
    if record.get('spans') is not None:
        return [Kept(*s) for s in record['spans']]
    try:
        from pb_chime5_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    spans = recorded_spans()
    if not spans:
        return None
    cut = min((s.start_ns for s in spans if s.profiled), default=None)
    return [s for s in spans if s.end_ns is not None
            and (cut is None or s.end_ns < cut)]


def mean_ms(record, name):
    """The mean duration of the kept spans ``name`` in ms, or None."""
    spans = kept(record)
    if spans is None:
        return None
    durations = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return sum(durations) / len(durations) / 1e6 if durations else None


def read(record):
    return mean_ms(record, 'gss.dispatch')
