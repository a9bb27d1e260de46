"""The 95th percentile (nearest rank) of the latencies of the Kaldi-style
jobs that ended inside the window, before the profiled slice: each from
its ``enhance_session`` call until the call returned with every WAV
written (host clock)."""

import math


def read(record):
    jobs = record['jobs_ms']
    if not jobs:
        return None
    return sorted(jobs)[math.ceil(0.95 * len(jobs)) - 1]
