"""The share of the wall outside every chain's stage windows (CUDA events
from ``record_stage_times``): how long the stream waits on the host
between chains.  Over the chains written before the profiled slice, from
the window's start to the last of their WAVs."""


def read(record):
    stages = record['stages']
    if not stages or not record['stages_wall_s']:
        return None
    inside = sum(sum(call.values()) for call in stages) / 1e3
    return 100.0 * (1.0 - inside / record['stages_wall_s'])
