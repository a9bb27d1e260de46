"""The em stage's CUDA-event window (``record_stage_times``),
averaged over the chains written before the profiled slice."""


def read(record):
    stages = record['stages']
    if not stages:
        return None
    return sum(call['em'] for call in stages) / len(stages)
