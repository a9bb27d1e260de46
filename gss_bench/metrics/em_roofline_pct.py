"""The em stage's least time on the card (``gss_bench/roofline.py``:
its least operations over 67 TFLOP/s float32 or its bytes over 3.35 TB/s,
whichever is larger) over its CUDA-event windows, summed over the chains
written before the profiled slice."""


def read(record):
    stages, least = record['stages'], record['least']
    if not stages or least is None:
        return None
    measured = sum(call['em'] for call in stages) / 1e3
    return None if measured <= 0 else 100.0 * least['em'] / measured
