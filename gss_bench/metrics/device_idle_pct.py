"""The device's idle share of the profiled slice (the window's last
seconds): 1 - (union of the device events' intervals) / the slice."""


def read(record):
    trace = record['trace']
    if not trace or trace['busy_s'] <= 0:
        return None
    return 100.0 * (1.0 - trace['busy_s'] / trace['window_s'])
