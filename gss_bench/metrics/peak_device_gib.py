"""The allocator's peak over the window (``max_memory_allocated`` after
``reset_peak_memory_stats`` at its start), in GiB."""


def read(record):
    peak = record['peak_bytes']
    return None if peak is None else peak / 2 ** 30
