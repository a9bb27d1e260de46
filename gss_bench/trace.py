"""Device busy and idle time from a ``torch.profiler`` trace.

The interval arithmetic is a copy of ``chip_smoke.py``'s ``union_of`` and
``idle_attribution``: the device is busy where any device event (kernel,
copy, set) runs, idle elsewhere in the traced span, and each idle stretch
is charged to the host ops that ran meanwhile.
"""

import bisect

__all__ = ['union_of', 'idle_attribution', 'summarize']


def union_of(spans):
    """Disjoint sorted [lo, hi] intervals covering ``spans``."""
    union = []
    for lo, hi in sorted(spans):
        if union and lo <= union[-1][1]:
            union[-1][1] = max(union[-1][1], hi)
        else:
            union.append([lo, hi])
    return union


def idle_attribution(device_spans, host_ops, span):
    """Idle time of the device inside ``span`` (start, end), and who had
    the host meanwhile: ``device_spans`` [(start, end)], ``host_ops``
    [(name, start, end)], all in the same unit -> (idle, {op: idle while
    it ran, the largest first, with 'no host op' for the idle time in
    which none ran})."""
    union = union_of(device_spans)
    starts = [lo for lo, _ in union]

    def idle_in(lo, hi):
        lo, hi = max(lo, span[0]), min(hi, span[1])
        if hi <= lo:
            return 0.0
        covered = 0.0
        i = max(bisect.bisect_right(starts, lo) - 1, 0)
        while i < len(union) and union[i][0] < hi:
            covered += max(0.0, min(hi, union[i][1]) - max(lo, union[i][0]))
            i += 1
        return (hi - lo) - covered
    idle = idle_in(*span)
    by_op = {}
    for name, lo, hi in host_ops:
        by_op[name] = by_op.get(name, 0.0) + idle_in(lo, hi)
    held = sum(idle_in(lo, hi)
               for lo, hi in union_of((lo, hi) for _, lo, hi in host_ops))
    by_op['no host op'] = idle - held
    return idle, dict(sorted(((k, v) for k, v in by_op.items() if v > 0),
                             key=lambda kv: -kv[1]))


def summarize(device_events, host_ops, span, top=10):
    """``device_events`` [(name, start_us, end_us)], ``host_ops`` top-level
    [(name, start_us, end_us)], ``span`` (start_us, end_us) -> {'busy_s',
    'window_s', 'device_ops': [[name, s]], 'idle_gaps': [[name, s]]},
    device events clipped to the span."""
    lo, hi = span
    clipped = [(max(s, lo), min(e, hi)) for _, s, e in device_events
               if e > lo and s < hi]
    busy = sum(b - a for a, b in union_of(clipped))
    totals = {}
    for name, s, e in device_events:
        if e > lo and s < hi:
            totals[name] = totals.get(name, 0.0) + min(e, hi) - max(s, lo)
    _, by_op = idle_attribution(clipped, host_ops, span)
    return {
        'busy_s': busy / 1e6, 'window_s': (hi - lo) / 1e6,
        'device_ops': [[n, v / 1e6] for n, v in sorted(
            totals.items(), key=lambda kv: -kv[1])[:top]],
        'idle_gaps': [[n, v / 1e6] for n, v in list(by_op.items())[:top]]}
