"""The straggler wait of the split, a cell on several cards: for each
call that every rank ended before the profiled slice, each rank's wait
from its own call end to the last rank's (host clock, one monotonic clock
for the node), averaged over the ranks and calls.  The wait falls in the
ranks' agreement after the call or the next call's ``raise_together``."""


def read(record):
    ends = record.get('call_ends')
    if not ends or len(ends) < 2:
        return None
    cut = record['traced_from_s']
    calls = min(sum(1 for end in rank if end < cut) for rank in ends)
    if not calls:
        return None
    waits = [max(rank[i] for rank in ends) - rank[i]
             for i in range(calls) for rank in ends]
    return 1e3 * sum(waits) / len(waits)
