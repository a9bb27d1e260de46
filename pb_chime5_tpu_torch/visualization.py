"""Session activity visualization.

The reference's pb_chime5/database/chime5/visualization.py imports dead
``nt.*`` modules (visualization.py:13-23) and is documented legacy
(SURVEY.md section 2).  This is a *working* minimal equivalent: plot the
per-speaker activity tracks of a session, and summarize overlap
statistics as a table.

The port's copy of ``pb_chime5_tpu/visualization.py``.
"""

import numpy as np

__all__ = ['plot_activity', 'overlap_statistics']


def plot_activity(activity, *, sample_rate=16000, resolution=16000,
                  ax=None, speakers=None):
    """Plot {speaker: ArrayInterval | bool array} as horizontal bars.

    ``resolution``: samples per plotted bin (default 1 s).
    Returns the matplotlib axis.
    """
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(14, 0.6 * len(activity) + 1))
    if speakers is None:
        speakers = [k for k in activity.keys()]
    for row, speaker in enumerate(speakers):
        track = activity[speaker]
        n = len(track)
        dense = track[0:n] if hasattr(track, 'intervals') else \
            np.asarray(track, dtype=bool)
        bins = dense[:n - n % resolution].reshape(-1, resolution).any(-1)
        starts = np.nonzero(np.diff(np.r_[0, bins.view(np.int8)]) > 0)[0]
        ends = np.nonzero(np.diff(np.r_[bins.view(np.int8), 0]) < 0)[0] + 1
        for s, e in zip(starts, ends):
            ax.barh(row, (e - s) * resolution / sample_rate,
                    left=s * resolution / sample_rate, height=0.6)
    ax.set_yticks(range(len(speakers)))
    ax.set_yticklabels(speakers)
    ax.set_xlabel('time / s')
    return ax


def overlap_statistics(activity, *, chunk=16000):
    """{speaker: track} -> dict with silence / 1..K-speaker-overlap
    fractions, computed at ``chunk`` resolution."""
    speakers = [k for k in activity.keys() if k.startswith('P')]
    if not speakers:
        speakers = list(activity.keys())
    n = min(len(activity[s]) for s in speakers)
    n -= n % chunk
    counts = np.zeros(n // chunk, np.int32)
    for s in speakers:
        track = activity[s]
        dense = track[0:n] if hasattr(track, 'intervals') else \
            np.asarray(track, dtype=bool)[:n]
        counts += dense.reshape(-1, chunk).any(-1)
    total = len(counts)
    stats = {'silence': float(np.mean(counts == 0))}
    for k in range(1, len(speakers) + 1):
        stats[f'{k}_active'] = float(np.mean(counts == k))
    stats['overlap'] = float(np.mean(counts >= 2))
    stats['chunks'] = total
    return stats
