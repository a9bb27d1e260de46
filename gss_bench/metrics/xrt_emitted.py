"""Seconds of emitted utterance audio whose WAV was written inside the
window, over the window's seconds (host clock)."""


def read(record):
    emitted = record['emitted_s']
    return sum(emitted[e] for _, e in record['written']) / record['window_s']
