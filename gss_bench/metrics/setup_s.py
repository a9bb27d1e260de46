"""Seconds from the start of the run to the window: the corpus, the
database, the enhancer, its warm-up and any library build (host clock)."""


def read(record):
    return record['setup_s']
