"""The session-audio cache's refill and prefetch seconds (host read and
upload) over the block, per utterance written in it."""


def read(record):
    cache = record['cache']
    if not cache or not record['written_all']:
        return None
    return 1e3 * (cache['refill_s'] + cache['prefetch_s']) \
        / record['written_all']
