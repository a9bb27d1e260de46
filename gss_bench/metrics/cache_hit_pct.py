"""The session-audio cache's hits among its lookups over the block
(``hits / (hits + refills + direct)`` of its ``stats``)."""


def read(record):
    cache = record['cache']
    if not cache:
        return None
    lookups = cache['hits'] + cache['refills'] + cache['direct']
    return None if lookups == 0 else 100.0 * cache['hits'] / lookups
