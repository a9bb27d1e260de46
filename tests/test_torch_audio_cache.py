"""The port's session-audio cache (``pb_chime5_tpu_torch/models/
audio_cache.py``) on the CPU: in lock-step with the JAX
``SessionAudioCache`` over scripted sequences of lookups (the same
decisions, offsets, valid lengths, window content and stats, the two
seconds keys aside), and the twins of the JAX package's cache tests
(``tests/test_enhancer.py``: policy, prefetch, discard accounting and
``close``).

Between lookups the lock-step waits for each cache's prefetch worker to
finish, so an in-flight upload is always complete when it is adopted or
discarded and both caches account it the same way (whether a discarded
upload had started is a race in either package; the discard twin below
accepts both outcomes, as the JAX test does).
"""

import numpy as np
import pytest
import torch

from pb_chime5_tpu.models.audio_cache import (
    SessionAudioCache as JaxSessionAudioCache)
from pb_chime5_tpu_torch.io import audio_length, dump_audio, load_audio
from pb_chime5_tpu_torch.models.audio_cache import (
    CachedWindow, SessionAudioCache)

FS = 16000
CACHE = dict(window_seconds=4.0, margin_seconds=0.1, sample_rate=FS,
             prefetch=True, prefetch_lead_seconds=2.0)
SECONDS_KEYS = ('refill_s', 'prefetch_s')
# per-array clock drift (samples) of the 2-array session
DRIFT = (0, 37)


@pytest.fixture(scope='module')
def session(tmp_path_factory):
    """Two arrays of two per-channel PCM16 files, 40 s; array 1's second
    channel 100 samples shorter (the valid length is the min)."""
    root = tmp_path_factory.mktemp('cache_session')
    rng = np.random.default_rng(3)
    arrays = []
    for a in range(2):
        paths = []
        for c in range(2):
            path = root / f'U0{a + 1}.CH{c + 1}.wav'
            n = FS * 40 - (100 if (a, c) == (1, 1) else 0)
            dump_audio(rng.standard_normal(n) * 0.1, path)
            paths.append(str(path))
        arrays.append(tuple(paths))
    return arrays


def spans_of(arrays, start, n):
    return [(paths, start + d, start + d + n, slice(None))
            for paths, d in zip(arrays, DRIFT)]


def settle(cache):
    """Wait until every upload the cache's worker took has finished and
    its done-callbacks ran (one worker: a no-op behind them)."""
    if cache._executor is not None:
        cache._executor.submit(lambda: None).result()


def policy_state(cache):
    return (cache._key, cache._bases, cache._disabled,
            cache._wasteful_refills, cache._hit_samples_since_refill,
            cache._armed, cache._prefetch_dead, cache._max_npad,
            None if cache._pending is None else cache._pending['bases'])


def same_stats(a, b):
    keys = set(a) - set(SECONDS_KEYS)
    assert set(a) == set(b)
    return {k: a[k] for k in keys} == {k: b[k] for k in keys}


def in_lock_step(arrays, script):
    """Run ``script`` ((session, start s, n s) or 'new_run') through both
    caches, comparing after every step; returns the port's cache."""
    jax_cache = JaxSessionAudioCache(device_put=lambda a: a, **CACHE)
    port = SessionAudioCache(device='cpu', **CACHE)
    for step in script:
        for cache in (jax_cache, port):
            settle(cache)
        if step == 'new_run':
            jax_cache.new_run()
            port.new_run()
            got = want = None
        else:
            session, start, n = step
            spans = spans_of(arrays, int(start * FS), int(n * FS))
            want = jax_cache.lookup(session, spans)
            got = port.lookup(session, spans)
        for cache in (jax_cache, port):
            settle(cache)
        assert (got is None) == (want is None), (step, port.stats)
        if got is not None:
            assert isinstance(got, CachedWindow)
            np.testing.assert_array_equal(got.offsets, want.offsets)
            assert got.offsets.dtype == want.offsets.dtype
            assert got.num_valid_samples == want.num_valid_samples
            assert isinstance(got.buf, torch.Tensor)
            np.testing.assert_array_equal(got.buf.numpy(),
                                          np.asarray(want.buf))
            # the slice is the file content at the array's start
            N, (paths, s, _e, _sel) = got.num_valid_samples, spans[1]
            o = got.offsets[1]
            np.testing.assert_array_equal(
                got.buf.numpy()[2:, o:o + N],
                load_audio(list(paths), start=s, stop=s + N, dtype=None))
        assert policy_state(port) == policy_state(jax_cache), step
        assert same_stats(port.stats, jax_cache.stats), \
            (step, port.stats, jax_cache.stats)
    jax_cache.close()
    port.close()
    return port


SCRIPTS = {
    # dense hits, a forward refill, a sparse traversal up to the disable,
    # a session change, an utterance longer than the window, new_run,
    # and a refill at the session tail (a short read padded with zeros)
    'policy': [('S', 0, 1), ('S', 0.5, 1), ('S', 1, 1), ('S', 2, 1),
               ('S', 2.5, 1), ('S', 10, 1), ('S', 11, 1), ('S', 16, 1),
               ('S', 17, 1), ('S', 22, 1), ('S', 23, 1), ('S2', 0, 1),
               ('S2', 0, 5), 'new_run', ('S2', 0, 1), ('S2', 38.5, 2.5),
               ('S2', 39.5, 2)],
    # time-ordered 1 s observations every 0.4 s: prefetched windows adopted
    'ordered': [('S', 0.4 * i, 1) for i in range(40)],
    # jumps past the window discard the prefetch, twice: prefetch stops
    'mispredict': [('S', pos + 0.4 * i, 1) for pos in (0.0, 12.4, 24.8)
                   for i in range(6)] + [('S', 36.8, 1)],
}


@pytest.mark.parametrize('name', sorted(SCRIPTS))
def test_lock_step_with_jax(session, name):
    port = in_lock_step(session, SCRIPTS[name])
    s = port.stats
    if name == 'policy':
        assert port._key == 'S2' and not port._disabled, s
        assert (s['hits'], s['refills'], s['direct'], s['prefetch_wasted']) \
            == (7, 6, 3, 1), s
    elif name == 'ordered':
        assert s['prefetch_hits'] >= 2 and s['prefetch_wasted'] == 0, s
    else:
        assert port._prefetch_dead == 2 and s['prefetch_wasted'] == 2, s
        assert port._pending is None


def test_audio_length_and_tail_fill(session):
    paths = session[1]
    assert [audio_length(p) for p in paths] == [FS * 40, FS * 40 - 100]
    x = load_audio(paths[1], start=FS * 40 - 300, stop=FS * 40 + 50,
                   dtype=None, fill_value=0)
    assert x.shape == (350,) and x.dtype == np.int16
    np.testing.assert_array_equal(x[:200], load_audio(
        paths[1], start=FS * 40 - 300, dtype=None))
    assert not x[200:].any()
    assert load_audio(paths[1], start=FS * 40 - 300, stop=FS * 40 + 50,
                      dtype=None).shape == (200,)
    stacked = load_audio(list(paths), start=FS * 40 - 300,
                         stop=FS * 40 + 50, dtype=None, fill_value=0)
    assert stacked.shape == (2, 350) and not stacked[1, 200:].any()


def _mono(tmp_path, name, seconds, seed):
    wav = tmp_path / name
    dump_audio(np.random.default_rng(seed).standard_normal(FS * seconds)
               * 0.1, wav)
    return wav


def test_audio_cache_policy(tmp_path):
    """Forward advance refills, two consecutive wasteful refills disable,
    a session change and new_run() reset."""
    wav = _mono(tmp_path, 'long.wav', 30, 0)

    def spans(start, n):
        return [((str(wav),), start, start + n, slice(None))]

    c = SessionAudioCache(window_seconds=4.0, margin_seconds=0.1,
                          sample_rate=FS, device='cpu')
    n = FS  # 1 s utterances
    r = c.lookup('S', spans(0, n))
    assert r is not None and c.stats['refills'] == 1
    assert r.num_valid_samples == n
    direct = load_audio(wav, start=0, stop=n, dtype=None)
    got = r.buf.numpy()[0, r.offsets[0]:r.offsets[0] + n]
    np.testing.assert_array_equal(got, direct)
    for s in (1, 2, 2, 3):                                 # 4 s of hits
        assert c.lookup('S', spans(s * FS, n)).offsets[0] >= 0
    assert c.stats['hits'] == 4 and c.stats['refills'] == 1
    assert c.lookup('S', spans(10 * FS, n)) is not None    # refill 2
    assert c.stats['refills'] == 2 and c._wasteful_refills == 0
    assert c.lookup('S', spans(11 * FS, n)) is not None    # hit
    assert c.lookup('S', spans(16 * FS, n)) is not None    # wasteful 1
    assert c.lookup('S', spans(17 * FS, n)) is not None    # hit
    assert c.lookup('S', spans(22 * FS, n)) is None        # wasteful 2
    assert c.lookup('S', spans(23 * FS, n)) is None        # disabled now
    assert c._disabled
    assert c.lookup('S2', spans(0, n)) is not None         # new session
    assert c.lookup('S2', spans(0, 5 * FS)) is None        # too long
    c._disabled = True
    c._key = 'S2'
    assert c.lookup('S2', spans(0, n)) is None             # still off
    c.new_run()
    assert c.lookup('S2', spans(0, n)) is not None         # re-enabled
    assert not c._disabled


def test_audio_cache_prefetch(tmp_path):
    """On a time-ordered schedule a refill is served by the prefetched
    window (slices stay exact); mispredictions stop prefetching after
    two discards."""
    wav = _mono(tmp_path, 'long.wav', 40, 1)

    def spans(start, n):
        return [((str(wav),), start, start + n, slice(None))]

    c = SessionAudioCache(device='cpu', **CACHE)
    n, step = FS, int(0.4 * FS)
    for i in range(24):
        r = c.lookup('S', spans(i * step, n))
        assert r is not None, (i, c.stats)
        direct = load_audio(wav, start=i * step, stop=i * step + n,
                            dtype=None)
        got = r.buf.numpy()[0, r.offsets[0]:r.offsets[0] + n]
        np.testing.assert_array_equal(got, direct, err_msg=str(i))
    s = c.stats
    assert s['refills'] >= 2, s
    assert s['prefetch_hits'] >= 1, s
    assert s['prefetch_wasted'] == 0, s
    assert s['refill_mb'] >= s['refills'] * 4 * FS * 2 / 1e6 * 0.99

    c2 = SessionAudioCache(device='cpu', **CACHE)
    pos = 0
    for _ in range(3):
        for i in range(6):                    # hits arm the prefetch
            assert c2.lookup('S', spans(pos + i * step, n)) is not None
        pos += 12 * FS                        # jump far past the window
        assert c2.lookup('S', spans(pos, n)) is not None
        pos += step
    assert c2.stats['prefetch_wasted'] == 2, c2.stats
    assert c2._prefetch_dead == 2
    assert c2._pending is None


def test_audio_cache_seconds_are_its_spans(tmp_path):
    """Inside a span recording the time-ordered schedule leaves one
    ``cache.refill`` a synchronous refill, one ``cache.adopt_wait`` an
    adopted prefetch and one ``cache.prefetch`` an upload on the worker
    thread; ``refill_s`` and ``prefetch_s`` are those spans' seconds."""
    from pb_chime5_tpu_torch.utils.profiling import (
        record_spans, recorded_spans)
    wav = _mono(tmp_path, 'long3.wav', 40, 3)

    def spans(start, n):
        return [((str(wav),), start, start + n, slice(None))]

    c = SessionAudioCache(device='cpu', **CACHE)
    n, step = FS, int(0.4 * FS)
    with record_spans():
        for i in range(24):
            assert c.lookup('S', spans(i * step, n)) is not None
            settle(c)
    c.close()
    s = c.stats
    assert s['prefetch_hits'] >= 1 and s['prefetch_wasted'] == 0, s
    recorded = recorded_spans()
    seconds = {}
    for name in ('cache.refill', 'cache.adopt_wait', 'cache.prefetch'):
        durations = [(x.end_ns - x.start_ns) / 1e9 for x in recorded
                     if x.name == name]
        seconds[name] = sum(round(d, 4) for d in durations)
        count = {'cache.refill': s['refills'] - s['prefetch_hits'],
                 'cache.adopt_wait': s['prefetch_hits'],
                 'cache.prefetch': s['prefetch_hits']}[name]
        assert len(durations) == count, (name, s)
    assert s['refill_s'] == pytest.approx(
        seconds['cache.refill'] + seconds['cache.adopt_wait'], abs=1e-9)
    assert s['prefetch_s'] == pytest.approx(seconds['cache.prefetch'],
                                            abs=1e-9)
    threads = {x.name: x.thread for x in recorded}
    assert threads['cache.prefetch'] != threads['cache.refill']


def test_audio_cache_discard_accounting_and_close(tmp_path):
    """An in-flight prefetch dropped by new_run() is charged to refill_mb
    + prefetch_wasted once it lands (or, cancelled before it started,
    not at all); close() is idempotent and stops the worker."""
    wav = _mono(tmp_path, 'long2.wav', 40, 2)

    def spans(start, n):
        return [((str(wav),), start, start + n, slice(None))]

    c = SessionAudioCache(device='cpu', **CACHE)
    n, step = FS, int(0.4 * FS)
    for i in range(6):                          # arm + start a prefetch
        assert c.lookup('S', spans(i * step, n)) is not None
    assert c._pending is not None
    mb_before = c.stats['refill_mb']
    c.new_run()
    assert c._pending is None
    c._executor.shutdown(wait=True)
    window_mb = 4 * FS * 2 / 1e6
    if c.stats['prefetch_wasted']:
        assert c.stats['refill_mb'] >= mb_before + 0.9 * window_mb, c.stats
    else:
        assert c.stats['refill_mb'] == mb_before, c.stats
    c.close()
    c.close()
    assert c._executor is None and c._finalizer is None


def test_cuda_cache_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError):
        SessionAudioCache(device='cuda')
