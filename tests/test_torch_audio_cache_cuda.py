"""The session-audio cache on the card: the window's upload on the cache's
own stream, and the cached dispatch against the direct one, bit for bit,
while windows are uploaded and dropped with dispatches still queued (the
window's memory goes back to the upload stream's pool when the cache
drops it; ``GssPipeline.dispatch_cached`` records it on the compute
stream, so the allocator cannot hand it to the next upload before the
queued slices have read it).

Marked ``cuda`` and skipped without a CUDA device; run on a machine with
an H100 with ``python -m pytest --noconftest
tests/test_torch_audio_cache_cuda.py`` (``tests/conftest.py`` imports
JAX).  ``chip_smoke.py`` phase 8 holds the same contract on a 420 s
session at full width.
"""

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch import _device
from pb_chime5_tpu_torch.models.audio_cache import SessionAudioCache
from pb_chime5_tpu_torch.models.gss import GssConfig, GssPipeline
from pb_chime5_tpu_torch.utils import activity_time_to_frequency

pytestmark = pytest.mark.cuda

CONFIG = GssConfig(bss_iterations=3)
N_PAD = 64000


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    _device.assert_precision()
    return torch.device('cuda')


def scene(seed, D=4, N=48000):
    """int16 PCM of two modulated noise sources mixed into D channels and
    their (3, T) activity (speaker 0 first, speaker 1 last, noise)."""
    rng = np.random.default_rng(seed)
    env = rng.uniform(0.3, 1.0, N // 800 + 1).repeat(800)[:N]
    s0, s1 = rng.standard_normal(N) * env, rng.standard_normal(N) * env[::-1]
    s0[int(0.55 * N):] = 0
    s1[:int(0.45 * N)] = 0
    mix = rng.standard_normal((D, 2)) @ np.stack([s0, s1])
    mix += 0.02 * rng.standard_normal((D, N))
    pcm = (mix / np.abs(mix).max() * 2 ** 14).astype(np.int16)
    activity = np.zeros((3, N), bool)
    activity[0, :int(0.55 * N)] = activity[1, int(0.45 * N):] = True
    activity[2] = True
    return pcm, activity_time_to_frequency(
        activity, CONFIG.stft_size, CONFIG.stft_shift, stft_fading=True,
        stft_pad=True)


def test_upload_is_complete_and_on_the_card(cuda):
    cache = SessionAudioCache(device='cuda')
    host = np.random.default_rng(0).integers(
        -2 ** 15, 2 ** 15, (24, 160000)).astype(np.int16)
    buf = cache.upload(host)
    assert buf.device.type == 'cuda' and buf.dtype == torch.int16
    assert buf.is_contiguous() and buf.shape == host.shape
    np.testing.assert_array_equal(buf.cpu().numpy(), host)


def test_cached_dispatch_with_windows_dropped_in_flight(cuda):
    """Eight windows, each uploaded on the cache's stream, dispatched
    from and dropped while the compute stream is still busy with earlier
    work (large matmuls enqueued first, so the first dispatches are still
    queued when the next windows are uploaded into memory the allocator
    may hand out again); every output equals the direct dispatch of the
    same utterance (without the window's ``record_stream`` in
    ``dispatch_cached``, they differ on an H100)."""
    pipe = GssPipeline(CONFIG, length_buckets=(N_PAD,), device='cuda')
    cache = SessionAudioCache(device='cuda')
    rng = np.random.default_rng(1)
    trim = (1500, 25000)
    utterances = []
    for i in range(8):
        pcm, act = scene(i)
        N = pcm.shape[1]
        offsets = rng.integers(0, 4000, 2)
        window = rng.integers(-2 ** 15, 2 ** 15,
                              (4, N_PAD + 4000)).astype(np.int16)
        for a, off in enumerate(offsets):
            window[2 * a:2 * a + 2, off:off + N] = pcm[2 * a:2 * a + 2]
        utterances.append((pcm, act, i % 2, offsets, window))
    # both paths once first: a kernel's first launch may wait for the card
    pcm, act, target, offsets, window = utterances[0]
    pipe.gather(pipe.dispatch(pcm, act, target))
    pipe.gather(pipe.dispatch_cached(cache.upload(window), offsets,
                                     pcm.shape[1], act, target))
    torch.cuda.synchronize()
    a = torch.randn(8192, 8192, device=cuda)
    b = torch.empty_like(a)
    for _ in range(80):                   # ~1 s of work on the stream
        torch.mm(a, a, out=b)
    blocker_done = torch.cuda.Event()
    blocker_done.record()
    handles = []
    for i, (pcm, act, target, offsets, window) in enumerate(utterances):
        buf = cache.upload(window)
        if i == 1:          # window 0 dropped, its dispatch still queued?
            queued = not blocker_done.query()
        handles.append(pipe.dispatch_cached(buf, offsets, pcm.shape[1], act,
                                            target, trim=trim))
        del buf                      # the cache drops its window
    # (later dispatches may wait: the launch queue holds ~3 chains)
    assert queued, 'the first dispatch was not queued behind the matmuls'
    cached = [pipe.gather(h) for h in handles]
    for x, (pcm, act, target, _o, _w) in zip(cached, utterances):
        want = pipe.gather(pipe.dispatch(pcm, act, target, trim=trim))
        assert x.shape == (trim[1],) and np.isfinite(x).all()
        np.testing.assert_array_equal(x, want)
