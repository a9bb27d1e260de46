"""Host-scale session soak — the port of ``pb_chime5_tpu/testing/soak.py``.

A real CHiME-5 session is 2.5 h with 4-6k utterances (reference
README.md:108-113); the bench session is 420 s and 100.  A long session
stresses not the device chain (the same shapes every utterance) but the
host loop around it: the activity slicing per utterance, caches, the
prefetch and writer queues, the rolling session-audio window, and memory
drift, on the host and on the card.  An O(n) host cost is invisible at
100 utterances and fatal at 5k.

:func:`run_session_soak` builds a synthetic session of ``n`` short
utterances (the host's work per utterance does not depend on their
shape), drives the real ``enhance_session`` (serial or on a mesh) on
``device``, and records

* per-utterance completion-time deltas (the writer thread's completion
  stamps; the dispatch-ahead pipeline jitters single deltas, so judge
  windowed means),
* RSS every ``rss_every`` completions (/proc/self/status VmRSS), and on a
  card ``torch.cuda.memory_allocated`` at the same moments,
* the session-audio cache's stats over the run,

so that callers can assert the two production invariants: the wall per
utterance is flat in the utterance index, and memory is bounded after
the first window.
"""

import time
from pathlib import Path

import numpy as np
import torch

__all__ = ['run_session_soak', 'windowed_means', 'read_rss_mb']


def read_rss_mb():
    """Current VmRSS in MB (Linux; 0.0 where /proc is unavailable)."""
    try:
        with open('/proc/self/status') as fd:
            for line in fd:
                if line.startswith('VmRSS:'):
                    return int(line.split()[1]) / 1024.0
    except OSError:
        pass
    return 0.0


def windowed_means(deltas, window):
    """Mean of consecutive ``window``-sized chunks (tail partial chunk
    dropped) — the flatness statistic: completion-order jitter from the
    dispatch-ahead pipeline averages out within a window."""
    deltas = np.asarray(deltas, float)
    n = len(deltas) // window
    return deltas[:n * window].reshape(n, window).mean(axis=1)


def run_session_soak(
        work,
        *,
        num_utterances=1000,
        mesh=None,
        utterances_per_device=1,
        wpe=False,
        bss_iterations=2,
        context_samples=4000,
        length_buckets=(32000,),
        rss_every=50,
        seed=11,
        session_id='S02',
        cache_window_seconds=45.0,
        device='cuda',
):
    """Build an ``num_utterances``-utterance synthetic session under
    ``work`` and enhance it end-to-end; returns a stats dict:

    ``deltas_s``  (n,) completion-time deltas in completion order,
    ``rss_mb``    [(utterance_index, rss_mb), ...] sampled curve,
    ``span_s``    enhanced audio seconds,  ``wall_s`` total wall,
    ``cache``     session-audio-cache stats delta for the run,
    ``num_wavs``  outputs written (must equal ``num_utterances``),
    ``device_mb`` [(utterance_index, MB), ...] of
                  ``torch.cuda.memory_allocated`` beside each RSS sample
                  (empty off the card).

    Utterances are ~0.5-0.8 s in ~1 s slots (4 speakers round-robin), so
    the DEVICE work is trivial and the measured curve is the host loop.
    The cache window (default 45 s against a ~250 s+ session) forces the
    rolling-refill path to cycle many times, like production.
    """
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.testing import create_synthetic_chime5

    work = Path(work)
    per_speaker = -(-num_utterances // 4)        # 4 speakers per session
    # ~1 s slot per utterance + 2 s edge margin
    duration_s = per_speaker * 4 * 1.0 + 2.0
    create_synthetic_chime5(
        work / 'CHiME5', session_ids=(session_id,),
        duration_seconds=duration_s,
        utterances_per_speaker=per_speaker,
        num_arrays=1, num_array_mics=4, seed=seed, pcm16=True)
    dump_json(create_database(work / 'CHiME5'), work / 'chime5.json')

    enhancer = get_enhancer(
        database_path=str(work / 'chime5.json'),
        multiarray=True,
        wpe=wpe,
        bss_iterations=bss_iterations,
        context_samples=context_samples,
        length_buckets=tuple(length_buckets),
        cache_window_seconds=cache_window_seconds,
        device=device,
    )
    examples = list(enhancer.get_iterator(session_id))
    span_s = sum(ex['end']['original'] - ex['start']['original']
                 for ex in examples) / 16000.0

    stamps = []
    rss = []
    device_mb = []
    on_card = torch.device(device).type == 'cuda'

    def progress(example_id):
        stamps.append(time.perf_counter())
        if len(stamps) % rss_every == 0 or len(stamps) == 1:
            rss.append((len(stamps), read_rss_mb()))
            if on_card:
                device_mb.append((len(stamps), torch.cuda.memory_allocated(
                    device) / 2 ** 20))

    cache = enhancer._audio_cache
    before = dict(cache.stats) if cache is not None else {}
    t0 = time.perf_counter()
    enhancer.enhance_session(
        [session_id], work / 'out', audio_dir_exist_ok=True,
        progress=progress, mesh=mesh,
        utterances_per_device=utterances_per_device)
    wall = time.perf_counter() - t0
    delta = ({k: round(v - before.get(k, 0), 4)
              for k, v in cache.stats.items()} if cache is not None else {})

    wavs = list((work / 'out').rglob('*.wav'))
    return {
        'deltas_s': np.diff(np.asarray([t0] + stamps)),
        'rss_mb': rss,
        'span_s': span_s,
        'wall_s': wall,
        'cache': delta,
        'num_wavs': len(wavs),
        'num_examples': len(examples),
        'device_mb': device_mb,
    }
