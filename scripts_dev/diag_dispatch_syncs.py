"""Which host calls of one dispatch wait for the card: a cached and a
direct ``GssPipeline`` dispatch (``tests/test_torch_audio_cache_cuda.py``'s
small scene and config), each enqueued behind ~0.9 s of large matmuls and
profiled with ``torch.profiler``; prints the CPU ops and CUDA runtime
calls with the largest self time (a ``cudaStreamSynchronize`` there is a
wait of the host for the card).  One card.

    python scripts_dev/diag_dispatch_syncs.py
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pb_chime5_tpu_torch.models.audio_cache import (  # noqa: E402
    SessionAudioCache)
from pb_chime5_tpu_torch.models.gss import GssPipeline  # noqa: E402
from tests.test_torch_audio_cache_cuda import (  # noqa: E402
    CONFIG, N_PAD, scene)


def main():
    pipe = GssPipeline(CONFIG, length_buckets=(N_PAD,), device='cuda')
    cache = SessionAudioCache(device='cuda')
    pcm, act = scene(0)
    N = pcm.shape[1]
    window = np.zeros((4, N_PAD + 4000), np.int16)
    window[:, 100:100 + N] = pcm
    buf = cache.upload(window)
    offsets = np.array([100, 100])
    for _ in range(2):                                   # warm-up
        pipe.gather(pipe.dispatch_cached(buf, offsets, N, act, 0))
        pipe.gather(pipe.dispatch(pcm, act, 0))
    torch.cuda.synchronize()
    a = torch.randn(8192, 8192, device='cuda')
    b = torch.empty_like(a)
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities):
        pass                                 # the profiler's first start
    for name, dispatch in (
            ('cached', lambda: pipe.dispatch_cached(buf, offsets, N, act,
                                                    0)),
            ('direct', lambda: pipe.dispatch(pcm, act, 0))):
        for _ in range(40):
            torch.mm(a, a, out=b)
        with torch.profiler.profile(activities=activities) as prof:
            handle = dispatch()
        pipe.gather(handle)
        torch.cuda.synchronize()
        print(f'== {name}', flush=True)
        print(prof.key_averages().table(sort_by='self_cpu_time_total',
                                        row_limit=12,
                                        max_name_column_width=50),
              flush=True)


if __name__ == '__main__':
    main()
