"""Per-stage wall timing and the profiler trace — the port of
``pb_chime5_tpu/utils/profiling.py``: ``StageTimer`` unchanged,
``trace`` on ``torch.profiler``, ``device_sync`` as a CUDA
synchronization of the devices a tree's tensors lie on.
"""

import contextlib
import time
from pathlib import Path

import torch

__all__ = ['StageTimer', 'trace', 'device_sync']


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _tensors(value)


def device_sync(tree):
    """Wait for the work queued on every CUDA device that a tensor of
    ``tree`` (nested dicts, lists and tuples) lies on; CPU tensors and
    other leaves need none.  Returns ``tree``."""
    devices = {t.device for t in _tensors(tree) if t.device.type == 'cuda'}
    for device in devices:
        torch.cuda.synchronize(device)
    return tree


class StageTimer:
    """Accumulate wall-clock per named stage.

    >>> timer = StageTimer()
    >>> with timer('stft'):
    ...     pass
    >>> 'stft' in timer.totals()
    True
    """

    def __init__(self, sync=False):
        self._acc = {}
        self._counts = {}
        self.sync = sync

    @contextlib.contextmanager
    def __call__(self, name, result=None):
        start = time.perf_counter()
        try:
            yield
        finally:
            if self.sync and result is not None:
                device_sync(result)
            dt = time.perf_counter() - start
            self._acc[name] = self._acc.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def totals(self):
        return dict(self._acc)

    def report(self):
        width = max((len(k) for k in self._acc), default=0)
        return '\n'.join(
            f'{k:<{width}}  {v:8.3f} s  ({self._counts[k]} calls)'
            for k, v in sorted(self._acc.items(), key=lambda kv: -kv[1]))


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` over the block, host ops and (where there is a
    card) CUDA kernels, written as a Chrome trace
    ``log_dir/trace.json`` (open it in Perfetto or chrome://tracing).
    Yields the profiler, whose ``key_averages()`` sums by op and
    kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()     # the block's kernels end inside
    prof.export_chrome_trace(str(log_dir / 'trace.json'))
