"""Host-level utterance scheduling — port of
``pb_chime5_tpu/parallel/scheduler.py`` (no JAX there; the port keeps its
own copy).

* ``length_balanced_shard`` — deterministic snake assignment of
  length-sorted utterances across processes: near-optimal balance with
  zero coordination (the default of ``Enhancer.enhance_session``).
* ``strided_shard`` — the reference's Kaldi ``job_id`` / ``number_of_jobs``
  striding (reference kaldi_run.py:73-76).
* ``FileQueueScheduler`` — dynamic pull scheduling through an atomic
  claim-file protocol on a shared filesystem, for restartable runs (any
  number of workers; finished outputs are skipped, claims are re-claimed
  after a timeout).

The process index and count come from ``torch.distributed`` when it is
initialized with more than one process (``parallel/distributed.py``),
else from the Kaldi-style ``PB_JOB_ID`` (1-based) / ``PB_NUM_JOBS``
environment, else ``(0, 1)``.
"""

import os
import time
from pathlib import Path

__all__ = ['process_info', 'serial_shard', 'strided_shard',
           'length_balanced_shard', 'FileQueueScheduler']


def process_info():
    """(process_index, process_count): ``torch.distributed``'s rank and
    world size when it is initialized with more than one process, else
    ``(PB_JOB_ID - 1, PB_NUM_JOBS)`` from the environment, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return dist.get_rank(), dist.get_world_size()
    if 'PB_JOB_ID' in os.environ:
        return (int(os.environ['PB_JOB_ID']) - 1,
                int(os.environ['PB_NUM_JOBS']))
    return 0, 1


def serial_shard(items, *_args, **_kwargs):
    """Identity shard matching the ``shard_fn(examples, length_fn)``
    contract of ``Enhancer.enhance_session`` (the length_fn is ignored)."""
    return list(items)


def strided_shard(items, process_index=None, process_count=None):
    """``items[process_index::process_count]`` (reference
    kaldi_run.py:73-76, where job_id is 1-based)."""
    if process_index is None:
        process_index, process_count = process_info()
    return list(items)[process_index::process_count]


def length_balanced_shard(items, length_fn, process_index=None,
                          process_count=None):
    """Snake-order assignment of length-sorted items across processes
    (0, 1, ..., P-1, P-1, ..., 0, ...): nearly equal total length per
    process, deterministic, original order kept within a shard."""
    if process_index is None:
        process_index, process_count = process_info()
    items = list(items)
    order = sorted(range(len(items)), key=lambda i: -length_fn(items[i]))
    mine = []
    for rank, idx in enumerate(order):
        cycle, pos = divmod(rank, process_count)
        target = pos if cycle % 2 == 0 else process_count - 1 - pos
        if target == process_index:
            mine.append(idx)
    return [items[i] for i in sorted(mine)]


class FileQueueScheduler:
    """Dynamic work distribution through atomic claim files.

    Workers race to ``O_CREAT | O_EXCL`` a claim file per item; the winner
    processes the item and writes a done marker.  Crash recovery: claims
    older than ``stale_seconds`` without a done marker may be re-claimed.
    Idempotent and restartable, like the reference's re-run with
    ``audio_dir_exist_ok``.
    """

    def __init__(self, queue_dir, *, stale_seconds=3600.0, worker_id=None):
        self.queue_dir = Path(queue_dir)
        self.queue_dir.mkdir(parents=True, exist_ok=True)
        self.stale_seconds = stale_seconds
        self.worker_id = worker_id if worker_id is not None else (
            f'{os.uname().nodename}.{os.getpid()}')

    def _claim_path(self, key):
        return self.queue_dir / f'{key}.claim'

    def _done_path(self, key):
        return self.queue_dir / f'{key}.done'

    def try_claim(self, key) -> bool:
        claim = self._claim_path(key)
        if self._done_path(key).exists():
            return False
        try:
            fd = os.open(claim, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            try:
                age = time.time() - claim.stat().st_mtime
            except FileNotFoundError:
                return False
            if age < self.stale_seconds or self._done_path(key).exists():
                return False
            try:
                claim.unlink()          # a stale claim: take it over
            except FileNotFoundError:
                pass
            return self.try_claim(key)
        with os.fdopen(fd, 'w') as f:
            f.write(self.worker_id)
        return True

    def mark_done(self, key):
        self._done_path(key).write_text(self.worker_id)

    @staticmethod
    def default_key(item):
        if isinstance(item, dict) and 'example_id' in item:
            return item['example_id']
        return str(item)

    def __call__(self, items, key_fn=None):
        """Yield the items this worker wins; each is marked done when the
        consumer advances the generator.  That is crash-safe only for a
        consumer that finishes item N before it asks for item N+1; a
        pipelined consumer (``Enhancer.enhance_session`` prefetches and
        dispatches ahead) uses :meth:`shard`."""
        key_fn = key_fn or self.default_key
        for item in items:
            key = key_fn(item)
            if self.try_claim(key):
                yield item
                self.mark_done(key)

    def shard(self, examples, length_fn=None):
        """The ``shard_fn(examples, length_fn)`` of
        ``Enhancer.enhance_session`` (claims keyed by example id): a
        :class:`_ClaimedShard`, whose iteration yields the examples this
        worker wins and whose ``mark_complete(example_or_key)`` writes the
        done marker once the output is durable.  Until then the claim
        stays re-claimable after ``stale_seconds``, so a worker that
        crashes with work dispatched ahead strands no output."""
        return _ClaimedShard(self, examples, self.default_key)


class _ClaimedShard:
    """Iterable of won items with completion-driven done markers (see
    :meth:`FileQueueScheduler.shard`)."""

    def __init__(self, scheduler, items, key_fn):
        self._scheduler = scheduler
        self._items = items
        self._key_fn = key_fn

    def __iter__(self):
        for item in self._items:
            if self._scheduler.try_claim(self._key_fn(item)):
                yield item

    def mark_complete(self, item_or_key):
        key = (item_or_key if isinstance(item_or_key, str)
               else self._key_fn(item_or_key))
        self._scheduler.mark_done(key)
