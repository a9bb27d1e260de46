"""Multi-process orchestration — port of
``pb_chime5_tpu/parallel/distributed.py`` on ``torch.distributed``.

The reference scales with ``mpiexec -np N`` over an MPI pool (reference
README.md:108-113).  The port runs one process per card (or several per
card), joined by ``torch.distributed``; the utterance list is then split
with the deterministic schedulers of ``parallel/scheduler.py``, whose
``process_info`` reads the rank and world size.  No tensor crosses
processes: outputs go to a shared filesystem, as in the reference and the
JAX package.  So the process group is gloo, which also joins two processes
that share one card (NCCL refuses duplicate GPUs).

The launch reads torchrun's standard variables: ``MASTER_ADDR``,
``MASTER_PORT``, ``RANK`` and ``WORLD_SIZE`` (the JAX package reads
``JAX_COORDINATOR_ADDRESS``):

    MASTER_ADDR=localhost MASTER_PORT=29500 WORLD_SIZE=2 RANK=0 \
        python -m pb_chime5_tpu_torch.scripts.run with session_id=dev ...
"""

import os

__all__ = ['maybe_initialize', 'initialize', 'is_master', 'barrier',
           'raise_together']


def initialize(coordinator_address=None, num_processes=None,
               process_id=None):
    """Join the gloo process group: ``coordinator_address`` 'host:port'
    (default ``MASTER_ADDR:MASTER_PORT``), ``num_processes`` (default
    ``WORLD_SIZE``), ``process_id`` (default ``RANK``)."""
    import torch.distributed as dist
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ['WORLD_SIZE'])
    if process_id is None:
        process_id = int(os.environ['RANK'])
    dist.init_process_group(
        'gloo', init_method=f'tcp://{coordinator_address}',
        world_size=int(num_processes), rank=int(process_id))


def maybe_initialize():
    """Join the process group when torchrun's variables name more than one
    process and none is joined yet; True if this call joined it."""
    import torch.distributed as dist
    if not dist.is_available() or dist.is_initialized():
        return False
    if 'MASTER_ADDR' not in os.environ or 'MASTER_PORT' not in os.environ \
            or int(os.environ.get('WORLD_SIZE', '1')) <= 1:
        return False
    initialize()
    return True


def _joined():
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def is_master():
    """True on rank 0, and in a process that joined no group."""
    import torch.distributed as dist
    return not _joined() or dist.get_rank() == 0


def barrier():
    """Cross-process barrier (replaces dlp_mpi.barrier, reference
    core.py:369); a no-op without a process group."""
    import torch.distributed as dist
    if _joined() and dist.get_world_size() > 1:
        dist.barrier()


def raise_together(error=None):
    """Barrier that carries a failure: each process passes the exception
    it caught, or None.  If any process passed one, every process raises:
    its own, or a RuntimeError naming the first other.  Without a process
    group it raises ``error`` when given."""
    import torch.distributed as dist
    if _joined() and dist.get_world_size() > 1:
        errors = [None] * dist.get_world_size()
        dist.all_gather_object(
            errors, None if error is None else f'{type(error).__name__}: '
                                               f'{error}')
        failed = [(rank, e) for rank, e in enumerate(errors) if e]
        if failed and error is None:
            rank, message = failed[0]
            raise RuntimeError(f'rank {rank} failed: {message}')
    if error is not None:
        raise error
