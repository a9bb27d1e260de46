"""Worker process of the port's multi-process runs.

    python -m pb_chime5_tpu_torch.testing.mp_worker --json-path DB.json \
        --audio-dir OUT --mode queue --queue-dir Q [--device cpu] ...

Runs ``Enhancer.enhance_session`` over session S02 of a corpus with one of
the host-distribution strategies, so that a caller can hold the union of
N cooperating processes' WAVs against one serial run (the reference's MPI
pool contract, reference core.py:381 ``split_managed``):

* ``serial``: every utterance (``serial_shard``);
* ``queue``: dynamic pulling through ``FileQueueScheduler(--queue-dir)``;
* ``balanced``: ``length_balanced_shard`` at ``--rank`` of ``--world``;
* ``jobs``: the default shard, whose process index and count come from
  the Kaldi-style ``PB_JOB_ID`` / ``PB_NUM_JOBS`` environment;
* ``distributed``: joins a gloo process group (``--coordinator``
  host:port, ``--rank``, ``--world``), checks ``is_master``, broadcasts
  the master's ``--run-id`` (written to ``broadcast_<rank>.txt`` beside
  the audio dir), and takes the default shard of its rank; only rank 0
  makes the audio dir, which must not exist unless ``--resume``;
  ``--mesh N`` drives N local slots (CUDA devices, or CPU slots with
  ``--device cpu``) through ``enhance_session(mesh=...)``.

``--crash-after K`` hard-exits (code 17) after K written utterances, to
exercise the file queue's stale-claim recovery.  ``--config small`` is the
CPU tests' cut-down chain, ``default`` the factory's defaults on all
arrays.  Each written utterance prints ``FINISHED <id>``, the end
``WORKER_OK`` (after a check that neither JAX nor the JAX package was
imported).
"""

import argparse
import os
import sys

SMALL = dict(
    wpe=False, multiarray=False,
    bss_iterations=3, bss_iterations_post=1,
    context_samples=4000, length_buckets=(64000,),
)
DEFAULT = dict(multiarray=True)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--json-path', required=True)
    p.add_argument('--audio-dir', required=True)
    p.add_argument('--mode', required=True, choices=[
        'serial', 'queue', 'balanced', 'jobs', 'distributed'])
    p.add_argument('--queue-dir')
    p.add_argument('--stale-seconds', type=float, default=3600.0)
    p.add_argument('--rank', type=int, default=0)
    p.add_argument('--world', type=int, default=1)
    p.add_argument('--crash-after', type=int, default=-1)
    p.add_argument('--resume', action='store_true')
    p.add_argument('--coordinator', default=None,
                   help='host:port of the gloo group (mode=distributed)')
    p.add_argument('--run-id', type=int, default=-1,
                   help="the master's run id for the broadcast check")
    p.add_argument('--mesh', type=int, default=0,
                   help='drive this many local slots through '
                        'enhance_session(mesh=...)')
    p.add_argument('--device', default='cuda',
                   help="the enhancer's device; 'cpu' runs the plain "
                        'versions of the kernels')
    p.add_argument('--config', choices=['small', 'default'],
                   default='small')
    a = p.parse_args(argv)

    from functools import partial
    from pathlib import Path

    import torch

    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    from pb_chime5_tpu_torch.parallel import distributed
    from pb_chime5_tpu_torch.parallel.scheduler import (
        FileQueueScheduler, length_balanced_shard, process_info,
        serial_shard)

    if a.mode == 'distributed':
        distributed.initialize(coordinator_address=a.coordinator,
                               num_processes=a.world, process_id=a.rank)
        assert process_info() == (a.rank, a.world), process_info()
        assert distributed.is_master() == (a.rank == 0)
        from pb_chime5_tpu_torch.scripts.experiment import Experiment
        got = Experiment._broadcast_run_id(a.run_id if a.rank == 0 else -1)
        print('BROADCAST_RUN_ID', got, flush=True)
        record = Path(a.audio_dir).parent / f'broadcast_{a.rank}.txt'
        record.parent.mkdir(parents=True, exist_ok=True)
        record.write_text(str(got))
        distributed.barrier()
    elif a.mode == 'jobs':
        assert process_info() == (int(os.environ['PB_JOB_ID']) - 1,
                                  int(os.environ['PB_NUM_JOBS'])), \
            process_info()

    config = SMALL if a.config == 'small' else DEFAULT
    enhancer = get_enhancer(database_path=a.json_path, device=a.device,
                            **config)
    mesh = None
    if a.mesh:
        from pb_chime5_tpu_torch.parallel.mesh import make_mesh
        device = torch.device(a.device)
        slots = ([device] * a.mesh if device.type == 'cpu' else
                 [torch.device('cuda', i) for i in range(a.mesh)])
        mesh = make_mesh(data=a.mesh, freq=1, devices=slots)

    if a.mode == 'queue':
        shard_fn = FileQueueScheduler(
            a.queue_dir, stale_seconds=a.stale_seconds,
            worker_id=f'w{a.rank}').shard
    elif a.mode == 'balanced':
        shard_fn = partial(length_balanced_shard, process_index=a.rank,
                           process_count=a.world)
    elif a.mode in ('jobs', 'distributed'):
        shard_fn = length_balanced_shard     # process_info() decides
    else:
        shard_fn = serial_shard

    done = 0

    def progress(example_id):
        nonlocal done
        done += 1
        print('FINISHED', example_id, flush=True)
        if 0 <= a.crash_after <= done:
            print('CRASHING', flush=True)
            os._exit(17)

    # in a group only rank 0 makes the audio dir, which must be new
    # unless resumed; processes without a group share it as masters
    grouped = a.mode == 'distributed'
    enhancer.enhance_session(
        ['S02'], a.audio_dir,
        audio_dir_exist_ok=a.resume or not grouped,
        is_master=distributed.is_master(),
        shard_fn=shard_fn, progress=progress, resume=a.resume, mesh=mesh)
    distributed.barrier()    # every share durable before any declares done
    loaded = {name.split('.')[0] for name in sys.modules}
    assert not loaded & {'jax', 'pb_chime5_tpu'}, 'imported the JAX package'
    print('WORKER_OK', flush=True)


if __name__ == '__main__':
    main()
