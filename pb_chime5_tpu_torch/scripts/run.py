"""Main enhancement CLI of the port (reference: pb_chime5/scripts/run.py).

    python -m pb_chime5_tpu_torch.scripts.run [test_run] [-F STORAGE] \
        with session_id=dev multiarray=True device=cuda ...

* config keys = keywords of ``get_enhancer`` (+ session_id, chime6),
* ``chime6=True`` enhances with the CHiME-6 factory
  (``models/enhancer_chime6.py``, a CHiME-6 database JSON); it takes the
  keys that factory accepts, and a key that neither factory accepts
  raises,
* named config ``multiarray`` (reference run.py:30-33),
* ``compute_dtype=float64`` computes the chain in float64 (the value
  reaches the factory as a NumPy dtype),
* ``test_run`` enhances only the first 2 utterances,
* outputs land in ``<storage>/<run_id>/audio/<dataset>/<id>.wav``.

Multi-process: launch with torchrun's variables (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``): the processes join a gloo
group, share the master's run dir, and the default length-balanced shard
splits the utterances by rank; or launch many jobs with ``PB_JOB_ID`` /
``PB_NUM_JOBS`` (Kaldi-style, 1-based job ids), each enhancing its
length-balanced share.

Several devices in one process: ``with mesh=auto`` batches same-bucket
utterances over every local CUDA device (``mesh=4`` the first 4; with
``device=cpu``, ``mesh=N`` makes N CPU slots); ``mesh_freq=2`` adds
frequency sharding inside each utterance, ``utterances_per_device=2``
stacks more rows per data group.  ``warmup=True`` readies the card for
the first session's shapes first (``Enhancer.warmup``).
"""

import functools
import inspect

import numpy as np

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.models import enhancer_chime6
from pb_chime5_tpu_torch.models.enhancer import get_enhancer
from pb_chime5_tpu_torch.parallel.distributed import is_master
from pb_chime5_tpu_torch.scripts.experiment import Experiment


def get_session_ids(session_id):
    """'dev' / 'train' / 'eval' / 'all' / explicit ids -> sorted session
    list (reference run.py:45-71)."""
    if isinstance(session_id, str):
        session_id = [session_id]
    table = dict(mapping.dataset_to_sessions)
    table['all'] = sorted(mapping.session_ids)
    return sorted({
        sess
        for key in session_id
        for sess in table.get(key, [key])
    })


def factory_keywords(cfg):
    """A CLI config as factory keywords: ``compute_dtype`` (a string such
    as 'float64' on the command line) as a NumPy dtype."""
    if 'compute_dtype' in cfg:
        cfg = {**cfg, 'compute_dtype': np.dtype(cfg['compute_dtype'])}
    return cfg


def make_enhancer(cfg, chime6, chime5_factory=get_enhancer):
    """The enhancer of a CLI config: the CHiME-6 factory if ``chime6``,
    else ``chime5_factory``, given the config keys it accepts; a key that
    neither factory accepts raises."""
    def keywords(factory):
        return set(inspect.signature(factory).parameters)

    factory = enhancer_chime6.get_enhancer if chime6 else chime5_factory
    accepted = keywords(factory)
    unknown = (set(cfg) - keywords(chime5_factory)
               - keywords(enhancer_chime6.get_enhancer))
    if unknown:
        raise NotImplementedError(
            f'config keys {sorted(unknown)} are not supported by the '
            f'port (see ROADMAP.md)')
    return factory(**{k: v for k, v in factory_keywords(cfg).items()
                      if k in accepted})


def make_mesh_of(mesh, mesh_freq, device):
    """The CLI's ``mesh`` key as a ``parallel.mesh.Mesh`` (None: no mesh):
    'auto' / True every local CUDA device, an int N the first N, or N CPU
    slots with ``device='cpu'``."""
    if mesh in (None, False, 'None'):
        return None
    import torch

    from pb_chime5_tpu_torch.parallel.mesh import make_mesh
    if torch.device(device).type == 'cpu':
        if mesh in (True, 'auto'):
            raise ValueError("mesh=auto takes the CUDA devices; with "
                             "device=cpu give the number of CPU slots, "
                             "mesh=N")
        local = [torch.device('cpu')] * int(mesh)
    else:
        if not torch.cuda.is_available():
            raise RuntimeError('mesh: no CUDA device (device=cpu makes CPU '
                               'slots)')
        local = [torch.device('cuda', i)
                 for i in range(torch.cuda.device_count())]
        if mesh not in (True, 'auto'):
            local = local[:int(mesh)]
    n = len(local)
    if n % mesh_freq:
        raise ValueError(f'{n} devices do not split into mesh_freq='
                         f'{mesh_freq}')
    print(f'Mesh: {n} local devices (data={n // mesh_freq}, '
          f'freq={mesh_freq})')
    return make_mesh(data=n // mesh_freq, freq=mesh_freq, devices=local)


def make_experiment(get_enhancer_fn=get_enhancer, default_storage='runs'):
    experiment = Experiment('Chime5 Array Enhancement',
                            default_storage_dir=default_storage)
    experiment.add_config_from_signature(get_enhancer_fn)
    experiment.add_config({'session_id': 'dev', 'chime6': False,
                           'mesh': None, 'mesh_freq': 1,
                           'utterances_per_device': 1, 'warmup': False})
    experiment.named_config('multiarray', {
        'bf_drop_context': True,
        'multiarray': True,
    })

    def run(exp, test_run=False):
        cfg = dict(exp.config)
        chime6 = cfg.pop('chime6')
        session_id = cfg.pop('session_id')
        mesh_cfg = cfg.pop('mesh')
        mesh_freq = int(cfg.pop('mesh_freq') or 1)
        utterances_per_device = int(cfg.pop('utterances_per_device'))
        warmup = bool(cfg.pop('warmup'))
        enhancer = make_enhancer(cfg, chime6, get_enhancer_fn)
        mesh = make_mesh_of(mesh_cfg, mesh_freq, enhancer.device)
        session_ids = get_session_ids(session_id)
        print('Enhancer:', type(enhancer).__name__)
        print('Sessions:', session_ids)
        if warmup:
            enhancer.warmup(session_ids[0], mesh=mesh,
                            utterances_per_device=utterances_per_device)
        enhancer.enhance_session(
            session_ids,
            exp.run_dir / 'audio',
            dataset_slice=test_run,
            audio_dir_exist_ok=True,
            is_master=is_master(),
            mesh=mesh,
            utterances_per_device=utterances_per_device,
        )
        print('Finished experiment dir:', exp.run_dir)

    experiment._commands['main'] = run
    experiment._commands['test_run'] = functools.partial(
        run, test_run=True)
    return experiment


if __name__ == '__main__':
    make_experiment().run_commandline()
