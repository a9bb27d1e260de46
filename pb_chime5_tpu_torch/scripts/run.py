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

Single process, single device for now: the mesh and warmup of the JAX CLI
are not ported yet (ROADMAP.md, Queue 1).
"""

import functools
import inspect

import numpy as np

from pb_chime5_tpu_torch import mapping
from pb_chime5_tpu_torch.models import enhancer_chime6
from pb_chime5_tpu_torch.models.enhancer import get_enhancer
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


def make_experiment(get_enhancer_fn=get_enhancer, default_storage='runs'):
    experiment = Experiment('Chime5 Array Enhancement',
                            default_storage_dir=default_storage)
    experiment.add_config_from_signature(get_enhancer_fn)
    experiment.add_config({'session_id': 'dev', 'chime6': False})
    experiment.named_config('multiarray', {
        'bf_drop_context': True,
        'multiarray': True,
    })

    def run(exp, test_run=False):
        cfg = dict(exp.config)
        chime6 = cfg.pop('chime6')
        session_id = cfg.pop('session_id')
        enhancer = make_enhancer(cfg, chime6, get_enhancer_fn)
        session_ids = get_session_ids(session_id)
        print('Enhancer:', type(enhancer).__name__)
        print('Sessions:', session_ids)
        enhancer.enhance_session(
            session_ids,
            exp.run_dir / 'audio',
            dataset_slice=test_run,
            audio_dir_exist_ok=True,
        )
        print('Finished experiment dir:', exp.run_dir)

    experiment._commands['main'] = run
    experiment._commands['test_run'] = functools.partial(
        run, test_run=True)
    return experiment


if __name__ == '__main__':
    make_experiment().run_commandline()
