"""CHiME-6 track-2 (RTTM diarization) enhancement CLI of the port — the
twin of ``pb_chime5_tpu.scripts.kaldi_run_rttm`` (reference
pb_chime5/scripts/kaldi_run_rttm.py).

    python -m pb_chime5_tpu_torch.scripts.kaldi_run_rttm [test_run] with \
        storage_dir=... chime6_dir=CHiME6 database_rttm=dev.rttm \
        [activity_rttm=...] session_id=S02 job_id=1 number_of_jobs=6000 \
        [device=cuda] ...

``activity_rttm`` defaults to ``database_rttm``; dataset aliases
(dev / eval / train) resolve through the RTTM database; job sharding as
in ``kaldi_run``.  Config keys are the keywords of
``models/enhancer_rttm.get_enhancer``; any other key raises.
"""

import functools
import inspect
from pathlib import Path

from pb_chime5_tpu_torch.models.enhancer_rttm import get_enhancer
from pb_chime5_tpu_torch.parallel.scheduler import serial_shard
from pb_chime5_tpu_torch.scripts.experiment import Experiment
from pb_chime5_tpu_torch.scripts.run import factory_keywords


def make_experiment(default_storage='runs'):
    experiment = Experiment('Chime6 RTTM Enhancement',
                            default_storage_dir=default_storage)
    experiment.add_config_from_signature(get_enhancer)
    experiment.add_config({
        'session_id': 'dev',
        'storage_dir': None,
        'database_rttm': None,
        'activity_rttm': None,     # defaults to database_rttm
        'job_id': 1,
        'number_of_jobs': 1,
    })

    def run(exp, test_run=False):
        cfg = dict(exp.config)
        session_id = cfg.pop('session_id')
        storage_dir = cfg.pop('storage_dir')
        job_id = cfg.pop('job_id')
        number_of_jobs = cfg.pop('number_of_jobs')
        if storage_dir is None:
            raise ValueError('set storage_dir=...')
        if cfg['database_rttm'] is None:
            raise ValueError('set database_rttm=...')
        if not 1 <= job_id <= number_of_jobs:
            raise ValueError(f'job_id={job_id} is not in 1..{number_of_jobs}')
        if cfg['activity_rttm'] is None:
            cfg['activity_rttm'] = cfg['database_rttm']
        unknown = set(cfg) - set(inspect.signature(get_enhancer).parameters)
        if unknown:
            raise NotImplementedError(
                f'config keys {sorted(unknown)} are not supported by the '
                f'port (see ROADMAP.md)')
        enhancer = get_enhancer(**factory_keywords(cfg))

        if isinstance(session_id, str):
            session_id = [session_id]
        alias = enhancer.db.database_dict.get('alias', {})
        sessions = sorted({s for key in session_id
                           for s in alias.get(key, [key])})
        stop = 2 * number_of_jobs if test_run else None
        enhancer.enhance_session(
            sessions,
            Path(storage_dir) / 'audio',
            dataset_slice=slice(job_id - 1, stop, number_of_jobs),
            audio_dir_exist_ok=True,
            shard_fn=serial_shard,
        )
        print('Finished', storage_dir)

    experiment._commands['main'] = run
    experiment._commands['test_run'] = functools.partial(
        run, test_run=True)
    return experiment


if __name__ == '__main__':
    make_experiment().run_commandline()
