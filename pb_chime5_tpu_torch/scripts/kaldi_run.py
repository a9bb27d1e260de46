"""Kaldi-style job-sharded enhancement CLI of the port — the twin of
``pb_chime5_tpu.scripts.kaldi_run`` (reference
pb_chime5/scripts/kaldi_run.py).

    python -m pb_chime5_tpu_torch.scripts.kaldi_run [test_run] with \
        storage_dir=... session_id=dev job_id=1 number_of_jobs=2000 \
        [chime6=True] [multiarray] [device=cuda] ...

Job ``job_id`` of ``number_of_jobs`` enhances ``examples[job_id -
1::number_of_jobs]`` of the session iterator (reference
kaldi_run.py:73-76) into ``storage_dir/audio/<dataset>/<id>.wav``; made
for run.pl / slurm launching thousands of jobs.  ``test_run`` takes each
job's share of the first ``2 * number_of_jobs`` examples.  The config and
its keys are those of ``scripts/run.py`` (``chime6=True`` picks the
CHiME-6 factory).
"""

import functools
from pathlib import Path

from pb_chime5_tpu_torch.models.enhancer import get_enhancer
from pb_chime5_tpu_torch.parallel.scheduler import serial_shard
from pb_chime5_tpu_torch.scripts.experiment import Experiment
from pb_chime5_tpu_torch.scripts.run import get_session_ids, make_enhancer


def make_experiment(default_storage='runs'):
    experiment = Experiment('Chime5 Array Enhancement (kaldi jobs)',
                            default_storage_dir=default_storage)
    experiment.add_config_from_signature(get_enhancer)
    experiment.add_config({
        'session_id': 'dev',
        'chime6': False,
        'storage_dir': None,
        'job_id': 1,
        'number_of_jobs': 1,
    })
    experiment.named_config('multiarray', {
        'bf_drop_context': True,
        'multiarray': True,
    })

    def run(exp, test_run=False):
        cfg = dict(exp.config)
        chime6 = cfg.pop('chime6')
        session_id = cfg.pop('session_id')
        storage_dir = cfg.pop('storage_dir')
        job_id = cfg.pop('job_id')
        number_of_jobs = cfg.pop('number_of_jobs')
        if storage_dir is None:
            raise ValueError('set storage_dir=...')
        if not 1 <= job_id <= number_of_jobs:
            raise ValueError(f'job_id={job_id} is not in 1..{number_of_jobs}')
        enhancer = make_enhancer(cfg, chime6)
        stop = 2 * number_of_jobs if test_run else None
        enhancer.enhance_session(
            get_session_ids(session_id),
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
