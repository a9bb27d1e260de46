"""The port's multi-process host distribution on the CPU: N worker
processes (``pb_chime5_tpu_torch/testing/mp_worker.py``) must together
write exactly the serial run's WAVs, byte for byte — the twins of the five
tests of ``tests/test_multiprocess.py`` (file queue, length-balanced
shares, crash recovery, the process group, the process group with a local
mesh), plus two Kaldi-style ``PB_JOB_ID`` jobs.

The JAX twins are ``slow``; these run in the fast lane, each well under
30 s on the CPU at the worker's small config (no WPE, 3 EM iterations,
one 4-channel array).  Every wait has a timeout, after which the workers
are killed, so no test can hang the lane.
"""

import hashlib
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

from pb_chime5_tpu_torch.database.create_json import create_database
from pb_chime5_tpu_torch.io import dump_json

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 240


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """4 speakers x 2 utterances = 8 examples on one array."""
    from pb_chime5_tpu_torch.testing import create_synthetic_chime5
    root = tmp_path_factory.mktemp('mp_corpus_torch')
    create_synthetic_chime5(root, session_ids=('S02',),
                            duration_seconds=20.0, utterances_per_speaker=2,
                            num_arrays=1, seed=5)
    dump_json(create_database(root), root / 'chime5.json')
    return root / 'chime5.json'


def _env(**extra):
    env = dict(os.environ)
    for key in ('PB_JOB_ID', 'PB_NUM_JOBS', 'MASTER_ADDR', 'MASTER_PORT',
                'RANK', 'WORLD_SIZE'):
        env.pop(key, None)
    env['PYTHONPATH'] = (str(REPO) + os.pathsep + env['PYTHONPATH']
                         if 'PYTHONPATH' in env else str(REPO))
    env['OMP_NUM_THREADS'] = '2'
    env.update(extra)
    return env


def _start(json_path, audio_dir, mode, *, env=None, **options):
    cmd = [sys.executable, '-m', 'pb_chime5_tpu_torch.testing.mp_worker',
           '--json-path', str(json_path), '--audio-dir', str(audio_dir),
           '--mode', mode, '--device', 'cpu']
    for key, value in options.items():
        flag = '--' + key.replace('_', '-')
        cmd += [flag] if value is True else [flag, str(value)]
    return subprocess.Popen(cmd, env=env or _env(), cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _wait(procs, codes=None):
    """Wait for every worker (killing all of them past the timeout);
    returns their standard outputs, each checked for its exit code (0, or
    ``codes``) and, where 0, for WORKER_OK."""
    outs = []
    deadline = time.monotonic() + TIMEOUT
    try:
        for i, p in enumerate(procs):
            out, err = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            want = 0 if codes is None else codes[i]
            assert p.returncode == want, (out[-2000:], err[-4000:])
            if want == 0:
                assert 'WORKER_OK' in out
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _wav_hashes(audio_dir):
    return {p.relative_to(audio_dir).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in Path(audio_dir).rglob('*.wav')}


def _free_port():
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


@pytest.fixture(scope='module')
def serial_hashes(corpus, tmp_path_factory):
    audio = tmp_path_factory.mktemp('serial_torch') / 'audio'
    _wait([_start(corpus, audio, 'serial')])
    hashes = _wav_hashes(audio)
    assert len(hashes) == 8, sorted(hashes)
    return hashes


def test_file_queue_two_processes(corpus, serial_hashes, tmp_path):
    audio, queue = tmp_path / 'audio', tmp_path / 'queue'
    outs = _wait([_start(corpus, audio, 'queue', rank=r, world=2,
                         queue_dir=queue) for r in range(2)])
    assert _wav_hashes(audio) == serial_hashes
    finished = [o.count('FINISHED') for o in outs]
    assert sum(finished) == 8, finished        # never double work


def test_length_balanced_two_processes(corpus, serial_hashes, tmp_path):
    audio = tmp_path / 'audio'
    outs = _wait([_start(corpus, audio, 'balanced', rank=r, world=2)
                  for r in range(2)])
    assert _wav_hashes(audio) == serial_hashes
    assert [o.count('FINISHED') for o in outs] == [4, 4]


def test_job_env_two_processes(corpus, serial_hashes, tmp_path):
    """Two Kaldi-style jobs (``PB_JOB_ID=1,2``, ``PB_NUM_JOBS=2``) with the
    default shard: each writes its length-balanced share, no utterance
    twice, the union the serial run."""
    audio = tmp_path / 'audio'
    outs = _wait([_start(corpus, audio, 'jobs',
                         env=_env(PB_JOB_ID=str(job), PB_NUM_JOBS='2'))
                  for job in (1, 2)])
    assert _wav_hashes(audio) == serial_hashes
    ids = [{line.split()[1] for line in o.splitlines()
            if line.startswith('FINISHED')} for o in outs]
    assert [len(i) for i in ids] == [4, 4] and not ids[0] & ids[1]


def test_file_queue_crash_recovery(corpus, serial_hashes, tmp_path):
    """A worker killed after 2 utterances leaves stale claims; a fresh
    worker re-claims them and completes the identical output set."""
    audio, queue = tmp_path / 'audio', tmp_path / 'queue'
    [out] = _wait([_start(corpus, audio, 'queue', queue_dir=queue,
                          stale_seconds=0.5, crash_after=2)], codes=[17])
    assert 'CRASHING' in out
    done_before = len(_wav_hashes(audio))
    assert 2 <= done_before < 8
    time.sleep(0.6)                               # let the claims go stale
    _wait([_start(corpus, audio, 'queue', queue_dir=queue,
                  stale_seconds=0.5)])
    assert _wav_hashes(audio) == serial_hashes


@pytest.mark.parametrize('mesh', [0, 2], ids=['processes', 'with-mesh'])
def test_distributed_two_processes(corpus, serial_hashes, tmp_path, mesh):
    """Two processes join a gloo group through a localhost address:
    ``initialize``, ``is_master``, the run-id broadcast and ``barrier``;
    ``process_info`` gives each its rank's length-balanced share (with
    ``--mesh 2``, each drives 2 local CPU slots through the mesh loop);
    the union is the serial run."""
    audio = tmp_path / 'audio'
    port = _free_port()
    extra = {'mesh': mesh} if mesh else {}
    outs = _wait([_start(corpus, audio, 'distributed', rank=r, world=2,
                         coordinator=f'localhost:{port}', run_id=7 + mesh,
                         **extra) for r in range(2)])
    for rank in range(2):
        got = (audio.parent / f'broadcast_{rank}.txt').read_text()
        assert got == str(7 + mesh), (rank, got)
    assert _wav_hashes(audio) == serial_hashes
    assert [o.count('FINISHED') for o in outs] == [4, 4]


def test_distributed_master_failure_reaches_every_rank(corpus, tmp_path):
    """Rank 0 alone makes the audio dir, and it must be new: when it
    exists, rank 0 raises FileExistsError and rank 1 raises with it
    instead of waiting or writing; neither writes a WAV."""
    audio = tmp_path / 'audio'
    audio.mkdir()
    port = _free_port()
    procs = [_start(corpus, audio, 'distributed', rank=r, world=2,
                    coordinator=f'localhost:{port}') for r in range(2)]
    try:
        errs = [p.communicate(timeout=TIMEOUT)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [1, 1], errs
    assert 'FileExistsError' in errs[0]
    assert 'rank 0 failed: FileExistsError' in errs[1]
    assert not _wav_hashes(audio)
