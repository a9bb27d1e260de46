"""The port's CHiME-6 track 1 (one global clock) on the CPU against the JAX
package: the CHiME-6 tree made from a CHiME-5 one, the CHiME-6 database
JSON, the flat-clock session iterator, the activity, and the CHiME-6
enhancer through ``scripts/run.py chime6=True`` and ``scripts/kaldi_run``,
on the corpus of tests/test_torch_enhancer.py (2 arrays, 16 s, seed 11,
PCM16) at ci.sh's settings (``context_samples=8000``, 3 EM iterations,
no WPE); ci.sh's CHiME-5 CLI runs through the port, too.

Tolerances: the tree, the JSON, the examples and the activity are exact
host computations, compared exactly.  The WAVs agree with the JAX CHiME-6
enhancer's (its fused kernel EM in interpret mode, session audio not
cached) to 2e-2 of full scale, as in tests/test_torch_enhancer.py: the
same float32 math in another summation order, amplified by 3 EM
iterations.  Inside the port, cached and direct sessions and one job
against three are byte-identical.
"""

import ast
import contextlib
import inspect
import io

import numpy as np
import pytest
import torch

from pb_chime5_tpu import activity as jax_activity
from pb_chime5_tpu.database.chime5 import Chime5 as JaxChime5
from pb_chime5_tpu.database.create_json import (
    create_database as jax_create_database)
from pb_chime5_tpu.io import dump_json as jax_dump_json
from pb_chime5_tpu.io import load_audio
from pb_chime5_tpu.models import enhancer_chime6 as jax_chime6
from pb_chime5_tpu.models.gss import GssConfig as JaxGssConfig
from pb_chime5_tpu.scripts.simulate_chime6_transcriptions import (
    main as jax_simulate)
from pb_chime5_tpu.testing import create_synthetic_chime5
from pb_chime5_tpu_torch.activity import get_activity_chime6
from pb_chime5_tpu_torch.database.chime5 import Chime5
from pb_chime5_tpu_torch.database.create_json import (
    create_database, main as create_json_main)
from pb_chime5_tpu_torch.io import dump_json
from pb_chime5_tpu_torch.models.enhancer_chime6 import get_enhancer
from pb_chime5_tpu_torch.scripts import kaldi_run, run
from pb_chime5_tpu_torch.scripts.simulate_chime6_transcriptions import (
    main as simulate)

torch.set_num_threads(2)

# ci.sh's settings of its CLI runs ($COMMON)
CI = ['wpe=False', 'bss_iterations=3', 'context_samples=8000',
      'length_buckets=(32000,64000)']


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """The CHiME-5 tree, the CHiME-6 trees the JAX package and the port
    make of it, the JAX package's CHiME-6 JSON, and a copy of that JSON
    with one utterance redacted."""
    root = tmp_path_factory.mktemp('chime6_torch')
    create_synthetic_chime5(
        root / 'CHiME5', session_ids=('S02',), duration_seconds=16.0,
        utterances_per_speaker=1, num_arrays=2, seed=11, pcm16=True)
    jax_simulate(root / 'CHiME5', root / 'CHiME6_jax')
    simulate(root / 'CHiME5', root / 'CHiME6')
    db = jax_create_database(root / 'CHiME6_jax', chime6=True)
    jax_dump_json(db, root / 'chime6.json')
    first = next(iter(db['datasets']['S02'].values()))
    first['transcription'] = '[redacted]'
    jax_dump_json(db, root / 'redacted.json')
    return root


def test_simulate_chime6_transcriptions_matches_jax(corpus):
    for name in ('CHiME6', 'CHiME6_jax'):
        assert (corpus / name / 'audio').resolve() == \
            (corpus / 'CHiME5' / 'audio').resolve()
    files = sorted(p.relative_to(corpus / 'CHiME6_jax') for p in
                   (corpus / 'CHiME6_jax').glob('transcriptions/*/*.json'))
    assert files == sorted(p.relative_to(corpus / 'CHiME6') for p in
                           (corpus / 'CHiME6').glob('transcriptions/*/*'))
    assert files
    for f in files:
        assert (corpus / 'CHiME6' / f).read_bytes() == \
            (corpus / 'CHiME6_jax' / f).read_bytes()
    simulate(corpus / 'CHiME5', corpus / 'CHiME6')      # idempotent


def test_create_database_chime6_matches_jax(corpus, tmp_path):
    create_json_main(['--database-path', str(corpus / 'CHiME6'),
                      '--json-path', str(tmp_path / 'port.json'),
                      '--chime6'])
    jax_dump_json(jax_create_database(corpus / 'CHiME6', chime6=True),
                  tmp_path / 'jax.json')
    assert (tmp_path / 'port.json').read_bytes() == \
        (tmp_path / 'jax.json').read_bytes()
    db = create_database(corpus / 'CHiME6', chime6=True)
    example = next(iter(db['datasets']['S02'].values()))
    assert isinstance(example['start'], int)
    assert all(eid[3:8] == '_S02-' for eid in db['datasets']['S02'])


@pytest.mark.parametrize('drop,context,equal_start', [
    (True, 8000, False), (False, 0, False), (True, 0, False),
    (False, 240000, True)])
def test_flat_clock_iterator_matches_jax(corpus, drop, context, equal_start):
    """The CHiME-6 enhancer's reading of a session (drop, 8000, no equal
    start) and the method's other keywords on flat integer times."""
    kw = dict(drop_unknown_target_speaker=drop, context_samples=context,
              equal_start_context=equal_start)
    got = Chime5(corpus / 'redacted.json').get_iterator_for_session(
        'S02', **kw)
    want = JaxChime5(corpus / 'redacted.json').get_iterator_for_session(
        'S02', **kw)
    assert len(got) == len(want) == 4 - drop
    assert list(got) == list(want)
    for ex in got:
        if context:
            assert ex['start'] == max(ex['start_orig'] - context, 0)
            assert ex['num_samples_orig'] == ex['end_orig'] - ex['start_orig']
        assert ex['num_samples'] == ex['end'] - ex['start']


def test_audio_read_matches_jax(corpus):
    """``audio_read=True`` on the CHiME-5 database: every track's audio
    over its own span, as the JAX reader gives it."""
    jax_dump_json(jax_create_database(corpus / 'CHiME5'),
                  corpus / 'chime5.json')
    kw = dict(audio_read=True, adjust_times=True,
              drop_unknown_target_speaker=True, context_samples=800)
    got = Chime5(corpus / 'chime5.json').get_iterator_for_session(
        'S02', **kw)
    want = JaxChime5(corpus / 'chime5.json').get_iterator_for_session(
        'S02', **kw)
    key = want.keys()[0]
    got, want = got[key]['audio_data'], want[key]['audio_data']
    assert got.keys() == want.keys() == {'observation', 'worn'}
    for group in want:
        assert got[group].keys() == want[group].keys()
        for track in want[group]:
            assert got[group][track].dtype == want[group][track].dtype
            np.testing.assert_array_equal(got[group][track],
                                          want[group][track])


@pytest.mark.parametrize('garbage_class', [True, False, None, 2])
def test_get_activity_chime6_matches_jax(corpus, garbage_class):
    got = get_activity_chime6(
        Chime5(corpus / 'redacted.json').get_datasets('S02'),
        garbage_class=garbage_class)['S02']
    want = jax_activity.get_activity_chime6(
        JaxChime5(corpus / 'redacted.json').get_datasets('S02'),
        garbage_class=garbage_class)['S02']
    assert list(got) == list(want)
    for track, ai in want.items():
        assert got[track].shape == ai.shape
        assert got[track].intervals == ai.normalized_intervals


@pytest.fixture(scope='module')
def cli_run(corpus, tmp_path_factory):
    """ci.sh's ``run.py test_run with chime6=True`` on the CPU (the
    default, cached session path); (WAVs, printed output)."""
    exp = run.make_experiment(
        default_storage=tmp_path_factory.mktemp('runs'))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exp.run_commandline([
            'test_run', 'with', 'session_id=S02', 'chime6=True',
            f'database_path={corpus / "chime6.json"}', 'device=cpu', *CI])
    return sorted((exp.run_dir / 'audio' / 'dev').glob('*.wav')), \
        out.getvalue()


def test_run_cli_chime6_matches_jax_enhancer(corpus, cli_run, tmp_path):
    wavs, out = cli_run
    assert len(wavs) == 2, wavs
    assert 'Enhancer: Enhancer' in out
    stats = [line for line in out.splitlines()
             if line.startswith('session-audio cache: ')]
    assert "'direct': 0" in stats[-1] and "'refills': 1" in stats[-1]

    jax_enhancer = jax_chime6.Enhancer(
        activity=jax_chime6.Activity(
            garbage_class=True, database_path=str(corpus / 'chime6.json')),
        gss_config=JaxGssConfig(wpe=False, bss_iterations=3,
                                bss_em_backend='pallas'),
        context_samples=8000, length_buckets=(32000, 64000),
        device_audio_cache=False)
    jax_enhancer.enhance_session(['S02'], tmp_path / 'jax',
                                 dataset_slice=True)
    it = jax_enhancer.get_iterator('S02')
    for wav in wavs:
        got = load_audio(wav)
        want = load_audio(tmp_path / 'jax' / 'dev' / wav.name)
        assert got.shape == want.shape == (it[wav.stem]['num_samples_orig'],)
        assert np.isfinite(got).all() and np.abs(got).max() > 0
        np.testing.assert_allclose(got, want, atol=2e-2)


def kaldi_jobs(corpus, storage, number_of_jobs, *extra):
    """``kaldi_run main`` with ``chime6=True multiarray``, jobs 1 to
    ``number_of_jobs``; the WAVs and each job's cache stats line."""
    stats = []
    for job_id in range(1, number_of_jobs + 1):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            kaldi_run.make_experiment(default_storage=storage / 'runs') \
                .run_commandline([
                    'main', 'with', 'chime6=True', 'multiarray',
                    'session_id=S02', f'storage_dir={storage}',
                    f'job_id={job_id}', f'number_of_jobs={number_of_jobs}',
                    f'database_path={corpus / "chime6.json"}', 'device=cpu',
                    *CI, *extra])
        stats += [ast.literal_eval(line.split(': ', 1)[1])
                  for line in out.getvalue().splitlines()
                  if line.startswith('session-audio cache: ')]
    return sorted((storage / 'audio' / 'dev').glob('*.wav')), stats


@pytest.fixture(scope='module')
def single_job(corpus, tmp_path_factory):
    """One job, session audio read and uploaded per utterance."""
    return kaldi_jobs(corpus, tmp_path_factory.mktemp('single'), 1,
                      'device_audio_cache=False')[0]


@pytest.fixture(scope='module')
def three_jobs(corpus, tmp_path_factory):
    """Jobs 1-3 of 3, the session-audio cache on (the default)."""
    return kaldi_jobs(corpus, tmp_path_factory.mktemp('three'), 3)


def test_cached_session_equals_direct(single_job, three_jobs):
    """Each job's cached WAVs are byte-identical to the direct ones."""
    wavs, stats = three_jobs
    assert len(stats) == 3 and all(
        s['direct'] == 0 and s['hits'] + s['refills'] >= 1 for s in stats)
    assert sum(s['hits'] for s in stats) >= 1, stats
    direct = {w.name: w for w in single_job}
    for wav in wavs:
        assert wav.read_bytes() == direct[wav.name].read_bytes(), wav.name


def test_kaldi_run_jobs_give_the_single_job_set(single_job, three_jobs):
    """Jobs 1-3 of 3 together write exactly the single job's WAVs."""
    assert [w.name for w in three_jobs[0]] == [w.name for w in single_job]
    assert len(single_job) == 4


@pytest.mark.parametrize('cli,args', [
    ('run', CI),
    ('run', ['wpe=True', 'wpe_tabs=2', 'wpe_iterations=1',
             'bss_iterations=2', 'context_samples=8000',
             'length_buckets=(32000,64000)']),
    ('kaldi_run', ['job_id=1', 'number_of_jobs=2', *CI])])
def test_ci_sh_chime5_invocations(corpus, tmp_path, cli, args):
    """ci.sh's CHiME-5 CLI runs through the port (``device=cpu``): two
    finite, non-silent WAVs of their utterances' length each."""
    dump_json(create_database(corpus / 'CHiME5'), tmp_path / 'chime5.json')
    argv = ['test_run', 'with', 'session_id=S02', 'device=cpu',
            f'database_path={tmp_path / "chime5.json"}', *args]
    module = {'run': run, 'kaldi_run': kaldi_run}[cli]
    exp = module.make_experiment(default_storage=tmp_path / 'runs')
    if cli == 'kaldi_run':
        argv.append(f'storage_dir={tmp_path}')
    exp.run_commandline(argv)
    out = (tmp_path if cli == 'kaldi_run' else exp.run_dir) / 'audio' / 'dev'
    wavs = sorted(out.glob('*.wav'))
    assert len(wavs) == 2, wavs
    it = Chime5(tmp_path / 'chime5.json').get_iterator_for_session(
        'S02', adjust_times=True, drop_unknown_target_speaker=True,
        context_samples=8000, equal_start_context=True)
    for wav in wavs:
        x = load_audio(wav)
        ex = it[wav.stem]
        assert x.shape == (ex['num_samples_orig']['observation']['U01'],)
        assert np.isfinite(x).all() and np.abs(x).max() > 0


def test_factory_keywords_match_jax():
    """The CHiME-6 factory takes the JAX one's keywords, in its order,
    with its defaults, and adds only ``device``."""
    port = inspect.signature(get_enhancer).parameters
    jax_ = inspect.signature(jax_chime6.get_enhancer).parameters
    assert list(port) == list(jax_) + ['device']
    for name, param in jax_.items():
        assert port[name].default == param.default, name


@pytest.mark.parametrize('cli', ['run', 'kaldi_run'])
def test_cli_keys(corpus, tmp_path, cli):
    """With ``chime6=True`` a CHiME-5-only key is dropped (as the JAX CLIs
    drop it), a key that neither factory knows raises."""
    module = {'run': run, 'kaldi_run': kaldi_run}[cli]
    base = ['with', 'chime6=True', 'session_id=S02', 'device=cpu',
            f'database_path={corpus / "chime6.json"}']
    if cli == 'kaldi_run':
        base.append(f'storage_dir={tmp_path}')
    made = []

    def fake_enhance_session(self, *args, **kwargs):
        made.append(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr('pb_chime5_tpu_torch.models.enhancer_chime6.Enhancer.'
                   'enhance_session', fake_enhance_session)
        module.make_experiment(default_storage=tmp_path / 'runs') \
            .run_commandline(base + ['device_trim=False',
                                     'compile_mode="fused"'])
        assert type(made[0]).__module__.endswith('enhancer_chime6')
        with pytest.raises(NotImplementedError, match='no_such_key'):
            module.make_experiment(default_storage=tmp_path / 'runs') \
                .run_commandline(base + ['no_such_key=1'])
