"""The float64 reference of ``gss_bench/reference`` on small seeded
sessions (CPU):

* its STFT, WPE, EM posteriors and MVDR + BAN against a plain-NumPy
  oracle of the same equations (``oracle_numpy.py``: loops over
  frequencies, eigendecompositions and LU solves), for each
  configuration's D, and its whole chain against the oracle's at D = 4,
  within 1e-6 of the peak.  At D = 24 the MVDR solve of a short
  utterance is too ill-conditioned for two summation orders to agree:
  there the stages before it are compared;
* its reading of a session (spans, activity, context frames, trim)
  against the port's, and its waveforms against the port's exact-length
  float64 path within the PCM16 rounding of the WAVs;
* the TF32 rounding of the control;
* no file of the benchmark imports JAX or the JAX package, and importing
  every module of the benchmark, its tests included, in a fresh process
  loads no module whose whole top-level name is ``jax``, ``jaxlib``,
  ``flax`` or ``pb_chime5_tpu`` (nor, for the reference,
  ``pb_chime5_tpu_torch``).
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from gss_bench import check, reference
from gss_bench.deployments import chime5
from gss_bench.reference import chain, session, wav
from gss_bench.tests import oracle_numpy

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / 'gss_bench'
WAVE_RTOL = 1e-6          # of the peak, float64 against float64
PCM_RTOL = 5e-4           # ||wav - ref|| / ||ref||: the WAVs' PCM16 rounding
EPS64 = float(np.finfo(np.float64).eps)

torch.set_num_threads(4)


def small(config_name, **enhancer):
    """A configuration cut to a 20 s session and 1 s of context."""
    config = json.loads((BENCH / 'configs' / f'{config_name}.json')
                        .read_text())
    config['session_duration_s'] = 20
    config['enhancer'].update(context_samples=16000, **enhancer)
    return config


def small_traffic():
    traffic = json.loads((BENCH / 'traffic' / 's02_dense.json').read_text())
    traffic.update(rate_per_s=0.2, edge_s=2.0)
    traffic['length'].update(mean_s=1.5, max_s=4.0)
    return traffic


def make_scene(name, tmp_path_factory):
    config = small(name)
    root = tmp_path_factory.mktemp(name) / 'CHiME5'
    chime5.write_corpus(root, config, small_traffic(), 2 ** 31 + 5, 'cpu')
    utterances, intervals = chime5.load_session(root, config)
    return config, root, utterances, intervals


@pytest.fixture(scope='module', params=['chime5_single_array',
                                        'chime5_multiarray'])
def scene(request, tmp_path_factory):
    return make_scene(request.param, tmp_path_factory)


@pytest.fixture(scope='module')
def single_scene(tmp_path_factory):
    return make_scene('chime5_single_array', tmp_path_factory)


def longest_observation(scene):
    config, _, utterances, intervals = scene
    utt = max(utterances.values(), key=lambda u: u.emitted_seconds)
    obs = reference.observation(utt).astype(np.float64) * 2.0 ** -15
    return config, utt, intervals, obs


def test_reference_stages_match_oracle(scene):
    config, utt, intervals, obs = longest_observation(scene)
    p = reference.chain_params(config)
    precision = reference.Precision('float64')
    Obs = chain.stft(torch.from_numpy(obs), 1024, 256, precision)
    Obs_np = oracle_numpy.stft_np(obs, 1024, 256)
    np.testing.assert_allclose(Obs.numpy(), Obs_np, rtol=0,
                               atol=1e-12 * np.abs(Obs_np).max())
    Y = Obs.permute(2, 0, 1).contiguous()
    X = chain.wpe(Y, 10, 2, 3, p['wpe_load'], precision)
    X_np = oracle_numpy.wpe_np(Y.numpy(), 10, 2, 3, p['wpe_load'])
    assert np.abs(X.numpy() - X_np).max() <= 1e-9 * np.abs(X_np).max()
    T = Y.shape[-1]
    act = session.frame_activity(utt, intervals, config)[:, :T]
    masks = chain.em_posteriors(
        X, torch.as_tensor(act), 20, 1, p['em_init_floor'],
        p['em_diagonal_floor'], precision).numpy()
    masks_np = oracle_numpy.cacgmm_posteriors_np(
        X.numpy().transpose(0, 2, 1), act, 20, 1, p['em_init_floor'],
        p['em_diagonal_floor'])
    np.testing.assert_allclose(masks, masks_np, rtol=0, atol=1e-8)


def test_beamformer_matches_oracle(scene):
    """MVDR (Souden) + BAN on well-conditioned PSDs of the scene's D."""
    config = scene[0]
    p = reference.chain_params(config)
    D = 4 if not config['enhancer']['multiarray'] else 24
    gen = np.random.default_rng(2 ** 31 + 9)

    def psd(frames):
        z = gen.standard_normal((65, D, frames)) \
            + 1j * gen.standard_normal((65, D, frames))
        return z @ z.conj().transpose(0, 2, 1) / frames

    cov_x, cov_n = psd(8 * D), psd(8 * D)
    Y = gen.standard_normal((65, D, 40)) + 1j * gen.standard_normal(
        (65, D, 40))
    got = chain.mvdr_souden_ban(
        *(torch.from_numpy(a) for a in (Y, cov_x, cov_n)), p['mvdr_load'],
        p['mvdr_eps'], reference.Precision('float64')).numpy()
    w, _ = oracle_numpy.mvdr_souden_np(cov_x, cov_n, p['mvdr_load'],
                                       p['mvdr_eps'])
    want = np.einsum('fd,fdt->ft', oracle_numpy.ban_np(w, cov_n).conj(), Y)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_reference_matches_oracle_chain(single_scene):
    config, utt, intervals, obs = longest_observation(single_scene)
    act = session.frame_activity(utt, intervals, config)
    p = reference.chain_params(config)
    ours = chain.enhance(torch.from_numpy(obs), act, utt.target,
                         utt.context_frames, p,
                         reference.Precision('float64')).numpy()
    theirs = oracle_numpy.enhance_np(obs, act, utt.target,
                                     utt.context_frames, p)
    assert obs.shape[0] == 4
    assert ours.shape == theirs.shape == (obs.shape[1],)
    err = np.abs(ours - theirs).max() / np.abs(theirs).max()
    assert err <= WAVE_RTOL, err


def port_session(config, root, tmp, compute_dtype):
    """The port's enhancer over the whole session (exact lengths, as the
    configurations run it) -> its output directory."""
    from pb_chime5_tpu_torch.parallel.scheduler import serial_shard
    config = json.loads(json.dumps(config))
    config['enhancer']['compute_dtype'] = compute_dtype
    enhancer = chime5.open_enhancer(tmp, root, config, 'cpu')
    enhancer.enhance_session('S02', tmp / 'out', shard_fn=serial_shard)
    return enhancer, tmp / 'out' / 'dev'


def test_session_reading_matches_port(scene, tmp_path):
    config, root, utterances, intervals = scene
    enhancer = chime5.open_enhancer(tmp_path, root, config, 'cpu')
    ref_array = config['session']['reference_array']
    seen = set()
    for ex in enhancer.get_iterator('S02'):
        utt = utterances[ex['example_id']]
        seen.add(ex['example_id'])
        spans = enhancer._cache_spans(ex, ref_array)
        assert [(s, e) for _, s, e, _ in spans] == [
            (s, e) for _, s, e in utt.spans]
        assert enhancer._trim(ex, ref_array) == utt.trim
        act, target, start_cf, end_cf = enhancer._device_args(
            enhancer._example_activity(ex, ref_array), ex['speaker_id'], ex)
        assert (start_cf, end_cf) == utt.context_frames
        assert target == utt.target
        ours = session.frame_activity(utt, intervals, config)
        np.testing.assert_array_equal(np.asarray(act, bool), ours)
    assert seen == set(utterances)


def test_reference_matches_port_exact_float64(single_scene, tmp_path):
    """The witness: the port's float64 chain at exact lengths writes what
    the reference computes, up to the WAVs' PCM16 rounding (D = 4; at
    D = 24 the float64 MVDR solve of a short utterance is ill-conditioned,
    see the module's docstring)."""
    config, root, utterances, intervals = single_scene
    _, out = port_session(config, root, tmp_path, 'float64')
    params_config = json.loads(json.dumps(config))
    params_config['reference']['mvdr_load'] = 64 * EPS64
    for eid, utt in utterances.items():
        ref = check.normalized(reference.enhance_utterance(
            utt, intervals, params_config, reference.Precision('float64'),
            'cpu'))
        got = wav.read_pcm16(out / f'{eid}.wav') / 2 ** 15
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= PCM_RTOL


def test_tf32_rounding():
    x = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11,
                      1 + 2 ** -11 + 2 ** -20, -3.0e-5])
    got = chain._round_tf32(x)
    want = torch.tensor([1.0, 1 + 2 ** -10, 1.0, 1 + 2 ** -9,
                         1 + 2 ** -10, 0.0])
    want[5] = got[5]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert abs(float(got[5]) + 3.0e-5) <= 3.0e-5 * 2 ** -11
    z = torch.complex(x, -x).conj()
    assert torch.equal(chain._round_tf32(z).imag, got)


FORBIDDEN = {'jax', 'jaxlib', 'flax', 'pb_chime5_tpu'}


def imported_top_level(path):
    """Whole top-level names that the file ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_no_file_of_the_benchmark_imports_jax():
    files = sorted(BENCH.rglob('*.py'))
    assert len(files) > 20
    for path in files:
        found = imported_top_level(path)
        assert not found & FORBIDDEN, (path, found)
        if 'reference' in path.relative_to(BENCH).parts:
            assert 'pb_chime5_tpu_torch' not in found, path


def loaded_top_level(code):
    """Whole top-level names of the modules a fresh process loads while
    running ``code``."""
    out = subprocess.run(
        [sys.executable, '-c', code + '\nimport sys\nprint(" ".join(sorted('
         '{n.split(".")[0] for n in sys.modules})))'],
        cwd=REPO, capture_output=True, text=True, timeout=300, check=True,
        env={**os.environ, 'PYTHONPATH': str(REPO)})
    return set(out.stdout.split())


def test_reference_loads_neither_jax_nor_the_program():
    """The reference, and the deployments' corpus and reading: CHiME-5's
    (the module imported, and loaded by its path as a run loads it) and
    the CHiME-6 test deployment's."""
    names = loaded_top_level(
        'import gss_bench.reference, gss_bench.reference.chain, '
        'gss_bench.reference.session, gss_bench.reference.wav\n'
        'import tempfile\n'
        'from pathlib import Path\n'
        'from gss_bench import run\n'
        'from gss_bench.deployments import chime5\n'
        'from gss_bench.tests import chime6_track1\n'
        'from gss_bench.tests.harness_util import tiny_chime6_config, '
        'tiny_config, tiny_traffic\n'
        'config = tiny_config()\n'
        'with tempfile.TemporaryDirectory() as tmp:\n'
        '    for module, config in ((chime5, config), '
        '(run.load_deployment(config), config), '
        '(chime6_track1, tiny_chime6_config())):\n'
        '        root = Path(tmp) / module.__name__\n'
        '        module.write_corpus(root, config, tiny_traffic('
        '"s02_dense"), 3, "cpu")\n'
        '        assert module.load_session(root, config)[0]\n')
    assert 'torch' in names
    assert not names & (FORBIDDEN | {'pb_chime5_tpu_torch'})


def test_benchmark_loads_no_jax():
    """Every module of the benchmark, its tests included, every metric
    and the program's entry, in one fresh process."""
    modules = sorted(
        '.'.join(p.relative_to(REPO).with_suffix('').parts)
        for p in BENCH.rglob('*.py')
        if p.parent.name != 'metrics' and p.name != '__init__.py')
    metrics = sorted(p.stem for p in (BENCH / 'metrics').glob('*.py'))
    names = loaded_top_level(
        ''.join(f'import {m}\n' for m in modules)
        + 'from gss_bench.run import load_metric\n'
        + ''.join(f'load_metric({m!r})\n' for m in metrics)
        + 'import pb_chime5_tpu_torch.models.enhancer, '
        'pb_chime5_tpu_torch.database.create_json')
    assert 'pb_chime5_tpu_torch' in names and 'pytest' in names
    assert not names & FORBIDDEN
