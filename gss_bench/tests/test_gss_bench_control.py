"""The check that decides ``correct`` fails what it must (CPU, small
sizes):

* the control, the reference computed in TF32 in the program's place, is
  not correct under each configuration's limits;
* a run with the timed path broken underneath comes out not correct, for
  each fault a cell of this benchmark can have: a step that returns its
  state unchanged (WPE returning its input; the EM's parameters never
  updated after the first M-step), an answer altered where it is
  produced (the second half of each waveform zeroed), and answers that
  never come (WAVs not written).  Half of a batch left out and the
  exchange between chips do not exist here: every cell dispatches one
  utterance at a time on one card;
* two wrong answers in a full sample of sound ones are not correct.
"""

import json

import pytest

from gss_bench import check, reference
from gss_bench.deployments import chime5
from gss_bench.tests.harness_util import (
    BENCH, result, run_cpu, tiny_copy, tiny_traffic)

FAULTS = {
    'wpe returns its input': (
        'import pb_chime5_tpu_torch.models.gss as gss\n'
        'gss._wpe_stage = lambda Obs, config, frame_mask: Obs'),
    'em parameters never updated': (
        'import pb_chime5_tpu_torch.ops.cacgmm as cacgmm\n'
        'first = {}\n'
        'real = cacgmm._finalize\n'
        'def frozen(S, denom, config, *, batched=True):\n'
        '    params = real(S, denom, config, batched=batched)\n'
        '    return first.setdefault(S.shape, params)\n'
        'cacgmm._finalize = frozen'),
    'answer altered where it is produced': (
        'import pb_chime5_tpu_torch.models.gss as gss\n'
        'real = gss.GssPipeline.gather\n'
        'def altered(handle, return_masks=False):\n'
        '    x = real(handle).copy()\n'
        '    x[len(x) // 2:] = 0\n'
        '    return x\n'
        'gss.GssPipeline.gather = staticmethod(altered)'),
    'answers never come': (
        'import pb_chime5_tpu_torch.models.enhancer as enhancer\n'
        'enhancer.dump_audio = lambda x, path, **kw: None'),
}


@pytest.mark.parametrize('config_name, duration', [
    ('chime5_single_array', 40), ('chime5_multiarray', 24)])
def test_control_is_not_correct(tmp_path, config_name, duration):
    """The control on a small session of each configuration, over its
    utterances of at least the configuration's ``min_seconds``."""
    config = json.loads((BENCH / 'configs' / f'{config_name}.json')
                        .read_text())
    config['session_duration_s'] = duration
    config['enhancer']['context_samples'] = 8000
    traffic = tiny_traffic('s02_dense')
    traffic['length'].update(mean_s=3.5, min_s=3.0, max_s=5.0)
    traffic['rate_per_s'] = 0.15
    root = tmp_path / 'CHiME5'
    chime5.write_corpus(root, config, traffic, 2 ** 31 + 21, 'cpu')
    utterances, intervals = chime5.load_session(root, config)
    ids = sorted(e for e, u in utterances.items()
                 if u.emitted_seconds >= config['correct']['min_seconds'])
    assert len(ids) >= 3
    _, sensitivity, controls = check.errors(
        tmp_path / 'none', utterances, intervals, config, ids, 'cpu',
        control=True)
    assert all(e is not None for e in controls.values())
    values = dict(check.numbers(controls, sensitivity,
                                config['correct']['stable_below']),
                  wrong_length=0)
    correct, rows = check.verdict(values, config['correct']['limits'])
    assert not correct, rows


@pytest.mark.parametrize('config_name', ['chime5_single_array',
                                         'chime5_multiarray'])
def test_a_few_wrong_answers_are_not_correct(config_name):
    """Two of a full sample's utterances wrong (reading 1) among sound
    ones: the steady number over the whole sample (median, geometric
    mean) lets them pass, the second largest error over the stable
    utterances does not."""
    spec = json.loads((BENCH / 'configs' / f'{config_name}.json')
                      .read_text())['correct']
    ids = [f'u{i}' for i in range(spec['sample'])]
    stable = {i: 0.0 for i in ids}
    sound = {i: 1e-4 for i in ids}
    wrong = dict(sound, u0=1.0, u1=1.0)
    for errs, want in ((sound, True), (wrong, False)):
        values = dict(check.numbers(errs, stable, spec['stable_below']),
                      wrong_length=0)
        correct, rows = check.verdict(values, spec['limits'])
        assert correct is want, rows
        steady = {n: v for n, v in spec['limits'].items()
                  if n in ('err_median', 'err_geomean')}
        assert check.verdict(values, steady)[0], rows


@pytest.mark.parametrize('fault', sorted(FAULTS))
def test_broken_timed_path_is_not_correct(tmp_path, fault):
    root = tiny_copy(tmp_path)
    proc = run_cpu(root, 'tiny.session', seconds=4, patch=FAULTS[fault])
    line = result(proc)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line['correct'] is False, line['checks']


def test_sound_timed_path_is_correct(tmp_path):
    root = tiny_copy(tmp_path)
    proc = run_cpu(root, 'tiny.session', seconds=4, seed=2 ** 31 + 22)
    line = result(proc)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line['correct'] is True, line['checks']
