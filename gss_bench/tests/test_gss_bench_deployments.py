"""Deployments (``gss_bench/deployments/``) on the CPU:

* the CHiME-5 deployment writes the same corpus, the same program
  database and the same reference reading as the harness did before
  deployments were modules, byte for byte, single- and multi-array, on
  two seeds;
* a deployment added as files only: the CHiME-6 track-1 deployment
  (``chime6_track1.py``, written into a tiny copy by ``harness_util``)
  runs the session, jobs and two-rank drives with ``correct`` true; its
  reference reads what the port reads (examples, channels, spans,
  context frames, trim, activity and the observation's samples); a copy
  whose reference reads all four microphones of each array reads
  otherwise and comes out not correct.
"""

import dataclasses
import hashlib
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gss_bench import reference
from gss_bench.deployments import chime5
from gss_bench.reference import session
from gss_bench.tests import chime6_track1
from gss_bench.tests.harness_util import (
    CHIME6_CELLS, CHIME6_RANKS, CHIME6_SOURCE, result, run_cpu,
    tiny_chime6_config, tiny_config, tiny_copy, tiny_traffic,
    write_chime6_deployment)

# Digests of what commit e2f00527af15 (the harness before deployments were
# modules) wrote and read, by its corpus.make_session, create_database and
# reference.load_session, with 4 CPU threads (the synthesis's float sums
# depend on the thread count): the corpus's files, the database JSON with
# the corpus root replaced by '<root>', and the reading
# (utterances, intervals) as canonical JSON.
PINNED = {
    (False, 7): (
        'afcd0eb5a3516d133b8522a0ea6bf4f44bc128b33d87a75db3d7785dd68c10c8',
        'dd059871803dfbcdd3e1059e76a5b85ee3cbb1674c035bf90a8fa9bb19ff9800',
        'd5cb027b3bee7ae333db23385970e80edecbbc37e6b77c1902bd39611fa3090f'),
    (False, 2 ** 31 + 33): (
        '9f54d396b3abc63d9ed5c30654b36625fa831a7f87a9bb6961ee819bb109ca83',
        '0102109ef1ccb2acf9cc6fad6532f18a0a5ba8581767c34819208edf153f00ce',
        'af211f39cff18a779db2ab466180be183078aa9dbb8ec5d1fa83ad99c87b970b'),
    (True, 7): (
        '0b3c905210e507fff99ac537fd31f53f7f05f75c922c789a148e162a0dcf4a50',
        '1c91e2c59cdb2c4c8418c74e7a1456d4c4938f00b9e932e0768409fcc31a4104',
        'fad2e1458ae1a0c56ef98a6cf433314aa05765e3f818f36816cb937e5debc33a'),
    (True, 2 ** 31 + 33): (
        'bf9bde03eba72f80928334332ebbb23e8844460a45cbdb1540f16a34fd91715e',
        '1fd74eac44aba344603e820aa980ad12908992398ecc8ffa936fd5b8c44beb32',
        '33783282745333dbf13a2562c9dcdf2c4d0ea033633224b26e8e2875364542db'),
}


def sha256(data):
    return hashlib.sha256(data).hexdigest()


def digests(root, database, utterances, intervals):
    """(corpus, database, reading) digests, as ``PINNED`` has them."""
    manifest = ''.join(
        f'{p.relative_to(root).as_posix()} {sha256(p.read_bytes())}\n'
        for p in sorted(root.rglob('*')) if p.is_file())

    def plain(utt):
        d = dataclasses.asdict(utt)
        d['paths'] = {a: [Path(p).relative_to(root).as_posix() for p in ps]
                      for a, ps in d['paths'].items()}
        return d
    reading = json.dumps([{e: plain(u) for e, u in sorted(utterances.items())},
                          intervals], sort_keys=True)
    return (sha256(manifest.encode()),
            sha256(database.read_text().replace(str(root), '<root>')
                   .encode()),
            sha256(reading.encode()))


@pytest.mark.parametrize('multiarray, seed', sorted(PINNED))
def test_chime5_reads_as_before(tmp_path, multiarray, seed):
    config = tiny_config(multiarray=multiarray)
    root = tmp_path / chime5.corpus_dir
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        chime5.write_corpus(root, config, tiny_traffic('s02_dense'), seed,
                            'cpu')
    finally:
        torch.set_num_threads(threads)
    utterances, intervals = chime5.load_session(root, config)
    chime5.open_enhancer(tmp_path, root, config, 'cpu')
    assert len(list(root.rglob('*.wav'))) == (24 if multiarray else 4)
    assert digests(root, tmp_path / 'chime5.json', utterances,
                   intervals) == PINNED[multiarray, seed]


def reading_mismatches(deployment, config, tmp_path, seed=2 ** 31 + 41):
    """Where the deployment's reference reading departs from the port's
    on a tiny session: [(example_id, what)]."""
    root = tmp_path / deployment.corpus_dir
    deployment.write_corpus(root, config, tiny_traffic('s02_dense'), seed,
                            'cpu')
    utterances, intervals = deployment.load_session(root, config)
    enhancer = deployment.open_enhancer(tmp_path, root, config, 'cpu')
    found, seen = [], set()
    for ex in enhancer.get_iterator(config['session']['session_id']):
        eid = ex['example_id']
        utt = utterances[eid]
        seen.add(eid)
        port = [([str(ps[i]) for i in sel], s, e)
                for ps, s, e, sel in enhancer._cache_spans(ex, None)]
        ours = [([str(p) for p in utt.paths[a]], s, e)
                for a, s, e in utt.spans]
        act, target, start_cf, end_cf = enhancer._device_args(
            enhancer._example_activity(ex, None), ex['speaker_id'], ex)
        checks = {
            'spans and channels': port == ours,
            'trim': enhancer._trim(ex, None) == utt.trim,
            'context frames': (start_cf, end_cf) == utt.context_frames,
            'target': target == utt.target,
            'activity': np.array_equal(np.asarray(act, bool),
                                       session.frame_activity(
                                           utt, intervals, config)),
            'observation': np.array_equal(
                enhancer._load_observation_flat(ex),
                reference.observation(utt))}
        found += [(eid, what) for what, same in checks.items() if not same]
    if seen != set(utterances):
        found.append((None, 'examples'))
    return found


def test_chime6_reading_matches_port(tmp_path):
    config = tiny_chime6_config()
    assert reading_mismatches(chime6_track1, config, tmp_path) == []
    utt = next(iter(chime6_track1.load_session(
        tmp_path / chime6_track1.corpus_dir, config)[0].values()))
    assert [p.name for p in utt.paths['U02']] == ['S02_U02.CH1.wav',
                                                  'S02_U02.CH4.wav']
    assert sum(len(ps) for ps in utt.paths.values()) == 4


ALL_MICS = CHIME6_SOURCE.read_text().replace(
    'OUTER_MICS = (0, -1)', 'OUTER_MICS = (0, 1, 2, -1)')


def test_chime6_reading_all_mics_departs_from_port(tmp_path):
    """The planted fault: a reference that stacks all four microphones of
    each array reads other channels than the port."""
    assert ALL_MICS != CHIME6_SOURCE.read_text()
    path = tmp_path / 'all_mics.py'
    path.write_text(ALL_MICS)
    spec = importlib.util.spec_from_file_location('all_mics', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    found = reading_mismatches(module, tiny_chime6_config(), tmp_path)
    assert {what for _, what in found} == {'spans and channels',
                                           'observation'}


@pytest.mark.parametrize('workload, trace_flag', [
    (CHIME6_CELLS[0], 1), (CHIME6_CELLS[1], 0), (CHIME6_RANKS, 0)])
def test_chime6_deployment_end_to_end(tmp_path, workload, trace_flag):
    """The deployment added as files is found by its configuration's
    name and runs each drive, correct."""
    root = tiny_copy(tmp_path)
    proc = run_cpu(root, workload, trace=trace_flag,
                   seconds=10 if workload == CHIME6_RANKS else 8)
    line = result(proc)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line['correct'] is True, proc.stderr[-3000:]
    assert line['attempted'] > 0 and line['failed'] == 0
    if workload == CHIME6_RANKS:
        assert line['checks']['shard_missing']['value'] == 0
        assert line['checks']['shard_shared']['value'] == 0
    if trace_flag:
        assert 'cache_hit_pct' in line['metrics']


def test_chime6_reference_of_all_mics_is_not_correct(tmp_path):
    root = tiny_copy(tmp_path)
    write_chime6_deployment(root, ALL_MICS)
    proc = run_cpu(root, CHIME6_CELLS[0], seconds=8)
    line = result(proc)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line['correct'] is False, line['checks']
    # the WAVs were written: the errors, not their absence, fail the run
    assert line['checks']['wrong_length']['value'] == 0, line['checks']
