"""A cell on several cards (``gss_bench/ranks.py``) on the CPU: the merge
of the ranks' records that every reader reads, the ranks' straggler
wait, the split's numbers, a run of two ranks end to end, a run with the
timed path broken in every rank coming out not correct (the split's
faults: the exchange between ranks left out, half of each share left
out; and the one-card cells' faults), and a rank that fails or hangs
ending the run in bounded time with no result line."""

import os
import time

import pytest

from gss_bench import ranks, run
from gss_bench.tests.harness_util import (
    TINY_RANKS, result, run_cpu, tiny_copy)
from gss_bench.tests.test_gss_bench_control import FAULTS


def rank_record(rank, *, written, stages, wall, cache, least, trace, peak,
                calls):
    return {'rank': rank, 'window_s': 10.0, 'window_start': 100.0,
            'setup_s': 5.0, 'rank_setup_s': 4.0, 'block_s': 10.5 + rank,
            'written': written, 'written_all': len(written) + 1,
            'jobs_ms': None, 'peak_bytes': peak, 'stages': stages,
            'stages_wall_s': wall, 'cache': cache, 'least': least,
            'trace': trace, 'traced_from_s': 7.0 + 0.01 * rank,
            'dispatched': len(written) + 1, 'builds': {}, 'calls': calls,
            'call_ids': [[e for _, e in written]], 'spans': None}


def two_records():
    call = {'stft': 1.0, 'wpe': 60.0, 'em': 30.0, 'beamform': 3.0,
            'istft': 1.0}
    return [
        rank_record(
            0, written=[(1.0, 'a'), (4.0, 'b')], stages=[call] * 2,
            wall=0.5, peak=2 ** 30,
            cache={'hits': 90, 'refills': 10, 'direct': 0,
                   'refill_s': 0.25, 'prefetch_s': 0.15},
            least={'wpe': 0.03, 'em': 0.006},
            trace={'busy_s': 2.7, 'window_s': 3.0,
                   'device_ops': [['k1', 1.5], ['k2', 1.2]],
                   'idle_gaps': [['gss.dispatch', 0.3]]},
            calls=[(5.0, 2, False)]),
        rank_record(
            1, written=[(2.0, 'c'), (3.0, 'd'), (6.0, 'e')],
            stages=[dict(call, wpe=40.0, em=20.0)] * 2, wall=1.5,
            peak=3 * 2 ** 30,
            cache={'hits': 70, 'refills': 30, 'direct': 0,
                   'refill_s': 0.35, 'prefetch_s': 0.05},
            least={'wpe': 0.01, 'em': 0.002},
            trace={'busy_s': 2.1, 'window_s': 3.0,
                   'device_ops': [['k2', 1.0], ['k3', 0.5]],
                   'idle_gaps': [['gss.dispatch', 0.5],
                                 ['no host op', 0.4]]},
            calls=[(5.2, 3, False)])]


def test_merge_gives_the_node_sums_and_per_card_means():
    records = two_records()
    merged = ranks.merge(records)
    merged['setup_s'] = 12.0
    merged['emitted_s'] = {'a': 1.0, 'b': 2.0, 'c': 3.0, 'd': 4.0,
                           'e': 5.0}
    assert set(merged) >= set(rank_record(
        0, written=[], stages=None, wall=None, cache=None, least=None,
        trace=None, peak=None, calls=[])) - {
        'rank', 'rank_setup_s', 'dispatched', 'builds', 'calls', 'call_ids'}
    assert merged['written'] == [(1.0, 'a'), (2.0, 'c'), (3.0, 'd'),
                                 (4.0, 'b'), (6.0, 'e')]
    assert merged['written_all'] == 7 and merged['block_s'] == 11.5
    read = {m: run.load_metric(m) for m in (
        'xrt_emitted', 'peak_device_gib', 'setup_s', 'outside_chains_pct',
        'wpe_ms_per_utt', 'em_ms_per_utt', 'wpe_roofline_pct',
        'em_roofline_pct', 'cache_hit_pct', 'cache_refill_ms_per_utt',
        'device_idle_pct')}
    # the node's throughput; the fullest card's peak; the parent's set-up
    assert read['xrt_emitted'](merged) == pytest.approx(1.5)
    assert read['peak_device_gib'](merged) == pytest.approx(3.0)
    assert read['setup_s'](merged) == 12.0
    # each chain counts once: the mean over both cards' chains
    assert read['wpe_ms_per_utt'](merged) == pytest.approx(50.0)
    assert read['em_ms_per_utt'](merged) == pytest.approx(25.0)
    # shares over summed seconds: the cards' mean, weighted by their time
    inside = (2 * 95.0 + 2 * 65.0) / 1e3
    assert read['outside_chains_pct'](merged) == pytest.approx(
        100 * (1 - inside / 2.0))
    assert read['wpe_roofline_pct'](merged) == pytest.approx(
        100 * 0.04 / 0.2)
    assert read['em_roofline_pct'](merged) == pytest.approx(
        100 * 0.008 / 0.1)
    assert read['cache_hit_pct'](merged) == pytest.approx(80.0)
    assert read['cache_refill_ms_per_utt'](merged) == pytest.approx(
        1e3 * 0.8 / 7)
    assert read['device_idle_pct'](merged) == pytest.approx(20.0)
    trace = merged['trace']
    assert trace['device_ops'] == [['k2', 2.2], ['k1', 1.5], ['k3', 0.5]]
    assert trace['idle_gaps'] == [['gss.dispatch', 0.8],
                                  ['no host op', 0.4]]
    info, breakdown = run._device_info(None, False, 2, merged['peak_bytes'],
                                       None, trace)
    assert info['busy_s'] == pytest.approx(2.4)
    assert info['window_s'] == pytest.approx(3.0)
    assert breakdown == {k: trace[k] for k in ('device_ops', 'idle_gaps')}


def test_merged_spans_read_as_one_pool():
    """The span metrics read every rank's kept spans as one process's:
    each mean over all the ranks' spans, so weighted by their counts."""
    records = two_records()
    ms = 1_000_000
    records[0]['spans'] = [['gss.session_setup', 0, 4 * ms],
                           ['gss.prepare_wait', 4 * ms, 10 * ms],
                           ['gss.dispatch', 10 * ms, 13 * ms],
                           ['gss.write_wait', 13 * ms, 15 * ms]]
    records[1]['spans'] = [['gss.session_setup', 0, 6 * ms],
                           ['gss.dispatch', 6 * ms, 11 * ms],
                           ['gss.dispatch', 11 * ms, 18 * ms],
                           ['gss.write_wait', 18 * ms, 22 * ms]]
    merged = ranks.merge(records)
    assert len(merged['spans']) == 8

    def read(name):
        return run.load_metric(name)(merged)
    assert read('session_setup_ms_per_call') == pytest.approx(5.0)
    assert read('prepare_wait_ms_per_utt') == pytest.approx(6.0)
    assert read('dispatch_host_ms_per_utt') == pytest.approx(15 / 3)
    assert read('write_wait_ms_per_utt') == pytest.approx(6 / 3)
    # the calling thread's spans cover 0.8 of the cards' 1.2 s idle
    assert read('idle_outside_spans_pct') == pytest.approx(
        100 * (1 - 0.8 / 1.2))
    # a rank without spans adds none; no rank with spans: nothing to read
    records[1]['spans'] = None
    assert len(ranks.merge(records)['spans']) == 4
    records[0]['spans'] = None
    assert ranks.merge(records)['spans'] is None


def test_merge_of_ranks_with_nothing_to_read():
    records = two_records()
    for r in records:
        r.update(stages=None, stages_wall_s=None, cache=None, least=None,
                 trace=None, peak_bytes=None)
    merged = ranks.merge(records)
    assert merged['stages'] is None and merged['stages_wall_s'] is None
    assert merged['cache'] is None and merged['trace'] is None
    assert merged['peak_bytes'] is None
    for name in ('outside_chains_pct', 'wpe_ms_per_utt', 'cache_hit_pct',
                 'device_idle_pct', 'peak_device_gib'):
        assert run.load_metric(name)(merged) is None


def test_rank_wait_ms_per_call():
    read = run.load_metric('rank_wait_ms_per_call')
    record = {'call_ends': [[1.0, 2.0, 3.0, 9.5], [1.2, 2.1, 3.6, 9.6],
                            [1.1, 2.0, 3.0]],
              'traced_from_s': 8.0}
    # calls 0-2 ended before the slice on every rank; the last is left out
    waits = [0.2, 0.0, 0.1, 0.1, 0.0, 0.1, 0.6, 0.0, 0.6]
    assert read(record) == pytest.approx(1e3 * sum(waits) / 9)
    assert read(dict(record, traced_from_s=1.15)) is None
    assert read({'call_ends': [[1.0]], 'traced_from_s': 8.0}) is None
    assert read({'written': []}) is None


def test_split_numbers():
    utterances = {e: None for e in 'abcde'}

    def records(*calls):
        return [{'calls': [(1.0, 0, cut) for _, cut in rank_calls],
                 'call_ids': [list(ids) for ids, _ in rank_calls]}
                for rank_calls in zip(*calls)]
    # two calls, the second cut by the deadline on rank 1
    sound = records([('ab', False), ('cde', False)],
                    [('a', False), ('bc', True)])
    assert ranks.split_rows(sound, utterances) == [
        ('shard_missing', 0, 0), ('shard_shared', 0, 0)]
    every_rank_all = records([('abcde', False), ('abcde', False)])
    assert ranks.split_rows(every_rank_all, utterances) == [
        ('shard_missing', 0, 0), ('shard_shared', 5, 0)]
    half_left_out = records([('a', False), ('cd', False)])
    assert ranks.split_rows(half_left_out, utterances) == [
        ('shard_missing', 2, 0), ('shard_shared', 0, 0)]


def test_two_ranks_end_to_end(tmp_path):
    """Two rank processes on the CPU through the program's gloo path, the
    default split and ``raise_together``: the merged line is correct,
    the split's numbers read 0, the per-layer metrics that the merged
    record serves are there, the span metrics among them."""
    root = tiny_copy(tmp_path)
    proc = run_cpu(root, TINY_RANKS, trace=1, seconds=6)
    line = result(proc)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line['correct'] is True, proc.stderr[-3000:]
    assert line['checks']['shard_missing']['value'] == 0
    assert line['checks']['shard_shared']['value'] == 0
    assert line['attempted'] > 0 and line['failed'] == 0
    assert 'cache_hit_pct' in line['metrics']
    assert 'xrt_emitted' not in line['metrics']
    # the ranks' spans, read as one pool
    for name in ('prepare_wait_ms_per_utt', 'dispatch_host_ms_per_utt',
                 'write_wait_ms_per_utt', 'session_setup_ms_per_call'):
        assert line['metrics'][name]['value'] > 0, line['metrics']
    assert 'rank 0:' in proc.stderr and 'rank 1:' in proc.stderr


SPLIT_FAULTS = {
    # every rank enhances every utterance: no split, no exchange
    'exchange between ranks left out': ('shard_shared', (
        'import pb_chime5_tpu_torch.parallel.scheduler as s\n'
        's.process_info = lambda: (0, 1)\n')),
    # each rank leaves out every other utterance of its share
    'half of each share left out': ('shard_missing', (
        'import pb_chime5_tpu_torch.parallel.scheduler as s\n'
        'real = s.length_balanced_shard\n'
        's.length_balanced_shard = lambda items, length_fn: '
        'real(items, length_fn)[::2]\n')),
}


# the one-card cells' faults, planted in every rank
RANK_FAULTS = dict(SPLIT_FAULTS, **{
    name: (None, patch) for name, patch in FAULTS.items()})


@pytest.mark.parametrize('fault', sorted(RANK_FAULTS))
def test_broken_timed_path_on_ranks_is_not_correct(tmp_path, fault):
    number, patch = RANK_FAULTS[fault]
    root = tiny_copy(tmp_path)
    proc = run_cpu(root, TINY_RANKS, seconds=15, rank_patch=patch)
    line = result(proc)
    assert proc.returncode == 0 and line is not None, proc.stderr[-3000:]
    assert line['correct'] is False, line['checks']
    if number is not None:
        assert line['checks'][number]['value'] > 0, line['checks']


FAILING_RANKS = {
    'a rank exits non-zero': (
        'import os, sys, time\n'
        'open(os.environ["PIDS"] + os.environ["RANK"], "w")'
        '.write(str(os.getpid()))\n'
        'sys.exit(1) if os.environ["RANK"] == "1" else time.sleep(600)\n',
        ''),
    'the ranks hang': (
        'import os, time\n'
        'open(os.environ["PIDS"] + os.environ["RANK"], "w")'
        '.write(str(os.getpid()))\n'
        'time.sleep(600)\n',
        'ranks.SETUP_LIMIT_S = 3\n'),
}


@pytest.mark.parametrize('failure', sorted(FAILING_RANKS))
def test_failing_rank_ends_the_run(tmp_path, failure):
    """A rank that exits non-zero, or ranks not done by the hard limit:
    every rank is stopped, the run exits non-zero within seconds and
    prints no result line."""
    rank_code, limit = FAILING_RANKS[failure]
    root = tiny_copy(tmp_path)
    pids = tmp_path / 'pid'
    os.environ['PIDS'] = str(pids)
    try:
        started = time.perf_counter()
        proc = run_cpu(root, TINY_RANKS, seconds=1, patch=(
            'import sys\nfrom gss_bench import ranks\n' + limit
            + f'ranks.rank_command = lambda *a: [sys.executable, "-c", '
              f'{rank_code!r}]\n'))
        elapsed = time.perf_counter() - started
    finally:
        del os.environ['PIDS']
    assert proc.returncode != 0
    assert result(proc) is None and proc.stdout.strip() == ''
    assert 'every rank stopped' in proc.stderr
    assert elapsed < 120
    for rank in (0, 1):
        pid = int((tmp_path / f'pid{rank}').read_text())
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
