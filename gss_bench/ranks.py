"""A cell on N cards, as upstream deploys GSS (``mpiexec -np N``, one
worker a GPU): one rank process a card, joined in the program's gloo
process group, each enhancing its share of every pass over the session.

The parent (``gss_bench/run.py``) makes the corpus and builds the
program's libraries, then :func:`launch` starts the ranks:

    python -m gss_bench.ranks --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> --workdir <dir> --device <cuda|cpu>

with ``CUDA_VISIBLE_DEVICES`` its own card and ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` set.  A rank joins through
``pb_chime5_tpu_torch.parallel.distributed.maybe_initialize()``, reads
the corpus and readies its enhancer as a one-card run does (its database
in ``<workdir>/database<r>``), waits at a barrier, and takes rank
0's host clock as the common window start (``time.perf_counter()``, the
host's monotonic clock, which every process shares), so every rank has
the same deadline.  Each call takes the program's default split
(``gss_bench/drive.py::run_rank``).  A rank writes its record
(``run.timed_window``'s, with its calls) to ``<workdir>/rank<r>.json``;
:func:`merge` makes one record of them with the same keys, which the
metrics read unchanged: the node's WAVs, the fullest card's peak, the
counters, stage times and least work summed (so a share reads the
per-card mean), the profiled slices' busy and traced seconds summed, and
the spans that each rank kept (those that ended before its own profiled
slice) in one pool, which the span metrics read as they read one
process's.

A rank that exits non-zero, or ranks not done by the hard limit, stop
every rank; the run then prints no result.
"""

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

from gss_bench import drive, run
from gss_bench.metrics.dispatch_host_ms_per_utt import kept

__all__ = ['SETUP_LIMIT_S', 'launch', 'merge', 'describe', 'split_rows',
           'main']

# a rank's allowance beyond the window: process start, the group's join,
# the enhancer's warm-up and the calls in flight at the deadline (on an
# H100 node about 5-20 s; the parent has built the libraries)
SETUP_LIMIT_S = 300


def _free_port():
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def rank_command(args, workdir, device):
    """The command of one rank."""
    return [sys.executable, '-m', 'gss_bench.ranks', '--workload',
            args.workload, '--seed', str(args.seed), '--seconds',
            str(args.seconds), '--trace', str(args.trace), '--workdir',
            str(workdir), '--device', device]


def _rank_env(rank, n, port, device):
    env = dict(os.environ, MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
               WORLD_SIZE=str(n), RANK=str(rank))
    if device == 'cuda':
        visible = os.environ.get('CUDA_VISIBLE_DEVICES')
        cards = visible.split(',') if visible else [str(c) for c in range(n)]
        env['CUDA_VISIBLE_DEVICES'] = cards[rank]
    # the host's cores shared out, as each card's share of a node
    env.setdefault('OMP_NUM_THREADS',
                   str(max(1, len(os.sched_getaffinity(0)) // n)))
    return env


def _stop(procs):
    for proc in procs:
        if proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    for proc in procs:
        proc.wait()


def launch(args, n, workdir, device, limit_s):
    """Start ``n`` ranks and wait for them -> their records, in rank
    order; None where a rank exited non-zero or left no record, or the
    ranks were not done within ``limit_s`` seconds.  Every rank is
    stopped before this returns."""
    port = _free_port()
    procs = []
    previous = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        for rank in range(n):
            procs.append(subprocess.Popen(
                rank_command(args, workdir, device), cwd=run.HERE.parent,
                env=_rank_env(rank, n, port, device), stdout=2,
                start_new_session=True))
        limit = time.perf_counter() + limit_s
        while True:
            codes = [proc.poll() for proc in procs]
            failed = [(r, c) for r, c in enumerate(codes)
                      if c not in (None, 0)]
            if failed:
                print(f'rank {failed[0][0]} exited with {failed[0][1]}: '
                      f'every rank stopped', file=sys.stderr)
                return None
            if all(c == 0 for c in codes):
                break
            if time.perf_counter() > limit:
                print(f'ranks not done within {limit_s} s: every rank '
                      f'stopped', file=sys.stderr)
                return None
            time.sleep(0.1)
        try:
            return [json.loads((Path(workdir) / f'rank{r}.json').read_text())
                    for r in range(n)]
        except (OSError, ValueError) as e:
            print(f'a rank left no record: {e}', file=sys.stderr)
            return None
    finally:
        _stop(procs)
        signal.signal(signal.SIGTERM, previous)


def _summed(parts):
    parts = [p for p in parts if p]
    if not parts:
        return None
    return {k: sum(p.get(k, 0) for p in parts) for k in parts[0]}


def _merged_trace(traces, top=10):
    traces = [t for t in traces if t]
    if not traces:
        return None

    def by_name(key):
        totals = {}
        for t in traces:
            for name, seconds in t[key]:
                totals[name] = totals.get(name, 0.0) + seconds
        return [[n, v] for n, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {'busy_s': sum(t['busy_s'] for t in traces),
            'window_s': sum(t['window_s'] for t in traces),
            'device_ops': by_name('device_ops'),
            'idle_gaps': by_name('idle_gaps'), 'cards': len(traces)}


def merge(records):
    """One record of the ranks' ``records``, with the keys of a one-card
    record (``setup_s`` and ``emitted_s`` are the parent's to set), plus
    ``call_ends`` (each rank's call ends from the window's start),
    ``window_start`` and ``spans`` (every rank's kept spans, or None where
    no rank recorded any)."""
    staged = [r for r in records if r['stages'] and r['stages_wall_s']]
    peaks = [r['peak_bytes'] for r in records if r['peak_bytes'] is not None]
    jobs = [j for r in records for j in (r['jobs_ms'] or ())]
    return {
        'window_s': records[0]['window_s'],
        'window_start': records[0]['window_start'],
        'setup_s': None,
        'block_s': max(r['block_s'] for r in records),
        'written': sorted((t, e) for r in records for t, e in r['written']),
        'written_all': sum(r['written_all'] for r in records),
        'emitted_s': None,
        'jobs_ms': jobs or None,
        'peak_bytes': max(peaks) if peaks else None,
        'stages': [call for r in staged for call in r['stages']] or None,
        'stages_wall_s': sum(r['stages_wall_s'] for r in staged) or None,
        'cache': _summed(r['cache'] for r in records),
        'least': _summed(r['least'] for r in records),
        'trace': _merged_trace(r['trace'] for r in records),
        'traced_from_s': min(r['traced_from_s'] for r in records),
        'call_ends': [[end for end, _, _ in r['calls']] for r in records],
        'spans': _pooled(r['spans'] for r in records),
    }


def _pooled(parts):
    parts = [p for p in parts if p is not None]
    return [s for p in parts for s in p] if parts else None


def split_rows(records, utterances):
    """The split's numbers compared, exactly (limit 0):
    ``shard_shared``, WAVs written more than once in one call over the
    ranks (a call is one pass over the session); ``shard_missing``, the
    session's utterances that no rank wrote in a call that the deadline
    cut on none."""
    everyone = set(utterances)
    shared = missing = 0
    for i in range(max(len(r['calls']) for r in records)):
        parts = [r['call_ids'][i] for r in records if i < len(r['calls'])]
        union = set().union(*parts)
        shared += sum(len(p) for p in parts) - len(union)
        if all(i < len(r['calls']) and not r['calls'][i][2]
               for r in records):
            missing += len(everyone - union)
    return [('shard_missing', missing, 0), ('shard_shared', shared, 0)]


def describe(record, emitted_s, seconds):
    """One rank's figures, a line for standard error."""
    xrt = sum(emitted_s[e] for _, e in record['written']) / seconds
    trace = record['trace']
    busy = (f', busy {trace["busy_s"]:.4f} of {trace["window_s"]:.4f} s '
            f'traced from {record["traced_from_s"]:.3f} s' if trace else '')
    peak = record['peak_bytes']
    spans = record['spans']
    return (f'rank {record["rank"]}: setup {record["rank_setup_s"]:.3f} s, '
            f'{len(record["written"])} WAVs in the window of '
            f'{record["dispatched"]} dispatched, xrt_emitted {xrt:.4f}, '
            f'{len(record["calls"])} calls ending at '
            + ', '.join(f'{end:.3f}' for end, _, _ in record['calls'])
            + f' s, peak {peak if peak is None else peak / 2 ** 30} GiB'
            f'{busy}, spans kept {spans if spans is None else len(spans)}, '
            f'builds in the window {record["builds"]}')


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    parser.add_argument('--workdir', required=True)
    parser.add_argument('--device', choices=('cuda', 'cpu'), required=True)
    args = parser.parse_args(argv)
    bench = run._load_json(run.HERE.parent / 'BENCHMARK.json')
    _, config, traffic = run.load_cell(bench, args.workload)
    deployment = run.load_deployment(config)

    import torch
    import torch.distributed as dist
    from pb_chime5_tpu_torch.parallel import distributed
    if not distributed.maybe_initialize():
        print('rank: joined no process group', file=sys.stderr)
        return 2
    rank = dist.get_rank()
    cuda = args.device == 'cuda'
    workdir = Path(args.workdir)
    sid = config['session']['session_id']
    root = workdir / deployment.corpus_dir
    utterances, intervals = deployment.load_session(root, config)
    database_dir = workdir / f'database{rank}'
    database_dir.mkdir(exist_ok=True)
    enhancer = run.ready_enhancer(deployment, database_dir, root, config,
                                  args.device, utterances)

    def agree(is_open):
        flag = torch.tensor([int(is_open)], dtype=torch.int32)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    def drive_window(window):
        distributed.barrier()
        start = torch.tensor([time.perf_counter()], dtype=torch.float64)
        dist.broadcast(start, src=0)
        drive.run_rank(enhancer, sid, workdir / 'enhanced', traffic, window,
                       float(start.item()), agree, deployment.session_time)

    record, window, builds = run.timed_window(
        args, traffic, config, utterances, intervals, enhancer, torch, cuda,
        drive_window, trace_top=None)
    del record['emitted_s']                   # the parent's to set
    spans = kept(record)                      # this process's, cut here
    ids = [e for _, e in window.written]
    bounds = [0] + [n for _, n, _ in window.calls]
    record.update(
        rank=rank, window_start=window.start,
        rank_setup_s=window.start - run._STARTED,
        dispatched=window.dispatched, builds=builds,
        calls=[(end - window.start, n, cut) for end, n, cut in window.calls],
        call_ids=[ids[a:b] for a, b in zip(bounds, bounds[1:])],
        spans=(None if spans is None
               else [[s.name, s.start_ns, s.end_ns] for s in spans]))
    found = run.forbidden_modules()
    if found:
        print(f'rank {rank}: forbidden modules loaded: {found}',
              file=sys.stderr)
        return 3
    path = workdir / f'rank{rank}.json'
    tmp = path.with_suffix('.tmp')
    tmp.write_text(json.dumps(record))
    os.replace(tmp, path)
    distributed.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == '__main__':
    sys.exit(main())
