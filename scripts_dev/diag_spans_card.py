"""The host spans of one traced benchmark run, read after it, in its own
process (one card):

    python scripts_dev/diag_spans_card.py --workload <cell> --seed <n> \
        [--seconds 45] [--out build/diag_spans.jsonl]

runs ``gss_bench.run.main(... --trace 1)`` and then reads
``utils.profiling.recorded_spans()`` as the span metrics do (the spans
that ended before the profiled slice):

* ``coverage``: the share of the calling thread's wall, from its first
  span to the profiled slice, that its top-level spans cover
  (``gss.session_setup``, ``gss.prepare_wait``, ``gss.dispatch``,
  ``gss.write_wait``);
* ``by_name``: each span name's thread role (calling, prefetch, writer,
  cache worker), count, mean and total;
* ``xrt_halves``: the ``xrt_emitted`` of the window's two halves, from
  the harness's own line (the first half runs before the profiler);
* ``clock``: a calling-thread span under ``torch.profiler`` (CPU and
  CUDA activities) against the profiler's record of it: the differences
  of start and of end over 20 spans each around a small kernel, the
  first span apart;
* ``span_cost``: a ``span`` with no recording open and recording (not
  profiled), in microseconds on this host.

One JSON line is printed and appended to ``--out``.
"""

import argparse
import contextlib
import io
import json
import re
import sys
import threading
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

class _Tee(io.TextIOBase):
    def __init__(self, stream):
        self.stream, self.parts = stream, []

    def write(self, text):
        self.parts.append(text)
        return self.stream.write(text)

    def flush(self):
        self.stream.flush()


def span_summary(spans):
    """Coverage and per-name totals of the spans before the first
    profiled one."""
    cut = min((s.start_ns for s in spans if s.profiled), default=None)
    kept = [s for s in spans if s.end_ns is not None
            and (cut is None or s.end_ns < cut)]
    calling = {s.thread for s in kept if s.name == 'gss.dispatch'}
    roles = {}
    for s in kept:
        if s.thread in calling:
            role = 'calling'
        elif s.name.startswith('cache.prefetch'):
            role = 'cache worker'
        elif s.name in ('gss.gather', 'gss.write'):
            role = 'writer'
        else:
            role = 'prefetch'
        roles.setdefault(s.name, role)
    top = sorted((s.start_ns, s.end_ns) for s in kept
                 if s.thread in calling and s.parent is None)
    covered = sum(e - s for s, e in top)
    overlap = sum(max(0, top[i][1] - top[i + 1][0])
                  for i in range(len(top) - 1))
    wall = ((cut if cut is not None else top[-1][1]) - top[0][0]
            if top else 0)
    by_name = {}
    for s in kept:
        entry = by_name.setdefault(s.name, {'role': roles[s.name],
                                            'count': 0, 'total_s': 0.0})
        entry['count'] += 1
        entry['total_s'] += (s.end_ns - s.start_ns) / 1e9
    for entry in by_name.values():
        entry['mean_ms'] = 1e3 * entry['total_s'] / entry['count']
    return {'coverage': covered / wall if wall else None,
            'calling_wall_s': wall / 1e9, 'calling_overlap_s': overlap / 1e9,
            'spans_kept': len(kept), 'spans_all': len(spans),
            'threads': len({s.thread for s in kept}), 'by_name': by_name}


def clock_check(torch, span, record_spans, recorded_spans, count=20):
    """Largest |start| and |end| differences (us) between calling-thread
    spans and the profiler's events of them, the first span apart."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    x = torch.randn(512, 512, device='cuda')
    torch.cuda.synchronize()
    with record_spans():
        with torch.profiler.profile(activities=activities) as prof:
            for i in range(count):
                with span(f'clock.{i}'):
                    (x @ x).sum()
            torch.cuda.synchronize()
    spans = {s.name: s for s in recorded_spans()}
    base = prof.profiler.kineto_results.trace_start_ns()
    diffs = {}
    for e in prof.events():
        s = spans.get(e.name)
        if s is not None and s.profiled:
            diffs[e.name] = ((base + e.time_range.start * 1000 - s.start_ns)
                             / 1e3,
                             (base + e.time_range.end * 1000 - s.end_ns)
                             / 1e3)
    later = [diffs[f'clock.{i}'] for i in range(1, count)
             if f'clock.{i}' in diffs]
    return {'spans_matched': len(diffs),
            'first_us': diffs.get('clock.0'),
            'start_us': [round(a, 1) for a, _ in later],
            'end_us': [round(b, 1) for _, b in later],
            'max_abs_start_us': max((abs(a) for a, _ in later), default=None),
            'max_abs_end_us': max((abs(b) for _, b in later), default=None)}


def span_cost(span, record_spans, number=100000):
    """Microseconds a ``with span(...)`` costs on this host: with no
    recording open, and recording (not profiled)."""
    import timeit

    def one():
        with span('gss.dispatch', 'u'):
            pass
    off = min(timeit.repeat(one, number=number, repeat=5)) / number
    with record_spans():
        on = min(timeit.repeat(one, number=number // 10, repeat=5)) \
            / (number // 10)
    return {'off_us': off * 1e6, 'recording_us': on * 1e6}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, default=45)
    parser.add_argument('--out', default='build/diag_spans.jsonl')
    args = parser.parse_args()

    import torch
    from gss_bench import run
    from pb_chime5_tpu_torch.utils.profiling import (
        record_spans, recorded_spans, span)

    out, err = _Tee(sys.stdout), _Tee(sys.stderr)
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(['--workload', args.workload, '--seed',
                       str(args.seed), '--seconds', str(args.seconds),
                       '--trace', '1'])
    spans = recorded_spans()
    text = ''.join(err.parts)
    halves = re.search(r'xrt_emitted of the two halves: ([\d.]+), ([\d.]+)',
                       text)
    lines = ''.join(out.parts).strip().splitlines()
    line = json.loads(lines[-1]) if rc == 0 and lines else None
    report = {
        'workload': args.workload, 'seed': args.seed, 'rc': rc,
        'device': torch.cuda.get_device_name(0),
        'correct': line and line['correct'],
        'metrics': line and {k: v['value']
                             for k, v in line['metrics'].items()},
        'busy_s': line and line['device'].get('busy_s'),
        'window_s': line and line['device'].get('window_s'),
        'idle_gaps': line and line.get('breakdown', {}).get('idle_gaps'),
        'xrt_halves': ([float(halves.group(1)), float(halves.group(2))]
                       if halves else None),
        'spans': span_summary(spans),
        'clock': clock_check(torch, span, record_spans, recorded_spans),
        'span_cost': span_cost(span, record_spans),
        'threads_alive': threading.active_count(),
    }
    text = json.dumps(report)
    print('spans-diag ' + text, flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, 'a') as fd:
        fd.write(text + '\n')
    return rc


if __name__ == '__main__':
    sys.exit(main())
