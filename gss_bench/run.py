"""Run one cell of the benchmark of ``pb_chime5_tpu_torch``.

    python -m gss_bench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the repository root, on a machine with the card(s) the cell asks
for.  Everything is found by name: the cell in ``BENCHMARK.json``'s
``workloads``, its configuration in ``gss_bench/configs/<config>.json``,
its traffic in ``gss_bench/traffic/<traffic>.json`` and each metric in
``gss_bench/metrics/<metric>.py`` (a ``read(record)`` that returns the
value, or None where the run gives it nothing to read).

Set-up (timed as ``setup_s``): the corpus from the seed in ``$TMPDIR``,
the database, ``get_enhancer`` and ``Enhancer.warmup``, which builds and
loads the program's libraries.  Then the window (``gss_bench/drive.py``),
then the check of what it wrote against the float64 reference
(``gss_bench/check.py``), once the program's state is freed.  With
``--trace 0`` the line reports the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (CUDA events per chain stage, the
session-audio cache's counters and the profiler over the window's last
seconds).  The last line of standard output is the result; the numbers
compared, beside their limits, are the last lines of standard error and
the last key of the result.  A run fails, and prints no result, without
the card(s), or when JAX or the JAX package is loaded.

A cell on N > 1 cards makes the corpus, the database and the libraries
here, runs the window in one rank process a card (``gss_bench/ranks.py``),
merges the ranks' records into one, and checks the WAVs of every rank
here once the ranks have exited; it also compares the split
(``ranks.split_rows``).  A rank that fails fails the run.
"""

import time

_STARTED = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
# whole top-level module names that no run may load
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pb_chime5_tpu')
TRACE_SECONDS = 3.0          # the profiled slice at the window's end

__all__ = ['main', 'load_cell', 'load_metric', 'cell_metrics',
           'forbidden_modules', 'result_line']


def _load_json(path):
    return json.loads(Path(path).read_text())


def load_cell(bench, name):
    """(cell, configuration, traffic) of the workload ``name``."""
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'no workload {name!r} in BENCHMARK.json: '
                         f'{sorted(cells)}')
    cell = cells[name]
    config = _load_json(HERE / 'configs' / f"{cell['config']}.json")
    return cell, config, load_traffic(cell['traffic'])


def load_traffic(name):
    """The mix ``gss_bench/traffic/<name>.json``; one with a ``base`` is
    that mix with its own keys put over it, so a mix that another deploys
    differently (``processes``) holds no copy of its parameters."""
    traffic = _load_json(HERE / 'traffic' / f'{name}.json')
    if 'base' in traffic:
        own = {k: v for k, v in traffic.items() if k != 'base'}
        traffic = {**load_traffic(traffic['base']), **own}
    return traffic


def load_metric(name):
    """The reader ``gss_bench/metrics/<name>.py``'s ``read``."""
    path = HERE / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'gss_bench_metric_{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench, cell_name, trace):
    """The metric entries the cell reports: the end-to-end ones with
    ``--trace 0``, the per-layer ones with ``--trace 1``."""
    group = bench['per_layer'] if trace else bench['end_to_end']
    return [m for m in group
            if 'workloads' not in m or cell_name in m['workloads']]


def forbidden_modules(modules=None):
    """Loaded modules whose whole top-level name is forbidden."""
    names = {n.split('.')[0] for n in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def result_line(correct, attempted, failed, metrics, device, breakdown,
                checks):
    """The result's JSON line; the compared numbers come last."""
    line = {'correct': correct, 'attempted': attempted, 'failed': failed,
            'metrics': metrics, 'device': device}
    if breakdown is not None:
        line['breakdown'] = breakdown
    line['checks'] = {name: {'value': value, 'limit': limit}
                      for name, value, limit in checks}
    return json.dumps(line)


def _power_limit_w():
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits', '-i', '0'],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _enhancer_kwargs(config):
    import numpy as np
    kwargs = dict(config['enhancer'])
    kwargs['compute_dtype'] = np.dtype(kwargs.get('compute_dtype',
                                                  'float32')).type
    if 'length_buckets' in kwargs and kwargs['length_buckets'] is not None:
        kwargs['length_buckets'] = tuple(kwargs['length_buckets'])
    return kwargs


def _least_work(utterances, intervals, config, ids):
    """Summed least seconds of the WPE and EM stages over ``ids`` (one per
    ``gss_enhance`` call)."""
    from gss_bench import roofline
    from gss_bench.reference.session import frame_activity, stft_frames
    e = config['enhancer']
    F = e['stft_size'] // 2 + 1
    per_id = {}
    for eid in set(ids):
        utt = utterances[eid]
        T = stft_frames(utt.num_samples, e['stft_size'], e['stft_shift'])
        gate = frame_activity(utt, intervals, config)[:, :T]
        D = sum(len(utt.paths[a]) for a, _, _ in utt.spans)
        K = gate.shape[0]
        wpe = roofline.wpe_work(F, D, T, e['wpe_tabs'], e['wpe_iterations'])
        em = roofline.em_work(F, D, T, K, int(gate.sum()),
                              e['bss_iterations'], e['bss_iterations_post'])
        per_id[eid] = (roofline.least_seconds(*wpe),
                       roofline.least_seconds(*em))
    return {'wpe': sum(per_id[i][0] for i in ids),
            'em': sum(per_id[i][1] for i in ids)}


def _trace_summary(profiler, torch, top=10):
    from gss_bench import trace
    device_type = torch.autograd.DeviceType.CUDA
    device_events, host_ops = [], []
    for e in profiler.events():
        span = (e.time_range.start, e.time_range.end)
        if e.device_type == device_type:
            device_events.append((e.name, *span))
        elif e.cpu_parent is None:
            host_ops.append((e.name, *span))
    if not host_ops:
        return None
    span = (min(s for _, s, _ in host_ops), max(e for _, _, e in host_ops))
    return trace.summarize(device_events, host_ops, span, top)


def _session(args, config, traffic, device, workdir):
    """The corpus from the seed and its database in ``workdir``; the
    reference's reading of it -> (utterances, intervals)."""
    from gss_bench import corpus, reference
    from pb_chime5_tpu_torch.database.create_json import create_database
    from pb_chime5_tpu_torch.io import dump_json
    corpus_root = workdir / 'CHiME5'
    corpus.make_session(corpus_root, config, traffic, args.seed, device)
    dump_json(create_database(corpus_root), workdir / 'chime5.json')
    return reference.load_session(corpus_root, config)


def ready_enhancer(workdir, config, device, utterances):
    """``get_enhancer`` on the database in ``workdir``, warmed up."""
    from pb_chime5_tpu_torch.models.enhancer import get_enhancer
    enhancer = get_enhancer(database_path=str(workdir / 'chime5.json'),
                            device=device, **_enhancer_kwargs(config))
    # at exact lengths each distinct length is a shape of its own: warm
    # the longest (the peak); with buckets, the session's own buckets
    lengths = (None if config['enhancer']['length_buckets']
               else [max(u.num_samples for u in utterances.values())])
    enhancer.warmup(config['session']['session_id'], lengths=lengths)
    return enhancer


def timed_window(args, traffic, config, utterances, intervals, enhancer,
                 torch, cuda, drive_window, trace_top=10):
    """The measured window, ``drive_window(window)``, with the profiler,
    the stage times, the cache's counters and the allocator's peak around
    it -> (record, window, builds in the window); the trace keeps its
    ``trace_top`` device ops and idle gaps (None: all)."""
    from gss_bench import drive
    from pb_chime5_tpu_torch.models import gss
    from pb_chime5_tpu_torch.ops.kernels import _build

    profiler = None
    if args.trace:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities):
            pass                              # the profiler's first start
        profiler = torch.profiler.profile(activities=activities)
    cache = getattr(enhancer, '_audio_cache', None)
    cache_before = dict(cache.stats) if cache is not None else None
    builds_before = dict(_build.stats)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    window = drive.Window(args.seconds, profiler, TRACE_SECONDS)
    with contextlib.ExitStack() as stack:
        stages = (stack.enter_context(gss.record_stage_times())
                  if args.trace else None)
        drive_window(window)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    ids_all = [e for _, e in window.written]
    # the chains read for the stage metrics: those written before the
    # profiled slice (the writer takes the chains in dispatch order, so
    # the k-th WAV written is the k-th chain timed)
    traced_from = (window.trace_host_span[0] if window.trace_host_span
                   else window.end)
    untraced = [(t, e) for t, e in window.written if t < traced_from]
    record = {
        'window_s': args.seconds, 'setup_s': window.start - _STARTED,
        'block_s': window.end - window.start,
        'written': [(t - window.start, e)
                    for t, e in window.written_in_window()],
        'written_all': len(ids_all),
        'emitted_s': {e: u.emitted_seconds for e, u in utterances.items()},
        'jobs_ms': ([(end - start) * 1e3 for start, end
                     in window.jobs_in_window() if end < traced_from]
                    if traffic['drive'] == 'kaldi_jobs' else None),
        'peak_bytes': peak,
        'stages': stages[:len(untraced)] if stages else None,
        'stages_wall_s': (untraced[-1][0] - window.start if untraced
                          else None),
        'cache': ({k: v - cache_before.get(k, 0)
                   for k, v in cache.stats.items()} if cache is not None
                  else None),
        'least': (_least_work(utterances, intervals, config,
                              [e for _, e in untraced])
                  if args.trace else None),
        'trace': (_trace_summary(profiler, torch, trace_top)
                  if profiler is not None and window.trace_host_span
                  else None),
        'traced_from_s': traced_from - window.start,
    }
    builds = {k: v - builds_before.get(k, 0) for k, v in _build.stats.items()}
    return record, window, builds


def _metrics(bench, workload, trace, record):
    metrics = {}
    for entry in cell_metrics(bench, workload, trace):
        value = load_metric(entry['name'])(record)
        if value is not None:
            metrics[entry['name']] = {'value': value, 'unit': entry['unit']}
    return metrics


def _print_rates(args, record):
    # the window's two halves apart: how steady the rate is inside a run
    half = args.seconds / 2
    halves = [sum(record['emitted_s'][e] for t, e in record['written']
                  if (t < half) == first) / half for first in (True, False)]
    print(f'xrt_emitted of the two halves: {halves[0]:.4f}, '
          f'{halves[1]:.4f}', file=sys.stderr)
    jobs = record['jobs_ms']
    if jobs:
        import statistics
        print(f'jobs ended in the window: {len(jobs)}, median '
              f'{statistics.median(jobs):.3f} ms, p95 '
              f'{load_metric("job_latency_p95_ms")(record):.3f} ms',
              file=sys.stderr)


def _judge(args, config, record, utterances, intervals, audio_dir, device,
           control, extra=()):
    """The check of the WAVs the window wrote (``gss_bench/check.py``) ->
    (correct, [(name, value, limit)]); ``extra`` more rows compared."""
    from gss_bench import check
    session = config['session']
    correct_spec = config['correct']
    emitted = record['emitted_s']
    written_ids = [e for _, e in record['written']]
    sample = check.draw_sample(written_ids, emitted, args.seed,
                               correct_spec['sample'],
                               correct_spec['min_seconds'])
    out_dir = audio_dir / session['dataset']
    errs, sensitivity, controls = check.errors(
        out_dir, utterances, intervals, config, sample, device,
        control=control)
    stable_below = correct_spec['stable_below']
    values = check.numbers(errs, sensitivity, stable_below)
    values['wrong_length'] = (check.wrong_length(out_dir, utterances,
                                                 written_ids)
                              + (0 if sample else 1))
    if control:
        print('calibration ' + json.dumps({
            'workload': args.workload, 'seed': args.seed,
            'program': values,
            'control': check.numbers(controls, sensitivity, stable_below),
            'program_errors': errs, 'control_errors': controls,
            'sensitivity': sensitivity}),
            file=sys.stderr)
    limits = dict(correct_spec['limits'])
    for name, value, limit in extra:
        values[name], limits[name] = value, limit
    correct, rows = check.verdict(values, limits)
    for what, values_of in (('errors', errs),
                            ('float32 reference errors', sensitivity)):
        print(f'{what} of the {len(sample)} utterances checked: '
              + ', '.join(f'{e}={v if v is None else round(v, 6)}'
                          for e, v in values_of.items()), file=sys.stderr)
    return correct, rows


def _device_info(torch, cuda, count, peak, power, trace):
    info = {'platform': 'gpu' if cuda else 'cpu',
            'kind': torch.cuda.get_device_name(0) if cuda else 'cpu',
            'count': count if cuda else 1,
            'memory_peak_bytes': peak, 'power_limit_w': power}
    breakdown = None
    if trace is not None:
        # a merged trace holds the sums over the cards: their mean
        traced = trace.get('cards', 1)
        info['busy_s'] = trace['busy_s'] / traced
        info['window_s'] = trace['window_s'] / traced
        breakdown = {k: trace[k] for k in ('device_ops', 'idle_gaps')}
    return info, breakdown


def _measure(args, bench, cell, config, traffic, device, workdir, torch,
             control=False):
    """Set-up, window and check -> (result line, check rows); with
    ``control`` (``gss_bench/calibrate.py``) the control is read beside
    the program on the check's sample."""
    from gss_bench import drive

    cuda = device == 'cuda'
    sid = config['session']['session_id']
    utterances, intervals = _session(args, config, traffic, device, workdir)
    enhancer = ready_enhancer(workdir, config, device, utterances)
    power = _power_limit_w() if cuda else None
    audio_dir = workdir / 'enhanced'
    record, window, builds = timed_window(
        args, traffic, config, utterances, intervals, enhancer, torch, cuda,
        lambda w: drive.run(enhancer, sid, audio_dir, traffic, w,
                            len(utterances)))
    metrics = _metrics(bench, args.workload, args.trace, record)
    device_info, breakdown = _device_info(torch, cuda, cell['chips'],
                                          record['peak_bytes'], power,
                                          record['trace'])
    print(f'cell {args.workload} seed {args.seed}: setup '
          f'{record["setup_s"]:.3f} s, window {args.seconds} s (block '
          f'{record["block_s"]:.3f} s), {len(record["written"])} WAVs in '
          f'the window of {window.dispatched} dispatched, builds in the '
          f'window {builds}, power limit {power} W', file=sys.stderr)
    _print_rates(args, record)

    del enhancer
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    correct, rows = _judge(args, config, record, utterances, intervals,
                           audio_dir, device, control)
    line = result_line(correct, window.dispatched,
                       window.dispatched - record['written_all'], metrics,
                       device_info, breakdown, rows)
    return line, rows


def _measure_ranks(args, bench, cell, config, traffic, device, workdir,
                   torch, control=False):
    """A cell on ``chips`` cards: set-up here, one rank process a card
    (``gss_bench/ranks.py``) for the window, then the merged record's
    metrics and the check of the WAVs of every rank -> (result line,
    check rows), or None where a rank failed."""
    from gss_bench import ranks
    from pb_chime5_tpu_torch.ops.kernels import _build

    cuda = device == 'cuda'
    marks = [('imports', time.perf_counter())]
    utterances, intervals = _session(args, config, traffic, device, workdir)
    marks.append(('corpus and database', time.perf_counter()))
    # build the libraries once, here, not in every rank at once
    _build.load_libraries(_build.HOST_LIBRARIES
                          + (_build.LIBRARIES if cuda else ()))
    if cuda:
        torch.cuda.empty_cache()
    power = _power_limit_w() if cuda else None
    marks.append(('libraries', time.perf_counter()))
    records = ranks.launch(args, cell['chips'], workdir, device,
                           args.seconds + ranks.SETUP_LIMIT_S)
    if records is None:
        return None
    record = ranks.merge(records)
    record['setup_s'] = record['window_start'] - _STARTED
    marks.append(('ranks to the window', record['window_start']))
    print('set-up: ' + ', '.join(
        f'{name} {end - start:.3f} s' for (name, end), start
        in zip(marks, [_STARTED] + [t for _, t in marks])), file=sys.stderr)
    record['emitted_s'] = {e: u.emitted_seconds
                           for e, u in utterances.items()}
    metrics = _metrics(bench, args.workload, args.trace, record)
    device_info, breakdown = _device_info(torch, cuda, cell['chips'],
                                          record['peak_bytes'], power,
                                          record['trace'])
    dispatched = sum(r['dispatched'] for r in records)
    for r in records:
        print(ranks.describe(r, record['emitted_s'], args.seconds),
              file=sys.stderr)
    print(f'cell {args.workload} seed {args.seed}: {len(records)} ranks, '
          f'setup {record["setup_s"]:.3f} s, window {args.seconds} s '
          f'(block {record["block_s"]:.3f} s), {len(record["written"])} '
          f'WAVs in the window of {dispatched} dispatched, power limit '
          f'{power} W', file=sys.stderr)
    _print_rates(args, record)
    correct, rows = _judge(args, config, record, utterances, intervals,
                           workdir / 'enhanced', device, control,
                           ranks.split_rows(records, utterances))
    line = result_line(correct, dispatched,
                       dispatched - record['written_all'], metrics,
                       device_info, breakdown, rows)
    return line, rows


def main(argv=None, *, device='cuda', control=False):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    bench = _load_json(HERE.parent / 'BENCHMARK.json')
    cell, config, traffic = load_cell(bench, args.workload)

    import torch
    if device == 'cuda' and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell['chips']):
        print(f"cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if traffic.get('processes', 1) != cell['chips']:
        print(f"cell {args.workload}: its traffic runs "
              f"{traffic.get('processes', 1)} process(es), one a card, and "
              f"the cell has {cell['chips']} card(s)", file=sys.stderr)
        return 2
    measure = _measure_ranks if cell['chips'] > 1 else _measure
    workdir = Path(tempfile.mkdtemp(prefix='gss_bench_'))
    try:
        measured = measure(args, bench, cell, config, traffic, device,
                           workdir, torch, control)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if measured is None:
        return 4
    line, rows = measured
    found = forbidden_modules()
    if found:
        print(f'forbidden modules loaded: {found}', file=sys.stderr)
        return 3
    for name, value, limit in rows:
        print(f'check {name} {value} limit {limit}', file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
