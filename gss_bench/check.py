"""How ``correct`` is decided: the WAVs the window wrote against the
float64 reference (``gss_bench/reference``).

Every WAV written inside the window must exist at its utterance's length.
A sample of them, drawn from the seed among the utterances of at least
``correct.min_seconds`` with the longest of them always in it, is
enhanced again by the reference from the corpus files.  The reference's
emitted waveform is peak-normalized as the program writes its WAVs; each
utterance's error is ``||wav - ref|| / ||ref||`` over the emitted
samples.  Compared, each against the configuration's limit
(``correct.limits``), those of:

* ``wrong_length``: WAVs written in the window that are missing or not
  of the utterance's length (limit 0, exact);
* ``err_median``: the median of the sample's errors;
* ``err_geomean``: their geometric mean;
* ``err_second_stable``: the second largest over the sample's *stable*
  utterances, those that the reference itself, computed in float32,
  reproduces within ``correct.stable_below`` of its float64 output (0
  where fewer than two are).  Not the largest: on one utterance in a few
  hundred the program's rounding still departs by far more than the
  float32 reference's (a reference channel chosen on a near tie).

The chain's float32 rounding reaches the output through the EM and the
MVDR solve, which a short span of many channels leaves ill-conditioned:
there one utterance in a few reads about 1 even from a sound run, so a
configuration compares a steady number over the whole sample, and one
over the utterances that rounding alone does not move, which sees a
fault in a few of them (PERF.md gives the readings).
"""

import statistics

import numpy as np

from gss_bench import reference
from gss_bench.reference import wav

__all__ = ['draw_sample', 'errors', 'wrong_length', 'numbers', 'verdict',
           'normalized']

PCM_PEAK = (2 ** 15 - 1) / 2 ** 15


def normalized(x):
    """Peak-normalized as the program writes a WAV (PCM16 full scale)."""
    peak = np.abs(x).max() if x.size else 0.0
    return x * (PCM_PEAK / peak) if peak > 0 else x


def draw_sample(written_ids, emitted_seconds, seed, size, min_seconds=0.0):
    """The longest written utterance and ``size - 1`` others of at least
    ``min_seconds`` drawn from the seed, in sorted order."""
    ids = sorted(i for i in set(written_ids)
                 if emitted_seconds[i] >= min_seconds)
    if len(ids) <= size:
        return ids
    longest = max(ids, key=lambda i: (emitted_seconds[i], i))
    rest = [i for i in ids if i != longest]
    rng = np.random.default_rng([seed, 7])
    picked = rng.choice(len(rest), size - 1, replace=False)
    return sorted([longest] + [rest[i] for i in picked])


def _error(got, ref, samples):
    if got is None or got.shape != (samples,):
        return None
    norm = np.linalg.norm(ref)
    diff = np.linalg.norm(got - ref)
    return float(diff / norm) if norm > 0 else float(diff > 0)


def errors(audio_dir, utterances, intervals, config, ids, device,
           control=False):
    """({example_id: error} of the program's WAVs, None where a WAV is
    missing or of another length; {example_id: sensitivity}, the error of
    the reference computed in float32; with ``control``, the errors of
    the control, the reference in TF32, else None)."""
    program, sensitivity, controls = {}, {}, {}

    def ref_in(precision, utt):
        return normalized(reference.enhance_utterance(
            utt, intervals, config, reference.Precision(precision), device))

    for eid in ids:
        utt = utterances[eid]
        ref = ref_in('float64', utt)
        path = audio_dir / f'{eid}.wav'
        got = wav.read_pcm16(path) / 2 ** 15 if path.exists() else None
        program[eid] = _error(got, ref, utt.trim[1])
        sensitivity[eid] = _error(ref_in('float32', utt), ref, utt.trim[1])
        if control:
            controls[eid] = _error(ref_in('tf32', utt), ref, utt.trim[1])
    return program, sensitivity, (controls if control else None)


def wrong_length(audio_dir, utterances, ids):
    """How many of the WAVs ``ids`` are missing or of another length."""
    wrong = 0
    for eid in set(ids):
        path = audio_dir / f'{eid}.wav'
        if not path.exists() or wav.num_frames(path) != \
                utterances[eid].trim[1]:
            wrong += 1
    return wrong


def numbers(errs, sensitivity, stable_below):
    """The error statistics of :func:`errors` (None where no error was
    read): ``err_median``, ``err_geomean`` and ``err_second_stable``."""
    found = [e for e in errs.values() if e is not None]
    if not found:
        return {'err_median': None, 'err_geomean': None,
                'err_second_stable': None}
    floor = np.finfo(np.float64).tiny
    stable = sorted((e for i, e in errs.items()
                     if e is not None and sensitivity[i] <= stable_below),
                    reverse=True) + [0.0, 0.0]
    return {'err_median': statistics.median(found),
            'err_geomean': float(np.exp(np.mean(np.log(
                np.maximum(found, floor))))),
            'err_second_stable': stable[1]}


def verdict(values, limits):
    """(correct, [(name, value, limit)]): every number at or under its
    limit; a number that could not be read fails."""
    rows = [(name, values.get(name), limit) for name, limit in limits.items()]
    ok = all(v is not None and v <= limit for _, v, limit in rows)
    return ok, rows
