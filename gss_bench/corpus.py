"""The traffic generator's shared part: one synthetic session's turns and
array signals, made from a seed.  A deployment
(``gss_bench/deployments/<name>.py``) lays them out as its corpus: file
names, clocks and the transcription's times.

A rewrite of ``pb_chime5_tpu_torch/testing/synthetic.py`` for production
density.  The configuration fixes the deployment (session, speakers,
arrays, microphones, the session's length); the traffic fixes how dense
and how long the utterances are:

* ``rate_per_s`` utterances a second over the session, so
  ``round(rate_per_s * session_duration_s)`` utterances;
* their lengths are the distribution's quantiles at ``(i + 0.5) / n``,
  log-normal with the given mean and log-space sigma, clipped: every seed
  has the same multiset of lengths, so the same length buckets and the same
  cost; the seed deals them to the speakers and places them;
* each speaker's turns are placed independently (uniform spacings of the
  time the speaker is silent), so turns of different speakers overlap as
  in conversation and a speaker never overlaps itself.

Audio: each speaker is noise bursts with its own spectral tilt under a
400-sample amplitude envelope, gated by its turns; every array
microphone records all speakers through room responses of its own (a
direct path a few samples late, then an exponentially decaying noise
tail of the array's reverberation time, 0.3-0.6 s, as loud as the direct
path), plus sensor noise 20 dB below the mixture, at -25 dBFS RMS as
PCM16; each array's recording starts ``offset`` samples before the
session's clock, as its deployment's clock says.  The signals are made
with ``torch.Generator`` on the device the run uses, in a few large
calls.
"""

import decimal
import math
import statistics
import struct

import numpy as np
import torch

__all__ = ['SAMPLE_RATE', 'utterance_lengths', 'place_turns',
           'samples_to_time_str', 'write_pcm16', 'session_turns',
           'array_pcm16', 'session_num_samples']

SAMPLE_RATE = 16000
ENVELOPE = 400           # samples a step of a source's amplitude envelope
TILT_TAPS = 4
RIR_SECONDS = 0.5        # length of a room response
RT60 = (0.3, 0.6)        # s, the range of the arrays' reverberation times
DIRECT_DELAY = 8         # samples, the largest direct-path delay
SNR_DB = 20.0            # the mixture over the sensor noise
LEVEL_DBFS = -25.0       # RMS of a recording


def session_num_samples(config):
    return int(round(config['session_duration_s'] * SAMPLE_RATE))


def utterance_lengths(traffic, duration_s):
    """Lengths in samples, ascending: the ``n`` quantiles of the traffic's
    length distribution."""
    n = int(round(traffic['rate_per_s'] * duration_s))
    spec = traffic['length']
    if spec['distribution'] != 'lognormal':
        raise ValueError(f"unknown length distribution "
                         f"{spec['distribution']!r}")
    sigma = spec['sigma']
    mu = math.log(spec['mean_s']) - sigma ** 2 / 2
    normal = statistics.NormalDist()
    seconds = [min(max(math.exp(mu + sigma * normal.inv_cdf((i + 0.5) / n)),
                       spec['min_s']), spec['max_s']) for i in range(n)]
    return np.array([int(round(s * SAMPLE_RATE)) for s in seconds], np.int64)


def place_turns(rng, lengths, num_speakers, num_samples, edge):
    """Deal ``lengths`` to the speakers in a seeded order and place each
    speaker's turns in ``[edge, num_samples - edge)`` without overlapping
    one another -> [(speaker index, start, end)] sorted by start."""
    order = rng.permutation(len(lengths))
    turns = []
    span = num_samples - 2 * edge
    for k in range(num_speakers):
        own = lengths[order[k::num_speakers]]
        free = span - int(own.sum())
        if free < 0:
            raise ValueError(f'speaker {k}: {own.sum()} samples of speech '
                             f'do not fit into {span}')
        gaps = np.floor(rng.dirichlet(np.ones(len(own) + 1)) * free)
        pos = edge
        for gap, n in zip(gaps[:-1].astype(np.int64), own):
            pos += int(gap)
            turns.append((k, pos, pos + int(n)))
            pos += int(n)
    return sorted(turns, key=lambda t: (t[1], t[0]))


def samples_to_time_str(samples):
    """Samples at 16 kHz -> exact 'H:MM:SS.fffffff'."""
    hours, rem = divmod(int(samples), 3600 * SAMPLE_RATE)
    minutes, rem = divmod(rem, 60 * SAMPLE_RATE)
    sec = f'{decimal.Decimal(rem) / SAMPLE_RATE:.7f}'.rstrip('0').rstrip('.')
    whole, _, frac = sec.partition('.')
    return f'{hours}:{minutes:02d}:{int(whole):02d}.{frac or "0"}'


def write_pcm16(path, samples):
    """A mono 16 kHz PCM16 WAV file of the int16 array ``samples``."""
    data = np.ascontiguousarray(samples, '<i2')
    header = (b'RIFF' + struct.pack('<I', 36 + data.nbytes) + b'WAVE'
              + b'fmt ' + struct.pack('<IHHIIHH', 16, 1, 1, SAMPLE_RATE,
                                      2 * SAMPLE_RATE, 2, 16)
              + b'data' + struct.pack('<I', data.nbytes))
    with open(path, 'wb') as f:
        f.write(header)
        data.tofile(f)


def _generator(device, *key):
    seed = np.random.SeedSequence(list(key)).generate_state(2, np.uint32)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed[0]) << 31 | int(seed[1]) >> 1)
    return gen


def _sources(turns, num_speakers, num_samples, seed, device):
    """(K, N) float32 speaker signals, zero outside each speaker's turns."""
    gen = _generator(device, seed, 1)
    K, N = num_speakers, num_samples
    gate = torch.zeros((K, N), device=device)
    for k, start, end in turns:
        gate[k, start:end] = 1
    steps = N // ENVELOPE + 1
    envelope = torch.randn((K, steps), generator=gen, device=device).abs()
    burst = torch.randn((K, N), generator=gen, device=device) * gate \
        * envelope.repeat_interleave(ENVELOPE, dim=1)[:, :N]
    tilt = torch.randn((K, TILT_TAPS), generator=gen, device=device)
    src = torch.zeros_like(burst)
    for tau in range(TILT_TAPS):
        src[:, tau:] += tilt[:, tau:tau + 1] * burst[:, :N - tau]
    return src


def _room_responses(num_arrays, mics, num_speakers, seed, device):
    """(A, M, K, L) room responses: a unit direct path after a few
    samples, then noise decaying 60 dB over the array's reverberation
    time, with as much energy as the direct path."""
    gen = _generator(device, seed, 2)
    shape = (num_arrays, mics, num_speakers)
    L = int(RIR_SECONDS * SAMPLE_RATE)
    rt60 = RT60[0] + (RT60[1] - RT60[0]) * torch.rand(
        (num_arrays, 1, 1, 1), generator=gen, device=device)
    rate = math.log(1000) / (rt60 * SAMPLE_RATE)        # amplitude decay
    n = torch.arange(L, device=device)
    rirs = torch.randn((*shape, L), generator=gen, device=device) \
        * torch.exp(-rate * n) * torch.sqrt(2 * rate)
    delay = torch.randint(0, DIRECT_DELAY, shape, generator=gen,
                          device=device)
    rirs.scatter_(-1, delay[..., None], 1.0)
    return rirs


def session_turns(config, traffic, rng):
    """The traffic's utterances placed in the configuration's session ->
    [(speaker index, start, end)] sorted by start (``place_turns``)."""
    lengths = utterance_lengths(traffic, config['session_duration_s'])
    return place_turns(rng, lengths, len(config['session']['speakers']),
                       session_num_samples(config),
                       int(traffic['edge_s'] * SAMPLE_RATE))


def array_pcm16(config, turns, seed, device, offsets):
    """Yield ``(array, pcm)`` for each array of ``offsets`` ({array: offset
    in samples}) in the session's array order: the (mics, N + offset)
    int16 recording of the speakers' ``turns`` whose mixture starts
    ``offset`` samples in."""
    session = config['session']
    arrays, mics = session['arrays'], session['mics_per_array']
    K, N = len(session['speakers']), session_num_samples(config)
    src = _sources(turns, K, N, seed, device)
    rirs = _room_responses(len(arrays), mics, K, seed, device)
    nfft = 1 << (N + rirs.shape[-1] - 1).bit_length()
    spectra = torch.fft.rfft(src, nfft)
    del src
    for a, array in enumerate(arrays):
        if array not in offsets:
            continue
        mix = torch.fft.irfft((torch.fft.rfft(rirs[a], nfft)
                               * spectra).sum(dim=1), nfft)[:, :N]
        rms = torch.sqrt((mix ** 2).mean())
        offset = offsets[array]
        out = torch.randn((mics, N + offset), device=device,
                          generator=_generator(device, seed, 3, a)) \
            * (rms * 10 ** (-SNR_DB / 20))
        out[:, offset:] += mix
        scale = 10 ** (LEVEL_DBFS / 20) * 2 ** 15 / torch.sqrt(
            (out ** 2).mean())
        pcm = torch.clamp(torch.round(out * scale), -2 ** 15,
                          2 ** 15 - 1).to(torch.int16).cpu().numpy()
        del mix, out
        yield array, pcm
