"""The plain reference of the benchmark: a session's utterances enhanced
by the GSS chain in plain PyTorch, from the corpus files alone.

It imports neither JAX nor the JAX package nor the program under test and
takes nothing the program made: a deployment's ``load_session``
(``gss_bench/deployments/<name>.py``) reads the transcription and the
array WAVs into each utterance's spans, channels, context and trim
(``session.py``'s :class:`Utterance`); the reference reads the
observation and the activity from them and runs the chain (``chain.py``)
in float64, or as the TF32 control.
"""

import numpy as np
import torch

from gss_bench.reference import chain, wav
from gss_bench.reference.chain import Precision
from gss_bench.reference.session import frame_activity

__all__ = ['Precision', 'chain_params', 'observation',
           'enhance_utterance']


def chain_params(config):
    """The chain's parameters: the configuration's enhancer settings and
    the algorithm constants it states under ``reference``."""
    e, r = config['enhancer'], config['reference']
    unsupported = {
        'wpe': e['wpe'] is not True, 'bf': e['bf'] != 'mvdrSouden_ban',
        'postfilter': e.get('postfilter') is not None,
        'wpe_psd_context': e.get('wpe_psd_context', 0) != 0,
        'stft_fading': e.get('stft_fading', True) is not True,
        'bf_drop_context': e.get('bf_drop_context', True) is not True}
    if any(unsupported.values()):
        raise NotImplementedError(
            f'the reference does not run {sorted(k for k, v in unsupported.items() if v)}')
    return dict(stft_size=e['stft_size'], stft_shift=e['stft_shift'],
                wpe_taps=e['wpe_tabs'], wpe_delay=e['wpe_delay'],
                wpe_iterations=e['wpe_iterations'], wpe_load=r['wpe_load'],
                bss_iterations=e['bss_iterations'],
                bss_iterations_post=e['bss_iterations_post'],
                em_init_floor=r['em_init_floor'],
                em_diagonal_floor=r['em_diagonal_floor'],
                mvdr_load=r['mvdr_load'], mvdr_eps=r['mvdr_eps'])


def observation(utt):
    """The (D, N) int16 observation: each stacked array's channels over its
    span, cut to the shortest array."""
    rows = [wav.read_pcm16(path, start, start + utt.num_samples)
            for array, start, _stop in utt.spans
            for path in utt.paths[array]]
    return np.stack([r[:utt.num_samples] for r in rows])


def enhance_utterance(utt, intervals, config, precision, device):
    """The emitted waveform (float64 NumPy) of one utterance: the chain's
    output over the observation, cut to the utterance's span."""
    x = torch.from_numpy(observation(utt)).to(device)
    x = x.to(precision.real) * 2.0 ** -15
    y = chain.enhance(x, frame_activity(utt, intervals, config), utt.target,
                      utt.context_frames, chain_params(config), precision)
    start, samples = utt.trim
    y = torch.nn.functional.pad(y, (0, samples))[start:start + samples]
    return y.to(torch.float64).cpu().numpy()

