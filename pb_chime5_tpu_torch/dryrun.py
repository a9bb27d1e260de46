"""The port's twin of the repo root's ``__graft_entry__.py``: a one-call
check of the enhancement chain (:func:`entry`) and a dry run of the
batched chain over a (data, freq) mesh of device slots
(:func:`dryrun_multichip`).

    python -m pb_chime5_tpu_torch.dryrun 8            # on the card
    python -m pb_chime5_tpu_torch.dryrun 8 --device cpu

On the card the mesh's slots are the machine's cards in turn (``cuda:0``
repeated where it has one); on the CPU every slot is ``'cpu'``.
"""

import numpy as np
import torch

from pb_chime5_tpu_torch._device import resolve_device

__all__ = ['entry', 'dryrun_multichip']


def _example_inputs(D=8, seconds=2.0, K=5, *, config):
    """(obs (D, N) float32, activity (K, T) int8): K - 1 staggered
    speakers and an always-on noise class, from seed 0."""
    from pb_chime5_tpu_torch.utils import activity_time_to_frequency
    N = int(seconds * 16000)
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((D, N)).astype(np.float32) * 0.1
    activity = np.zeros((K, N), bool)
    span = N // (K - 1) if K > 1 else N
    for k in range(K - 1):
        activity[k, k * span:(k + 2) * span] = True
    activity[-1] = True
    act_f = activity_time_to_frequency(
        activity, config.stft_size, config.stft_shift,
        stft_fading=config.stft_fading, stft_pad=True).astype(np.int8)
    return obs, act_f


def entry(device='cuda'):
    """(fn, example_args): the enhancement chain (STFT -> WPE -> cacGMM EM
    -> MVDR -> iSTFT, ``GssConfig(bss_iterations=5)``) and its inputs on
    ``device``; ``fn(*example_args)`` is the (N,) enhanced waveform."""
    from pb_chime5_tpu_torch.models.gss import GssConfig, gss_enhance
    device = resolve_device(device)
    config = GssConfig(bss_iterations=5)
    obs, act_f = _example_inputs(config=config)

    def fn(obs, act_f, target_index):
        x_hat, _ = gss_enhance(obs, act_f, target_index, config=config)
        return x_hat

    return fn, (torch.from_numpy(obs).to(device),
                torch.from_numpy(act_f).to(device), 0)


def _slots(n_devices, device):
    if device.type == 'cpu':
        return [device] * n_devices
    count = torch.cuda.device_count()
    return [torch.device('cuda', i % count) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device='cuda') -> None:
    """One batch of tiny utterances over a data x freq mesh of
    ``n_devices`` slots (freq 2 where ``n_devices`` is even), through the
    session loop's ``BatchDispatcher``: once with each utterance's
    observation (``add``), once sliced from one shared device window
    (``add_cached``).  Asserts that every utterance comes back, of its
    length and finite, and that the cached outputs equal the direct ones
    bit for bit."""
    from pb_chime5_tpu_torch.models.gss import GssConfig, GssPipeline
    from pb_chime5_tpu_torch.parallel import BatchDispatcher, make_mesh
    from pb_chime5_tpu_torch.utils import activity_time_to_frequency

    device = resolve_device(device)
    freq = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    data = n_devices // freq
    mesh = make_mesh(data=data, freq=freq,
                     devices=_slots(n_devices, device))

    config = GssConfig(stft_size=256, stft_shift=64, wpe=True, wpe_taps=2,
                       wpe_iterations=1, bss_iterations=2,
                       bss_iterations_post=1)
    N, B, D, K = 4000, data * 2, 4, 3
    rng = np.random.default_rng(0)
    obs = rng.standard_normal((B, D, N)).astype(np.float32)
    act_f = activity_time_to_frequency(
        np.ones((K, N), bool), config.stft_size, config.stft_shift,
        stft_fading=True, stft_pad=True).astype(np.int8)
    pipeline = GssPipeline(config, length_buckets=[N], device=device)
    dispatcher = BatchDispatcher(mesh, pipeline, utterances_per_device=2)

    def run(add):
        batches = [add(b) for b in range(B)]
        batches = [b for b in batches if b is not None] + dispatcher.flush()
        outs = dict(pair for batch in batches for pair in batch.gather())
        assert sorted(outs) == list(range(B)), sorted(outs)
        for b, x in outs.items():
            assert x.shape == (N,), (b, x.shape)
            assert np.isfinite(x).all(), f'non-finite dry-run output (utt {b})'
        return outs

    kw = dict(start_context_frames=1, end_context_frames=1)
    outs = run(lambda b: dispatcher.add(obs[b], act_f, b % K, tag=b, **kw))

    # the session-audio cache's leg: ONE window on the mesh's first slot
    # holds every row's observation at its offset
    stride = N + 1024
    window = np.zeros((D, B * stride + N), np.float32)
    for b in range(B):
        window[:, b * stride:b * stride + N] = obs[b]
    window = torch.from_numpy(window).to(mesh.devices[0][0])
    outs_c = run(lambda b: dispatcher.add_cached(
        window, np.array([b * stride], np.int32), N, act_f, b % K, tag=b,
        **kw))
    for b in range(B):
        np.testing.assert_array_equal(
            outs_c[b], outs[b],
            err_msg=f'cached mesh path differs from direct (utt {b})')


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('n_devices', type=int, nargs='?', default=8)
    parser.add_argument('--device', default='cuda')
    args = parser.parse_args()
    dryrun_multichip(args.n_devices, device=args.device)
    print(f'dry run on {args.n_devices} {args.device} slots: OK')
