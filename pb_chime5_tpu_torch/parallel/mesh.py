"""Device-grid sharding of the enhancement chain — port of
``pb_chime5_tpu/parallel/mesh.py``.

Two parallel axes, as in the JAX package:

* ``data`` — utterances are independent (the reference's only
  parallelism, via MPI processes).  Each data group of a batch runs on its
  own device; no communication.
* ``freq`` — inside one utterance, WPE, the cacGMM EM and the PSDs are
  independent per frequency.  Each frequency shard takes its block of the
  zero-padded frequency axis; the only cross-shard traffic is the MVDR
  reference channel's (B, D) statistics, summed over the shards in shard
  order on the group's first device and handed back (JAX's ``psum``), and
  the beamformed blocks, concatenated there for the iSTFT (JAX's
  ``all_gather``).

A :class:`Mesh` is a (data, freq) grid of ``torch.device``; one process
drives every device of it, enqueueing each group's work in turn (the card
runs it asynchronously).  Several slots may name the same card, or the
CPU.  Per-utterance quantities (target index, valid samples, context
frames) are (B,) host values, so one call serves a whole length bucket,
and each group runs the batched chain of ``models/gss.py``: every kernel
launch takes all of the group's utterances.
"""

import dataclasses

import numpy as np
import torch

from pb_chime5_tpu_torch._device import assert_precision
from pb_chime5_tpu_torch.models.gss import (
    GssConfig, _bf_back, _bf_front, _em_stage, _slice_cached_obs,
    _stft_and_mask, _wpe_stage, enhance_spectrogram)
from pb_chime5_tpu_torch.ops.stft import istft

__all__ = ['Mesh', 'make_mesh', 'batched_gss_enhance', 'sharded_gss_enhance',
           'sharded_gss_enhance_cached', 'sharded_gss_fn',
           'sharded_gss_cached_fn']


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (data, freq) grid of devices: ``devices[i][j]`` is data group i's
    frequency shard j; ``shape == {'data': ..., 'freq': ...}``."""
    devices: tuple

    @property
    def shape(self):
        return {'data': len(self.devices), 'freq': len(self.devices[0])}


def make_mesh(data: int = None, freq: int = 1, devices=None) -> Mesh:
    """Mesh with ('data', 'freq') axes over ``devices`` (default: every
    CUDA device; raises when there is none).  The CPU runs only from an
    explicit list, e.g. ``devices=[torch.device('cpu')] * 8``."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device; pass devices= '
                               'to build a mesh of CPU slots')
        devices = [torch.device('cuda', i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if data is None:
        if n % freq:
            raise ValueError(f'{n} devices do not split into freq={freq}')
        data = n // freq
    if data < 1 or freq < 1 or data * freq > n:
        raise ValueError(f'data={data} x freq={freq} needs more than the '
                         f'{n} devices given')
    return Mesh(tuple(tuple(devices[i * freq:(i + 1) * freq])
                      for i in range(data)))


def _ints(x, B, default=0):
    """(B,) host ints of a per-row argument (None: ``default``)."""
    if x is None:
        return [default] * B
    if isinstance(x, torch.Tensor):
        x = x.cpu()
    return [int(v) for v in np.asarray(x).reshape(-1)]


def _to(x, device):
    """A host array or tensor on ``device``; from pinned memory and
    without waiting for a card."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.device == device:
        return x
    if x.device.type == 'cpu' and device.type == 'cuda':
        x = x.pin_memory()
    return x.to(device, non_blocking=True)


def _group(obs, act, targets, valid, scf, ecf, config, num_output_samples,
           shards):
    """One data group's rows on ``shards[0]`` (its frequency shards on
    ``shards``): obs (B, D, N), act (B, K, T) -> (B, num_output_samples)
    on ``shards[0]``."""
    Obs, frame_mask, _ = _stft_and_mask(obs, valid, config)   # (B, F, D, T)
    F = Obs.shape[1]
    if len(shards) == 1:
        X_hat, _ = enhance_spectrogram(
            Obs, act, targets, config=config, start_context_frames=scf,
            end_context_frames=ecf, frame_mask=frame_mask)
    else:
        nf = len(shards)
        block = -(-F // nf)
        Obs = torch.nn.functional.pad(Obs, (0, 0, 0, 0, 0, block * nf - F))
        fronts = []
        for j, device in enumerate(shards):
            O = Obs[:, j * block:(j + 1) * block].to(device)
            a, m = act.to(device), (None if frame_mask is None
                                    else frame_mask.to(device))
            O = _wpe_stage(O, config, m)
            masks = _em_stage(O, a, config, m)
            fronts.append(_bf_front(O, masks, targets, config, scf, ecf, m))
        stats = fronts[0][1]
        if stats is not None:        # the psum, in shard order
            for _, more in fronts[1:]:
                stats = tuple(x + y.to(x.device)
                              for x, y in zip(stats, more))
        X_hat = torch.cat([
            _bf_back(state, None if stats is None else tuple(
                x.to(device) for x in stats), config)[0].to(shards[0])
            for (state, _), device in zip(fronts, shards)], dim=1)[:, :F]
    # row by row, as the unbatched chain calls it: the batched transform
    # rounds otherwise
    return torch.stack([istft(X.T, config.stft_size, config.stft_shift,
                              fading=config.stft_fading,
                              num_samples=num_output_samples)
                        for X in X_hat])


def _run(mesh, rows_of, act, targets, valid, scf, ecf, config,
         num_output_samples):
    """Split the B rows over the data groups (contiguous, as even as the
    rows allow; a group gets none only when B < data), run each group on
    its devices, and gather the rows on the mesh's first device."""
    B = len(targets)
    groups = [g for g in np.array_split(np.arange(B),
                                        min(B, mesh.shape['data'])) if len(g)]
    outs = []
    for g, shards in zip(groups, mesh.devices):
        device = shards[0]
        if device.type == 'cuda':
            assert_precision()
        sl = slice(int(g[0]), int(g[-1]) + 1)
        outs.append(_group(
            rows_of(sl, device), _to(act[sl], device), targets[sl],
            valid[sl], scf[sl], ecf[sl], config, num_output_samples,
            shards))
    first = mesh.devices[0][0]
    return torch.cat([o.to(first) for o in outs]) if len(outs) > 1 \
        else outs[0]


def batched_gss_enhance(obs, activity_freq, target_index, num_valid_samples,
                        *, config: GssConfig, num_output_samples: int,
                        start_context_frames=None, end_context_frames=None):
    """A same-shape utterance batch on the device of ``obs`` (the JAX
    ``vmap``): obs (B, D, N), activity_freq (B, K, T), target_index (B,),
    num_valid_samples (B,), optional context frames (B,) -> (B,
    num_output_samples)."""
    obs = torch.as_tensor(obs)
    mesh = Mesh(((obs.device,),))
    return sharded_gss_enhance(
        mesh, obs, activity_freq, target_index, num_valid_samples,
        config=config, num_output_samples=num_output_samples,
        start_context_frames=start_context_frames,
        end_context_frames=end_context_frames)


def sharded_gss_enhance(mesh: Mesh, obs, activity_freq, target_index,
                        num_valid_samples, *, config: GssConfig,
                        num_output_samples: int, start_context_frames=None,
                        end_context_frames=None):
    """Data x frequency sharded batch enhancement over ``mesh``: obs
    (B, D, N) host array or tensor, activity_freq (B, K, T), target_index
    and num_valid_samples (B,), optional context frames (B,) -> (B,
    num_output_samples) on the mesh's first device.  The data groups'
    rows run on their own devices (``B`` needs no particular multiple of
    the data axis)."""
    targets = _ints(target_index, None)
    B = len(targets)
    return _run(mesh, lambda sl, device: _to(obs[sl], device),
                activity_freq, targets, _ints(num_valid_samples, B),
                _ints(start_context_frames, B), _ints(end_context_frames, B),
                config, num_output_samples)


def sharded_gss_enhance_cached(
        mesh: Mesh, cache, offsets, activity_freq, target_index,
        num_valid_samples, *, config: GssConfig, num_arrays: int,
        slice_samples: int, num_output_samples: int,
        start_context_frames=None, end_context_frames=None):
    """:func:`sharded_gss_enhance` fed from the device-resident
    session-audio window (``models/audio_cache.py``): each row is sliced
    out of the (A*C, W) window at its (A,) per-array offsets, samples past
    its valid length zeroed, so rows equal the direct path's zero-padded
    uploads bit for bit.  offsets (B, A) -> (B, num_output_samples)."""
    B = len(offsets)
    valid = _ints(num_valid_samples, B)
    offsets = np.asarray(offsets, np.int64).reshape(B, num_arrays)
    replicas = {}

    def rows_of(sl, device):
        # the window is copied to a device it does not live on (JAX's
        # replication of the window over the mesh)
        if device not in replicas:
            replicas[device] = (cache if cache.device == device
                                else cache.to(device))
        window = replicas[device]
        return torch.stack([
            _slice_cached_obs(window, offsets[b], num_arrays, slice_samples,
                              valid[b])
            for b in range(sl.start, sl.stop)])
    return _run(mesh, rows_of, activity_freq, _ints(target_index, B), valid,
                _ints(start_context_frames, B), _ints(end_context_frames, B),
                config, num_output_samples)


# The JAX factories compile one program per (mesh, config, output length);
# an eager chain has nothing to trace or cache, so they only bind those.

def sharded_gss_fn(mesh: Mesh, config: GssConfig, num_output_samples: int):
    """``fn(obs, act, target, valid, start_cf, end_cf)`` of
    :func:`sharded_gss_enhance`."""
    return lambda obs, act, target, valid, scf=None, ecf=None: \
        sharded_gss_enhance(mesh, obs, act, target, valid, config=config,
                            num_output_samples=num_output_samples,
                            start_context_frames=scf, end_context_frames=ecf)


def sharded_gss_cached_fn(mesh: Mesh, config: GssConfig, num_arrays: int,
                          slice_samples: int, num_output_samples: int):
    """``fn(cache, offsets, act, target, valid, start_cf, end_cf)`` of
    :func:`sharded_gss_enhance_cached`."""
    return lambda cache, offsets, act, target, valid, scf=None, ecf=None: \
        sharded_gss_enhance_cached(
            mesh, cache, offsets, act, target, valid, config=config,
            num_arrays=num_arrays, slice_samples=slice_samples,
            num_output_samples=num_output_samples,
            start_context_frames=scf, end_context_frames=ecf)
