"""The GSS enhancement chain — port of ``pb_chime5_tpu/models/gss.py``.

    STFT -> WPE -> cacGMM EM ("GSS") -> mask context drop ->
    MVDR-Souden / GEV (+BAN) / LCMV (+BAN) / ch2 / sum
    -> optional mask postfilter -> iSTFT -> output trim

:func:`gss_enhance` runs the chain eagerly on the device of its input
(no tracing, no compile step); :class:`GssPipeline` is the host wrapper
with the JAX pipeline's bucketing, trim planning and asynchronous
dispatch / gather.  Layouts match the JAX package: (F, D, T) through WPE
and the beamformer, (F, T, D) into the EM, masks (K, T, F) out.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from pb_chime5_tpu_torch._device import assert_precision, resolve_device
from pb_chime5_tpu_torch.ops import beamform as bf
from pb_chime5_tpu_torch.ops.cacgmm import CacgmmConfig, cacgmm_posteriors
from pb_chime5_tpu_torch.ops.stft import (
    istft, stft, stft_frame_count, valid_frame_mask)
from pb_chime5_tpu_torch.ops.wpe import wpe

__all__ = ['GssConfig', 'gss_enhance', 'gss_enhance_cached', 'GssPipeline',
           'record_stage_times']

_ROADMAP = 'not ported yet (see ROADMAP.md, Queue 1)'
BEAMFORMERS = ('mvdrSouden_ban', 'mvdr_souden', 'gev_ban', 'gev', 'lcmv',
               'lcmv_ban', 'ch2', 'sum')
FLOAT64_BEAMFORMERS = ('gev_ban', 'gev', 'lcmv', 'lcmv_ban')   # _beamform

STAGES = ('stft', 'wpe', 'em', 'beamform', 'istft')
_stage_events = None     # CUDA events of gss_enhance inside record_stage_times


@contextlib.contextmanager
def record_stage_times():
    """Per-stage device times of the :func:`gss_enhance` calls on CUDA
    made inside the block: yields a list that, on exit, holds one
    ``{stage: ms}`` dict (CUDA events, in :data:`STAGES` order) per call."""
    global _stage_events
    assert _stage_events is None, 'record_stage_times does not nest'
    _stage_events = []
    times = []
    try:
        yield times
        for events in _stage_events:
            events[-1].synchronize()
            times.append({name: events[i].elapsed_time(events[i + 1])
                          for i, name in enumerate(STAGES)})
    finally:
        _stage_events = None


def _mark_stage(device, start=False):
    if _stage_events is None or device.type != 'cuda':
        return
    if start:
        _stage_events.append([])
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    _stage_events[-1].append(event)


@dataclasses.dataclass(frozen=True)
class GssConfig:
    """Pipeline configuration: the JAX ``GssConfig`` fields and defaults.

    TPU-only implementation choices keep their names and accept their
    defaults and the ported kernels: the all-Pallas configuration
    ``GssConfig(bss_em_backend='pallas', bss_inverse='pallas_gj',
    wpe_stats_backend='pallas')`` runs the statistics and Gauss-Jordan
    kernels beside the fused E+M kernel.  The chain's options are ported:
    WPE ``psd_context``, ``chunk_size`` and ``solve_refine``, the EM
    inverses 'cholesky', 'schur' and 'eigh', and every beamformer of
    :data:`BEAMFORMERS`.  Every other value, and every option that is not
    ported yet, raises ``NotImplementedError`` at construction; a value no
    configuration could take (a negative count) raises ``ValueError``.
    """
    stft_size: int = 1024
    stft_shift: int = 256
    stft_fading: bool = True

    wpe: bool = True
    wpe_taps: int = 10
    wpe_delay: int = 2
    wpe_iterations: int = 3
    wpe_psd_context: int = 0
    wpe_regularization: float = 1e-4
    wpe_chunk_size: int = None
    wpe_precision: str = 'highest'
    wpe_stats_backend: str = 'auto'
    wpe_solve_refine: int = 0

    bss_iterations: int = 20
    bss_iterations_post: int = 1
    # the fused E+M kernel ('pallas' is the JAX name of the same choice)
    bss_em_backend: str = 'auto'
    # 'gauss_jordan' / 'auto' (plain GJ) | 'pallas_gj' (the GJ kernel) |
    # 'cholesky' | 'schur' | 'eigh'
    bss_inverse: str = 'gauss_jordan'

    bf: str = 'mvdrSouden_ban'
    postfilter: str = None
    compile_mode: str = 'fused'

    def __post_init__(self):
        counts = {
            'wpe_psd_context': self.wpe_psd_context >= 0,
            'wpe_chunk_size': self.wpe_chunk_size is None
            or self.wpe_chunk_size >= 1,
            'wpe_solve_refine': self.wpe_solve_refine >= 0,
        }
        for name, ok in counts.items():
            if not ok:
                raise ValueError(f'{name}={getattr(self, name)!r}')
        checks = {
            'wpe_precision': self.wpe_precision == 'highest',
            'wpe_stats_backend': self.wpe_stats_backend in (
                'auto', 'xla', 'pallas'),
            'bf': self.bf in BEAMFORMERS,
            'postfilter': self.postfilter in (None, 'mask_mul'),
            'compile_mode': self.compile_mode == 'fused',
        }
        for name, ok in checks.items():
            if not ok:
                raise NotImplementedError(
                    f'{name}={getattr(self, name)!r} is {_ROADMAP}')
        self.cacgmm_config     # validates the EM fields

    @property
    def cacgmm_config(self):
        return CacgmmConfig(
            iterations=self.bss_iterations,
            iterations_post=self.bss_iterations_post,
            inverse=self.bss_inverse,
            em_backend=self.bss_em_backend,
        )

    @classmethod
    def from_dict(cls, fields: dict):
        """Build from ``dataclasses.asdict`` of a JAX ``GssConfig`` (or any
        mapping with the same keys)."""
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(fields) - names
        if unknown:
            raise ValueError(f'unknown GssConfig fields {sorted(unknown)}')
        return cls(**fields)


def _stft_and_mask(obs, num_valid_samples, config: GssConfig):
    """obs (D, N) int16 or float tensor -> (Obs (F, D, T), frame_mask (T,)
    bool or None, N).  int16 PCM is scaled by 2^-15 on the device."""
    if obs.dtype == torch.int16:
        obs = obs.to(torch.float32) * (2.0 ** -15)
    N = obs.shape[-1]
    size, shift = config.stft_size, config.stft_shift
    Obs = stft(obs, size, shift, fading=config.stft_fading)    # (D, T, F)
    T = Obs.shape[-2]
    Obs = Obs.permute(2, 0, 1)                                 # (F, D, T)
    frame_mask = None
    if num_valid_samples is not None:
        frame_mask = valid_frame_mask(
            num_valid_samples, T, size, shift, fading=config.stft_fading,
            device=obs.device)
    return Obs, frame_mask, N


def _wpe_stage(Obs_fdt, config: GssConfig, frame_mask):
    if not config.wpe:
        return Obs_fdt
    return wpe(Obs_fdt, taps=config.wpe_taps, delay=config.wpe_delay,
               iterations=config.wpe_iterations,
               psd_context=config.wpe_psd_context,
               regularization=config.wpe_regularization,
               chunk_size=config.wpe_chunk_size, frame_mask=frame_mask,
               stats_backend=config.wpe_stats_backend,
               solve_refine=config.wpe_solve_refine)


def _em_stage(Obs_fdt, activity_freq, config: GssConfig, frame_mask):
    return cacgmm_posteriors(Obs_fdt.transpose(1, 2), activity_freq,
                             config=config.cacgmm_config,
                             frame_mask=frame_mask)            # (F, K, T)


def _beamform(Obs_fdt, target_mask, distortion_mask, noise_mask,
              config: GssConfig):
    """Obs (F, D, T), masks (F, T) -> X_hat (F, T).  LCMV takes the
    garbage class (``noise_mask``, the last class) as noise and the other
    speakers as interference; 'ch2' / 'sum' bypass the masks.

    GEV and LCMV compute their PSDs and vectors in float64 (the vector is
    applied in the input's precision).  Their loads (1e-10 relative) are
    below float32's resolution: where the EM leaves the noise class a
    frame or two of mass, the equilibrated noise PSD reaches a condition
    near 1e9 and a float32 vector is rounding noise; the JAX package's
    float32 and float64 chains then differ by more than the peak
    (``scripts_dev/diag_torch_scene_precision.py``)."""
    kind = config.bf
    if kind == 'ch2':
        return Obs_fdt[:, 2, :]
    if kind == 'sum':
        return Obs_fdt.sum(dim=1)
    Y = Obs_fdt
    if kind in FLOAT64_BEAMFORMERS:
        Y = Obs_fdt.to(torch.complex128)
        target_mask, distortion_mask, noise_mask = (
            m.to(torch.float64)
            for m in (target_mask, distortion_mask, noise_mask))
    cov_x = bf.psd_matrix(Y, target_mask)
    if kind in ('lcmv', 'lcmv_ban'):
        cov_i = bf.psd_matrix(Y, distortion_mask - noise_mask)
        cov_n = bf.psd_matrix(Y, noise_mask)
        w = bf.lcmv_vector(cov_x, cov_i, cov_n)
        if kind == 'lcmv_ban':
            w = bf.blind_analytic_normalization(w, cov_i + cov_n)
        return bf.apply_beamforming_vector(w.to(Obs_fdt.dtype), Obs_fdt)
    cov_n = bf.psd_matrix(Y, distortion_mask)
    if kind in ('gev_ban', 'gev'):
        w = bf.gev_vector(cov_x, cov_n)
    else:
        w = bf.mvdr_souden_vector(cov_x, cov_n, eps=1e-10)
    if kind.endswith('_ban'):
        w = bf.blind_analytic_normalization(w, cov_n)
    return bf.apply_beamforming_vector(w.to(Obs_fdt.dtype), Obs_fdt)


def _bf_stage(Obs_fdt, masks, target_index, config: GssConfig,
              start_context_frames, end_context_frames, frame_mask):
    T = Obs_fdt.shape[-1]
    frame_idx = torch.arange(T, device=Obs_fdt.device)
    keep = (frame_idx >= start_context_frames) & \
        (frame_idx < T - end_context_frames)
    if frame_mask is not None:
        keep = keep & frame_mask
    masks = masks * keep.to(masks.dtype)
    target_mask = masks[:, target_index, :]                    # (F, T)
    distortion_mask = masks.sum(dim=1) - target_mask
    X_hat = _beamform(Obs_fdt, target_mask, distortion_mask, masks[:, -1, :],
                      config)
    if config.postfilter == 'mask_mul':
        X_hat = X_hat * target_mask.to(X_hat.dtype)
    return X_hat, masks


def _trim_output(x_hat, start, samples):
    """``samples`` samples of the enhanced waveform from ``start``, the
    tail zero-padded so any in-range start yields exactly ``samples``
    (the JAX in-graph trim; a pure copy of the host slice)."""
    if samples is None:
        return x_hat
    x_hat = torch.nn.functional.pad(x_hat, (0, samples))
    return x_hat[start:start + samples]


def gss_enhance(obs, activity_freq, target_index, *,
                config: GssConfig = GssConfig(), start_context_frames=0,
                end_context_frames=0, num_valid_samples=None,
                num_output_samples=None, output_trim_start=0,
                output_trim_samples=None):
    """Enhance one (possibly zero-padded) multichannel utterance.

    obs (D, N) int16 / float tensor on the compute device; activity_freq
    (K, T) per-class frame activity; target_index int.  Context frames,
    ``num_valid_samples``, ``num_output_samples`` and the output trim
    have the JAX :func:`pb_chime5_tpu.models.gss.gss_enhance` meaning.
    Returns (x_hat, masks (K, T, F)), both on the device of ``obs``.
    """
    device = obs.device
    if device.type == 'cuda':
        assert_precision()
    _mark_stage(device, start=True)
    Obs, frame_mask, N = _stft_and_mask(obs, num_valid_samples, config)
    _mark_stage(device)
    Obs = _wpe_stage(Obs, config, frame_mask)
    _mark_stage(device)
    masks = _em_stage(Obs, torch.as_tensor(activity_freq, device=device),
                      config, frame_mask)
    _mark_stage(device)
    X_hat, masks = _bf_stage(Obs, masks, int(target_index), config,
                             int(start_context_frames),
                             int(end_context_frames), frame_mask)
    _mark_stage(device)
    x_hat = istft(X_hat.T, config.stft_size, config.stft_shift,
                  fading=config.stft_fading,
                  num_samples=(num_output_samples
                               if num_output_samples is not None else N))
    _mark_stage(device)
    x_hat = _trim_output(x_hat, int(output_trim_start), output_trim_samples)
    return x_hat, masks.permute(1, 2, 0)                       # (K, T, F)


def _slice_cached_obs(cache, offsets, num_arrays, slice_samples,
                      num_valid_samples):
    """The (A*C, N_pad) observation out of the device-resident session
    window, as a new contiguous tensor (the window is left as it is):
    array ``a``'s C rows from ``offsets[a]``, samples from
    ``num_valid_samples`` on zeroed, so the result equals the direct
    path's zero-padded upload bit for bit."""
    A, N_pad = num_arrays, slice_samples
    C = cache.shape[0] // A
    obs = torch.cat([cache[a * C:(a + 1) * C,
                           int(offsets[a]):int(offsets[a]) + N_pad]
                     for a in range(A)], dim=0)
    if num_valid_samples is not None:
        obs[:, int(num_valid_samples):] = 0
    return obs


def gss_enhance_cached(cache, offsets, activity_freq, target_index, *,
                       config: GssConfig = GssConfig(), num_arrays,
                       slice_samples, start_context_frames=0,
                       end_context_frames=0, num_valid_samples=None,
                       num_output_samples=None, output_trim_start=0,
                       output_trim_samples=None):
    """:func:`gss_enhance` with the observation sliced out of a
    device-resident session-audio window (``models/audio_cache.py``)
    instead of uploaded per utterance.

    cache (A*C, W) int16 / float tensor of session audio, rows grouped
    per array (the 'ACN->A*CN' stacking); offsets (A,) host ints, each
    array's start inside the window (per-array clock drift gives each
    array its own); ``num_arrays`` A and ``slice_samples`` N_pad;
    samples from ``num_valid_samples`` on are zeroed (the window holds
    real audio there, the direct path zeros).  Everything else exactly
    as :func:`gss_enhance`."""
    obs = _slice_cached_obs(cache, offsets, num_arrays, slice_samples,
                            num_valid_samples)
    return gss_enhance(
        obs, activity_freq, target_index, config=config,
        start_context_frames=start_context_frames,
        end_context_frames=end_context_frames,
        num_valid_samples=num_valid_samples,
        num_output_samples=num_output_samples,
        output_trim_start=output_trim_start,
        output_trim_samples=output_trim_samples)


class GssPipeline:
    """Host wrapper: NumPy in, NumPy out (float32 compute), length
    bucketing, output trim planning and asynchronous dispatch on the
    current CUDA stream."""

    def __init__(self, config: GssConfig = GssConfig(), *,
                 length_buckets=None, device_trim=True, device='cuda'):
        self.config = config
        self.length_buckets = length_buckets
        self.device_trim = device_trim
        self.device = resolve_device(device)

    def bucket_length(self, n: int) -> int:
        if not self.length_buckets:
            return n
        for b in self.length_buckets:
            if n <= b:
                return b
        top = self.length_buckets[-1]
        return -(-n // top) * top

    @staticmethod
    def output_bucket(num_emitted: int, bucket_samples: int):
        """``num_emitted`` rounded up to 1/8ths of the bucket; None when
        the trim would not shrink the download."""
        step = -(-bucket_samples // 8)
        out = -(-int(num_emitted) // step) * step
        return out if out < bucket_samples else None

    def frame_count(self, num_samples: int) -> int:
        return stft_frame_count(
            num_samples, self.config.stft_size, self.config.stft_shift,
            fading=self.config.stft_fading)

    @staticmethod
    def _normalize_obs(obs):
        """int16 PCM stays int16 (half the upload bytes; scaled on the
        device); int32 PCM is scaled on the host; anything else becomes
        float32."""
        obs = np.asarray(obs)
        if obs.dtype == np.int32:
            obs = (obs * 2.0 ** -31).astype(np.float32)
        elif obs.dtype != np.int16:
            obs = obs.astype(np.float32)
        if obs.ndim == 1:
            obs = obs[None]
        return obs

    def _plan_trim(self, trim, N, N_pad):
        """(valid samples of the downloaded waveform, host slice, trim
        kwargs of :func:`gss_enhance`) for ``trim=(start, num_emitted)``."""
        if trim is None:
            return N, slice(None), {}
        t0, tn = int(trim[0]), int(trim[1])
        out_pad = (self.output_bucket(tn, N_pad)
                   if self.device_trim and 0 <= t0 and t0 + tn <= N
                   else None)
        if out_pad is None:
            return N, slice(t0, t0 + tn), {}
        return tn, slice(None), dict(output_trim_start=t0,
                                     output_trim_samples=out_pad)

    def _upload(self, array):
        x = torch.from_numpy(np.ascontiguousarray(array))
        if self.device.type == 'cuda':
            x = x.pin_memory()
        return x.to(self.device, non_blocking=True)

    def _bucket_activity(self, activity_freq, N_pad):
        """(K, T) activity -> int8 (K, T_pad) on the device."""
        T_pad = self.frame_count(N_pad)
        act = np.zeros((activity_freq.shape[0], T_pad), np.int8)
        act[:, :activity_freq.shape[1]] = np.asarray(
            activity_freq, np.int8)[:, :T_pad]
        return self._upload(act)

    def dispatch(self, obs, activity_freq, target_index, *,
                 start_context_frames=0, end_context_frames=0, trim=None):
        """Enqueue one utterance on the current stream and return a handle
        for :meth:`gather` without waiting for the device: the upload is
        from pinned memory, and the waveform's download into pinned host
        memory is enqueued behind the compute."""
        obs = self._normalize_obs(obs)
        D, N = obs.shape
        N_pad = self.bucket_length(N)
        padded = np.zeros((D, N_pad), obs.dtype)
        padded[:, :N] = obs
        N_dl, host_slice, trim_kw = self._plan_trim(trim, N, N_pad)
        x_hat, masks = gss_enhance(
            self._upload(padded), self._bucket_activity(activity_freq, N_pad),
            target_index, config=self.config,
            start_context_frames=start_context_frames,
            end_context_frames=end_context_frames, num_valid_samples=N,
            num_output_samples=N_pad, **trim_kw)
        return self._handle(x_hat, masks, N_dl, host_slice)

    def dispatch_cached(self, cache, offsets, num_valid_samples,
                        activity_freq, target_index, *,
                        start_context_frames=0, end_context_frames=0,
                        trim=None):
        """:meth:`dispatch` with the observation sliced from a
        device-resident session window (:func:`gss_enhance_cached`):
        ``cache`` the (A*C, W) tensor on this pipeline's device,
        ``offsets`` the per-array window starts, ``num_valid_samples``
        the true (min-over-arrays) sample count.  Output is bit-identical
        to :meth:`dispatch` with the equivalent host-loaded observation.

        The window was uploaded on another stream, and its memory goes
        back to that stream's pool when the cache drops it: it is
        recorded on the current stream, so the allocator reuses it only
        after the work enqueued here has read it."""
        N = int(num_valid_samples)
        N_pad = self.bucket_length(N)
        offsets = np.asarray(offsets, np.int32)
        W = cache.shape[1]
        if cache.device.type != self.device.type:
            raise ValueError(f'window on {cache.device}, pipeline on '
                             f'{self.device}')
        if offsets.min() < 0 or offsets.max() + N_pad > W:
            raise ValueError(f'offsets {offsets} + {N_pad} samples outside '
                             f'the window of {W}')
        if cache.device.type == 'cuda':
            cache.record_stream(torch.cuda.current_stream(cache.device))
        N_dl, host_slice, trim_kw = self._plan_trim(trim, N, N_pad)
        x_hat, masks = gss_enhance_cached(
            cache, offsets, self._bucket_activity(activity_freq, N_pad),
            target_index, config=self.config, num_arrays=len(offsets),
            slice_samples=N_pad, start_context_frames=start_context_frames,
            end_context_frames=end_context_frames, num_valid_samples=N,
            num_output_samples=N_pad, **trim_kw)
        return self._handle(x_hat, masks, N_dl, host_slice)

    def _handle(self, x_hat, masks, N_dl, host_slice):
        """Enqueue the waveform's download into pinned host memory behind
        the compute; the handle of :meth:`gather`."""
        done = None
        if self.device.type == 'cuda':
            host = torch.empty(x_hat.shape, dtype=x_hat.dtype,
                               pin_memory=True)
            host.copy_(x_hat, non_blocking=True)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            x_hat = host
        return x_hat, masks, N_dl, host_slice, done

    @staticmethod
    def gather(handle, return_masks=False):
        """Wait for a dispatched utterance; returns the emitted waveform
        (and the (K, T, F) masks when ``return_masks``)."""
        x_hat, masks, N, sl, done = handle
        if done is not None:
            done.synchronize()
        x = x_hat.numpy()[:N][sl]
        return (x, masks.cpu().numpy()) if return_masks else x

    def __call__(self, obs, activity_freq, target_index, *,
                 start_context_frames=0, end_context_frames=0,
                 return_masks=False):
        """Synchronous call: (x_hat, masks or None)."""
        handle = self.dispatch(
            obs, activity_freq, target_index,
            start_context_frames=start_context_frames,
            end_context_frames=end_context_frames)
        if return_masks:
            return self.gather(handle, return_masks=True)
        return self.gather(handle), None
