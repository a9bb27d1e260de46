"""The GSS enhancement chain — port of ``pb_chime5_tpu/models/gss.py``.

    STFT -> WPE -> cacGMM EM ("GSS") -> mask context drop ->
    MVDR-Souden / GEV (+BAN) / LCMV (+BAN) / ch2 / sum
    -> optional mask postfilter -> iSTFT -> output trim

:func:`gss_enhance` runs the chain eagerly on the device of its input
(no tracing, no compile step) in the precision of its input: float32
(int16 PCM is scaled to float32 on the device) or float64, where no hand
kernel runs; :class:`GssPipeline` is the host wrapper with the JAX
pipeline's compute ``dtype``, bucketing, trim planning and asynchronous
dispatch / gather.  :func:`gss_enhance_debug` and
:meth:`GssPipeline.debug` are the JAX debug twin: the chain with the
unfused EM's per-iteration statistics.  Layouts match the JAX package:
(F, D, T) through WPE and the beamformer, (F, T, D) into the EM, masks
(K, T, F) out.

The stages also take a batch of B same-shape utterances (a leading B
axis, per-utterance activity, frame mask, target, context frames and
MVDR reference channel): WPE and the EM run its B * F rows in each kernel
launch.  :func:`enhance_spectrogram` is the frequency-domain middle on any
shard of the frequency axis; ``parallel/mesh.py`` drives both over a
(data, freq) grid of devices.  A batch of one gives the unbatched chain's
numbers bit for bit.  :meth:`GssPipeline.warmup` and
:meth:`GssPipeline.warmup_mesh` build and load the kernel and host
libraries and make one dispatch per length bucket ahead of a session.
"""

import contextlib
import dataclasses

import numpy as np
import torch

from pb_chime5_tpu_torch._device import assert_precision, resolve_device
from pb_chime5_tpu_torch.ops import beamform as bf
from pb_chime5_tpu_torch.ops.cacgmm import (
    CacgmmConfig, cacgmm_posteriors, cacgmm_posteriors_debug)
from pb_chime5_tpu_torch.ops.stft import (
    istft, stft, stft_frame_count, valid_frame_mask)
from pb_chime5_tpu_torch.ops.wpe import wpe
from pb_chime5_tpu_torch.utils.profiling import record_spans, span

__all__ = ['GssConfig', 'gss_enhance', 'gss_enhance_cached',
           'gss_enhance_debug', 'gss_enhance_split',
           'gss_enhance_cached_split', 'enhance_spectrogram', 'GssPipeline',
           'record_stage_times']

_ROADMAP = 'not ported yet (see ROADMAP.md, Queue 1)'
BEAMFORMERS = ('mvdrSouden_ban', 'mvdr_souden', 'gev_ban', 'gev', 'lcmv',
               'lcmv_ban', 'ch2', 'sum')
FLOAT64_BEAMFORMERS = ('gev_ban', 'gev', 'lcmv', 'lcmv_ban')   # _beamform

STAGES = ('stft', 'wpe', 'em', 'beamform', 'istft')
MVDR_EPS = 1e-10
_stage_events = None     # CUDA events of gss_enhance inside record_stage_times


@contextlib.contextmanager
def record_stage_times():
    """Per-stage device times of the :func:`gss_enhance` calls on CUDA
    made inside the block: yields a list that, on exit, holds one
    ``{stage: ms}`` dict (CUDA events, in :data:`STAGES` order) per call.
    The block also records the host spans of every thread
    (``utils.profiling.record_spans``; read them with
    ``utils.profiling.recorded_spans()``)."""
    global _stage_events
    assert _stage_events is None, 'record_stage_times does not nest'
    _stage_events = []
    times = []
    try:
        with record_spans():
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
    defaults and the ported kernels (``compile_mode='fast_start'`` runs
    the one eager chain of :func:`gss_enhance`, which has no compile to
    split into the JAX package's three programs): the all-Pallas configuration
    ``GssConfig(bss_em_backend='pallas', bss_inverse='pallas_gj',
    wpe_stats_backend='pallas')`` runs the statistics and Gauss-Jordan
    kernels beside the fused E+M kernel; ``bss_em_backend='xla'`` runs the
    per-frequency EM (``ops/cacgmm.py``).  The chain's options are ported:
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
    # 'auto' (the fused E+M kernel for float32, the per-frequency EM for
    # float64) | 'pallas' (the fused kernel) | 'xla' (per-frequency EM)
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
            'compile_mode': self.compile_mode in ('fused', 'fast_start'),
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
    bool or None, N).  int16 PCM is scaled by 2^-15 on the device, in
    float32, the one compute dtype that uploads it (as in JAX).  A batch
    obs (B, D, N) with ``num_valid_samples`` a sequence of B ints gives
    Obs (B, F, D, T) and frame_mask (B, T)."""
    if obs.dtype == torch.int16:
        obs = obs.to(torch.float32) * (2.0 ** -15)
    N = obs.shape[-1]
    size, shift = config.stft_size, config.stft_shift
    Obs = stft(obs, size, shift, fading=config.stft_fading)  # (..., D, T, F)
    T = Obs.shape[-2]
    # (..., F, D, T), contiguous: every (utterance, frequency) row's
    # products then see one layout, whatever the batch, and a row of a
    # batch rounds as the unbatched chain does
    Obs = Obs.movedim(-1, -3).contiguous()
    frame_mask = None
    if num_valid_samples is not None:
        def mask(n):
            return valid_frame_mask(n, T, size, shift,
                                    fading=config.stft_fading,
                                    device=obs.device)
        frame_mask = (mask(num_valid_samples) if obs.dim() == 2
                      else torch.stack([mask(n) for n in num_valid_samples]))
    return Obs, frame_mask, N


def _row_frame_mask(frame_mask, F):
    """A batch's frame mask (B, T) per (utterance, frequency) row,
    (B * F, T); B = 1 as the unbatched (T,)."""
    if frame_mask is None or frame_mask.shape[0] == 1:
        return None if frame_mask is None else frame_mask[0]
    return frame_mask.repeat_interleave(F, dim=0)


def _wpe_stage(Obs_fdt, config: GssConfig, frame_mask):
    """WPE of (F, D, T), or of a batch (B, F, D, T) as its B * F rows (each
    row with its utterance's frame mask)."""
    if not config.wpe:
        return Obs_fdt
    shape = Obs_fdt.shape
    if Obs_fdt.dim() == 4:
        Obs_fdt = Obs_fdt.reshape(-1, *shape[2:])
        frame_mask = _row_frame_mask(frame_mask, shape[1])
    return wpe(Obs_fdt, taps=config.wpe_taps, delay=config.wpe_delay,
               iterations=config.wpe_iterations,
               psd_context=config.wpe_psd_context,
               regularization=config.wpe_regularization,
               chunk_size=config.wpe_chunk_size, frame_mask=frame_mask,
               stats_backend=config.wpe_stats_backend,
               solve_refine=config.wpe_solve_refine).reshape(shape)


def _em_stage(Obs_fdt, activity_freq, config: GssConfig, frame_mask):
    """EM posteriors (F, K, T), or (B, F, K, T) of a batch (B, F, D, T),
    activity (B, K, T), frame_mask (B, T); a batch of one runs as the
    unbatched call."""
    if Obs_fdt.dim() == 4 and Obs_fdt.shape[0] == 1:
        return _em_stage(Obs_fdt[0], activity_freq[0], config,
                         None if frame_mask is None else frame_mask[0])[None]
    return cacgmm_posteriors(Obs_fdt.transpose(-2, -1), activity_freq,
                             config=config.cacgmm_config,
                             frame_mask=frame_mask)


def _bf_front(Obs_fdt, masks, target_index, config: GssConfig,
              start_context_frames, end_context_frames, frame_mask):
    """The beamformer up to what needs every frequency of an utterance:
    Obs (B, F, D, T), masks (B, F, K, T), the target index and context
    frames B host ints each, frame_mask (B, T) or None -> (state of
    :func:`_bf_back`, the MVDR reference channel's (num, den) (B, D) or
    None).  ``mvdrSouden`` sums those statistics over frequency, so a
    frequency shard's must be summed over the shards in between
    (``parallel/mesh.py``).

    Context frames are dropped from the masks; LCMV takes the garbage
    class (the last one) as noise and the other speakers as interference;
    'ch2' / 'sum' bypass the masks.  GEV and LCMV compute their PSDs and
    vectors in float64 (the vector is applied in the input's precision).
    Their loads (1e-10 relative) are below float32's resolution: where the
    EM leaves the noise class a frame or two of mass, the equilibrated
    noise PSD reaches a condition near 1e9 and a float32 vector is
    rounding noise; the JAX package's float32 and float64 chains then
    differ by more than the peak
    (``scripts_dev/diag_torch_scene_precision.py``)."""
    B, F, D, T = Obs_fdt.shape
    frame_idx = torch.arange(T, device=Obs_fdt.device)
    keep = torch.stack([(frame_idx >= int(s)) & (frame_idx < T - int(e))
                        for s, e in zip(start_context_frames,
                                        end_context_frames)])     # (B, T)
    if frame_mask is not None:
        keep = keep & frame_mask
    masks = masks * keep[:, None, None, :].to(masks.dtype)
    target_mask = torch.stack([masks[b, :, int(k)]
                               for b, k in enumerate(target_index)])
    distortion_mask = masks.sum(dim=2) - target_mask          # (B, F, T)
    state = dict(Obs=Obs_fdt, masks=masks, target_mask=target_mask)
    kind = config.bf
    if kind in ('ch2', 'sum'):
        return state, None

    def rows(x):
        return x.reshape(B * F, *x.shape[2:])
    Y = rows(Obs_fdt)
    target_r, distortion_r = rows(target_mask), rows(distortion_mask)
    noise_r = rows(masks[:, :, -1])
    if kind in FLOAT64_BEAMFORMERS:
        Y = Y.to(torch.complex128)
        target_r, distortion_r, noise_r = (
            m.to(torch.float64) for m in (target_r, distortion_r, noise_r))
    cov_x = bf.psd_matrix(Y, target_r)
    if kind in ('lcmv', 'lcmv_ban'):
        cov_i = bf.psd_matrix(Y, distortion_r - noise_r)
        cov_n = bf.psd_matrix(Y, noise_r)
        w = bf.lcmv_vector(cov_x, cov_i, cov_n)
        if kind == 'lcmv_ban':
            w = bf.blind_analytic_normalization(w, cov_i + cov_n)
        return dict(state, w=w), None
    cov_n = bf.psd_matrix(Y, distortion_r)
    if kind in ('gev_ban', 'gev'):
        w = bf.gev_vector(cov_x, cov_n)
        if kind.endswith('_ban'):
            w = bf.blind_analytic_normalization(w, cov_n)
        return dict(state, w=w), None
    mat = bf.mvdr_souden_matrix(cov_x, cov_n, eps=MVDR_EPS)
    stats = bf.snr_statistics(*(x.reshape(B, F, D, D)
                                for x in (mat, cov_x, cov_n)))
    return dict(state, mat=mat, cov_n=cov_n), stats


def _bf_back(state, stats, config: GssConfig):
    """The rest of the beamformer (:func:`_bf_front`): the MVDR reference
    channel from the (summed) statistics, BAN, the apply and the
    postfilter -> (X_hat (B, F, T), masks (B, F, K, T))."""
    Obs, target_mask = state['Obs'], state['target_mask']
    B, F, D, T = Obs.shape
    kind = config.bf
    if kind == 'ch2':
        X_hat = Obs[:, :, 2, :]
    elif kind == 'sum':
        X_hat = Obs.sum(dim=2)
    else:
        w = state.get('w')
        if w is None:
            ref = bf.reference_channel(*stats, MVDR_EPS)          # (B,)
            w = bf.select_channel(state['mat'].reshape(B, F, D, D),
                                  ref).reshape(B * F, D)
            if kind.endswith('_ban'):
                w = bf.blind_analytic_normalization(w, state['cov_n'])
        X_hat = bf.apply_beamforming_vector(
            w.to(Obs.dtype), Obs.reshape(B * F, D, T)).reshape(B, F, T)
    if config.postfilter == 'mask_mul':
        X_hat = X_hat * target_mask.to(X_hat.dtype)
    return X_hat, state['masks']


def _bf_stage(Obs_fdt, masks, target_index, config: GssConfig,
              start_context_frames, end_context_frames, frame_mask,
              snr_reduce=None):
    """Context drop, beamformer and postfilter: Obs (F, D, T), masks
    (F, K, T), host ints -> (X_hat (F, T), masks); or a batch: Obs
    (B, F, D, T), masks (B, F, K, T), B host ints each, frame_mask (B, T)
    -> (X_hat (B, F, T), masks), each utterance with its own target,
    context and MVDR reference channel.  ``snr_reduce`` sums the MVDR
    reference channel's (B, D) statistics over frequency shards."""
    if Obs_fdt.dim() == 3:
        X_hat, masks = _bf_stage(
            Obs_fdt[None], masks[None], [target_index], config,
            [start_context_frames], [end_context_frames],
            None if frame_mask is None else frame_mask[None], snr_reduce)
        return X_hat[0], masks[0]
    state, stats = _bf_front(Obs_fdt, masks, target_index, config,
                             start_context_frames, end_context_frames,
                             frame_mask)
    if stats is not None and snr_reduce is not None:
        stats = tuple(snr_reduce(x) for x in stats)
    return _bf_back(state, stats, config)


def enhance_spectrogram(Obs_fdt, activity_freq, target_index, *,
                        config: GssConfig, start_context_frames=0,
                        end_context_frames=0, frame_mask=None,
                        snr_reduce=None):
    """The frequency-domain middle of the chain: WPE -> EM -> context drop
    -> beamformer.  Every step is independent per frequency except the
    MVDR reference channel's statistics (``snr_reduce``), so it runs on
    any shard of the frequency axis.

    Obs_fdt (F, D, T) complex, activity_freq (K, T) -> (X_hat (F, T),
    masks (F, K, T)); or a batch (B, F, D, T), (B, K, T), with the target
    index and context frames B host ints each and frame_mask (B, T) ->
    (X_hat (B, F, T), masks (B, F, K, T))."""
    Obs_fdt = _wpe_stage(Obs_fdt, config, frame_mask)
    masks = _em_stage(Obs_fdt, activity_freq, config, frame_mask)
    return _bf_stage(Obs_fdt, masks, target_index, config,
                     start_context_frames, end_context_frames, frame_mask,
                     snr_reduce=snr_reduce)


def _trim_output(x_hat, start, samples):
    """``samples`` samples of the enhanced waveform from ``start``, the
    tail zero-padded so any in-range start yields exactly ``samples``
    (the JAX in-graph trim; a pure copy of the host slice)."""
    if samples is None:
        return x_hat
    x_hat = torch.nn.functional.pad(x_hat, (0, samples))
    return x_hat[start:start + samples]


def _gss_front(obs, num_valid_samples, *, config):
    """STFT and WPE: (Obs (F, D, T), frame_mask (T,) or None)."""
    device = obs.device
    if device.type == 'cuda':
        assert_precision()
    _mark_stage(device, start=True)
    Obs, frame_mask, _ = _stft_and_mask(obs, num_valid_samples, config)
    _mark_stage(device)
    Obs = _wpe_stage(Obs, config, frame_mask)
    _mark_stage(device)
    return Obs, frame_mask


def _gss_em(Obs_fdt, activity_freq, frame_mask, *, config):
    """The cacGMM masks (K, F, T)."""
    device = Obs_fdt.device
    masks = _em_stage(Obs_fdt, torch.as_tensor(activity_freq, device=device),
                      config, frame_mask)
    _mark_stage(device)
    return masks


def _gss_back(Obs_fdt, masks, target_index, start_context_frames,
              end_context_frames, frame_mask, *, config, num_output_samples,
              output_trim_start=0, output_trim_samples=None):
    """Beamformer, iSTFT and output trim: (x_hat, masks (K, T, F))."""
    device = Obs_fdt.device
    X_hat, masks = _bf_stage(Obs_fdt, masks, int(target_index), config,
                             int(start_context_frames),
                             int(end_context_frames), frame_mask)
    _mark_stage(device)
    x_hat = istft(X_hat.T, config.stft_size, config.stft_shift,
                  fading=config.stft_fading, num_samples=num_output_samples)
    _mark_stage(device)
    x_hat = _trim_output(x_hat, int(output_trim_start), output_trim_samples)
    return x_hat, masks.permute(1, 2, 0)


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

    The chain is the JAX package's three stage programs (front: STFT and
    WPE | EM | back: beamformer and iSTFT), which ``compile_mode=
    'fast_start'`` compiles apart there; eager calls have no compile to
    split, so both modes run this one chain.
    """
    Obs, frame_mask = _gss_front(obs, num_valid_samples, config=config)
    masks = _gss_em(Obs, activity_freq, frame_mask, config=config)
    return _gss_back(
        Obs, masks, target_index, start_context_frames, end_context_frames,
        frame_mask, config=config,
        num_output_samples=(num_output_samples
                            if num_output_samples is not None
                            else obs.shape[-1]),
        output_trim_start=output_trim_start,
        output_trim_samples=output_trim_samples)


gss_enhance_split = gss_enhance     # the JAX name of the fast_start chain


def gss_enhance_debug(obs, activity_freq, target_index, *,
                      config: GssConfig = GssConfig(),
                      start_context_frames=0, end_context_frames=0,
                      num_valid_samples=None, num_output_samples=None):
    """:func:`gss_enhance` with per-EM-iteration introspection (the
    reference's ``stack_parameters`` debug collection, core.py:27-29,
    211): the EM is ``ops.cacgmm.cacgmm_posteriors_debug``, the unfused
    one, whatever ``bss_em_backend`` says; no output trim.

    Returns (x_hat, masks (K, T, F), debug dict of (I, F, K) / (I, F)
    tensors: weights, logdet, condition, posterior_entropy), on the
    device of ``obs``."""
    device = obs.device
    if device.type == 'cuda':
        assert_precision()
    Obs, frame_mask, N = _stft_and_mask(obs, num_valid_samples, config)
    Obs = _wpe_stage(Obs, config, frame_mask)
    masks, debug = cacgmm_posteriors_debug(
        Obs.transpose(1, 2), torch.as_tensor(activity_freq, device=device),
        config=config.cacgmm_config, frame_mask=frame_mask)
    X_hat, masks = _bf_stage(Obs, masks, int(target_index), config,
                             int(start_context_frames),
                             int(end_context_frames), frame_mask)
    x_hat = istft(X_hat.T, config.stft_size, config.stft_shift,
                  fading=config.stft_fading,
                  num_samples=(num_output_samples
                               if num_output_samples is not None else N))
    return x_hat, masks.permute(1, 2, 0), debug


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


gss_enhance_cached_split = gss_enhance_cached


class GssPipeline:
    """Host wrapper: NumPy in, NumPy out, the compute ``dtype`` (float32,
    or float64 where no hand kernel runs), length bucketing, output trim
    planning and asynchronous dispatch on the current CUDA stream."""

    def __init__(self, config: GssConfig = GssConfig(), *,
                 length_buckets=None, dtype=np.float32, device_trim=True,
                 device='cuda'):
        self.config = config
        self.length_buckets = length_buckets
        self.dtype = dtype
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

    def _normalize_obs(self, obs):
        """The observation in the compute dtype (the JAX rules): int16 PCM
        stays int16 only for float32 (half the upload bytes; scaled on the
        device), for any other dtype it is scaled on the host; int32 PCM
        is scaled on the host; anything else is cast."""
        obs = np.asarray(obs)
        dtype = np.dtype(self.dtype)
        if obs.dtype == np.int16:
            if dtype != np.float32:
                obs = (obs.astype(dtype) * 2.0 ** -15).astype(dtype)
        elif obs.dtype == np.int32:
            obs = (obs * 2.0 ** -31).astype(dtype)
        else:
            obs = obs.astype(dtype)
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
        with span('gss.upload'):
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

    def _padded(self, obs):
        """(observation in the compute dtype, zero-padded to its length
        bucket, (D, N_pad); N)."""
        obs = self._normalize_obs(obs)
        D, N = obs.shape
        padded = np.zeros((D, self.bucket_length(N)), obs.dtype)
        padded[:, :N] = obs
        return padded, N

    def dispatch(self, obs, activity_freq, target_index, *,
                 start_context_frames=0, end_context_frames=0, trim=None):
        """Enqueue one utterance on the current stream and return a handle
        for :meth:`gather` without waiting for the device: the upload is
        from pinned memory, and the waveform's download into pinned host
        memory is enqueued behind the compute."""
        padded, N = self._padded(obs)
        N_pad = padded.shape[1]
        N_dl, host_slice, trim_kw = self._plan_trim(trim, N, N_pad)
        device_obs = self._upload(padded)
        activity = self._bucket_activity(activity_freq, N_pad)
        with span('gss.enqueue'):
            x_hat, masks = gss_enhance(
                device_obs, activity, target_index, config=self.config,
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
            with span('gss.upload'):
                cache.record_stream(torch.cuda.current_stream(cache.device))
        N_dl, host_slice, trim_kw = self._plan_trim(trim, N, N_pad)
        activity = self._bucket_activity(activity_freq, N_pad)
        with span('gss.enqueue'):
            x_hat, masks = gss_enhance_cached(
                cache, offsets, activity, target_index, config=self.config,
                num_arrays=len(offsets), slice_samples=N_pad,
                start_context_frames=start_context_frames,
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

    def debug(self, obs, activity_freq, target_index, *,
              start_context_frames=0, end_context_frames=0):
        """Synchronous debug call, with :meth:`dispatch`'s bucketing and
        padding: (x_hat, masks, debug dict of NumPy arrays), the
        per-EM-iteration statistics of :func:`gss_enhance_debug`."""
        padded, N = self._padded(obs)
        x_hat, masks, debug = gss_enhance_debug(
            self._upload(padded),
            self._bucket_activity(activity_freq, padded.shape[1]),
            target_index, config=self.config,
            start_context_frames=start_context_frames,
            end_context_frames=end_context_frames, num_valid_samples=N,
            num_output_samples=padded.shape[1])
        return (x_hat.cpu().numpy()[:N], masks.cpu().numpy(),
                {k: v.cpu().numpy() for k, v in debug.items()})

    # -------------------------------------------------------------- warmup --

    @staticmethod
    def _warmup_observation(shape, dtype):
        """Seeded noise of ``shape`` in ``dtype`` (int16 PCM or float)."""
        x = np.random.default_rng(0).standard_normal(shape, np.float32) * 0.1
        return ((x * 2 ** 15).astype(np.int16) if dtype == np.int16
                else x.astype(dtype))

    def _warmup_activity(self, num_classes, N_pad, rows=()):
        """Every class active on every frame: (rows, K, T) int8."""
        return np.ones((*rows, num_classes, self.frame_count(N_pad)), np.int8)

    def _warmup_lengths(self, lengths):
        return sorted({self.bucket_length(n) for n in (
            lengths if lengths is not None else self.length_buckets or ())})

    @staticmethod
    def _load_kernels(devices):
        """Build (if needed) and load the host readers' libraries, and
        every kernel library when a device is a card; once."""
        from pb_chime5_tpu_torch.ops.kernels import _build
        names = _build.HOST_LIBRARIES
        if any(torch.device(d).type == 'cuda' for d in devices):
            names += _build.LIBRARIES
        _build.load_libraries(names)

    def warmup(self, num_channels, num_classes, *, dtype=None, lengths=None,
               parallel=True, cache_window_samples=None, num_arrays=None,
               cache_lengths=None, trim_buckets=None):
        """Ready the card for a session ahead of its first utterance: build
        and load the kernel and host libraries, then one dispatch of a noise
        observation at (``num_channels``, ``num_classes``, ``dtype``) per
        length bucket of ``lengths`` (default: every bucket), per output
        trim of ``trim_buckets`` ((bucket, output samples) pairs), and with
        ``cache_window_samples`` (and ``num_arrays``) the same through the
        session-audio window for ``cache_lengths`` (default: ``lengths``);
        then wait for them.  Afterwards the session's dispatches and reads
        start no build and load no library (``ops/kernels/_build.stats``),
        and cuFFT's plans and the allocator's blocks of these shapes exist.
        The JAX package compiles these programs ahead of time; an eager
        chain compiles nothing, so it runs them.  ``parallel``: enqueue
        every dispatch before waiting (else wait for each in turn)."""
        dtype = np.dtype(dtype if dtype is not None else self.dtype)
        lengths = self._warmup_lengths(lengths)
        trims = {}
        for n_pad, out_pad in (trim_buckets or ()):
            trims.setdefault(int(n_pad), set()).add(int(out_pad))
        self._load_kernels([self.device])
        handles = []

        def run(handle):
            if parallel:
                handles.append(handle)
            else:
                self.gather(handle)

        def variants(N_pad):        # (0, out_pad): device-trimmed to out_pad
            return [None] + [(0, t) for t in sorted(trims.get(N_pad, ()))]
        for N_pad in lengths:
            obs = self._warmup_observation((num_channels, N_pad), dtype)
            act = self._warmup_activity(num_classes, N_pad)
            for trim in variants(N_pad):
                run(self.dispatch(obs, act, 0, trim=trim))
        if cache_window_samples is not None:
            window = self._upload(self._warmup_observation(
                (num_channels, cache_window_samples), dtype))
            offsets = np.zeros(num_arrays or 1, np.int32)
            for N_pad in self._warmup_lengths(
                    cache_lengths if cache_lengths is not None else lengths):
                act = self._warmup_activity(num_classes, N_pad)
                for trim in variants(N_pad):
                    run(self.dispatch_cached(window, offsets, N_pad, act, 0,
                                             trim=trim))
        for handle in handles:
            self.gather(handle)

    def warmup_mesh(self, mesh, num_channels, num_classes, *, dtype=None,
                    lengths=None, utterances_per_device=1, parallel=True,
                    cache_window_samples=None, num_arrays=None,
                    cache_lengths=None):
        """The mesh twin of :meth:`warmup`: the batches the mesh session
        loop dispatches (``parallel/mesh.py``), data x
        ``utterances_per_device`` rows, one per length bucket, direct and
        (with ``cache_window_samples``) through the session-audio window,
        on every device of ``mesh``."""
        from pb_chime5_tpu_torch.parallel.mesh import (
            sharded_gss_enhance, sharded_gss_enhance_cached)
        dtype = np.dtype(dtype if dtype is not None else self.dtype)
        B = mesh.shape['data'] * utterances_per_device
        lengths = self._warmup_lengths(lengths)
        self._load_kernels([d for row in mesh.devices for d in row])
        targets = np.zeros(B, np.int64)
        outs = []

        def run(out):
            if parallel:
                outs.append(out)
            else:
                out.cpu()
        for N_pad in lengths:
            run(sharded_gss_enhance(
                mesh, self._warmup_observation((B, num_channels, N_pad),
                                               dtype),
                self._warmup_activity(num_classes, N_pad, (B,)), targets,
                np.full(B, N_pad), config=self.config,
                num_output_samples=N_pad))
        if cache_window_samples is not None:
            window = self._upload(self._warmup_observation(
                (num_channels, cache_window_samples), dtype))
            A = num_arrays or 1
            for N_pad in self._warmup_lengths(
                    cache_lengths if cache_lengths is not None else lengths):
                run(sharded_gss_enhance_cached(
                    mesh, window, np.zeros((B, A), np.int32),
                    self._warmup_activity(num_classes, N_pad, (B,)), targets,
                    np.full(B, N_pad), config=self.config, num_arrays=A,
                    slice_samples=N_pad, num_output_samples=N_pad))
        for out in outs:
            out.cpu()
