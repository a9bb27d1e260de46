"""The port's parallel modules on the CPU: the schedulers (twins of
``tests/test_parallel.py``'s, and ``process_info`` under ``PB_JOB_ID`` /
``PB_NUM_JOBS`` against the JAX function), the batched and sharded chains
(``parallel/mesh.py``: twins of the JAX mesh tests on a mesh of 8 CPU
slots, and port vs JAX on the same seeded inputs), K1's batched plain
version, the MVDR reference channel per utterance, the ``fast_start``
split and the complex64 WPE solve above K5's d = 256.

Tolerances are the JAX tests': batched vs single and data-parallel vs
batched 1e-4, frequency-sharded vs batched 1e-3 (the MVDR statistics are
summed over the shards in another order), 2e-3 for the fused EM
frequency-sharded against the per-frequency EM, chunked vs unchunked WPE
1e-4 of the peak; port vs JAX 1e-2 of the peak (the chain tolerance of
tests/test_torch_gss.py).  Where the port holds more than the JAX test
(a row of a batch equals its serial chain bit for bit on the CPU), the
test says so.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.models import GssConfig as JaxGssConfig
from pb_chime5_tpu.parallel import make_mesh as jax_make_mesh
from pb_chime5_tpu.parallel import mesh as jax_mesh
from pb_chime5_tpu.parallel import scheduler as jax_scheduler
from pb_chime5_tpu_torch.models.gss import (
    GssConfig, enhance_spectrogram, gss_enhance, gss_enhance_split,
    _stft_and_mask)
from pb_chime5_tpu_torch.ops import beamform
from pb_chime5_tpu_torch.ops.kernels import fused_em
from pb_chime5_tpu_torch.parallel import (
    FileQueueScheduler, batched_gss_enhance, length_balanced_shard,
    make_mesh, process_info, sharded_gss_enhance, strided_shard)

from tests.test_gss_pipeline import FS, activity_to_freq, make_scene

torch.set_num_threads(2)

CPU8 = [torch.device('cpu')] * 8


def _batch(B, seconds=0.7, D=3, config=GssConfig(wpe=False,
                                                  bss_iterations=4)):
    """The JAX tests' batch: B scenes of seeds 0 .. B - 1, targets
    alternating; every row valid to the end."""
    obs, acts, tgts, valids = [], [], [], []
    N = int(seconds * FS)
    for b in range(B):
        o, a, _ = make_scene(np.random.default_rng(b), seconds=seconds, D=D)
        obs.append(o)
        acts.append(activity_to_freq(a, config))
        tgts.append(b % 2)
        valids.append(N)
    return (np.stack(obs).astype(np.float32),
            np.stack(acts).astype(np.int8), np.array(tgts, np.int32),
            np.array(valids, np.int32), N)


def _mixed_batch(B, config, seconds=1.0, D=4):
    """B scenes of one bucket with other valid lengths (zero-padded
    tails), targets and context frames: a quantity shared by mistake
    across the rows shows only on such a batch."""
    N = int(seconds * FS)
    obs, acts = [], []
    valid = [N - (b * N) // (2 * B) for b in range(B)]
    for b in range(B):
        o, a, _ = make_scene(np.random.default_rng(10 + b), seconds=seconds,
                             D=D)
        o[:, valid[b]:] = 0
        a[:, valid[b]:] = False
        obs.append(o)
        acts.append(activity_to_freq(a, config))
    ctx = dict(start_context_frames=[(2 * b) % 5 for b in range(B)],
               end_context_frames=[(3 * b + 1) % 4 for b in range(B)])
    return (np.stack(obs).astype(np.float32), np.stack(acts).astype(np.int8),
            np.array([b % 2 for b in range(B)]), np.array(valid), N, ctx)


def _serial(obs, acts, tgts, valids, N, config, ctx=None):
    ctx = ctx or dict(start_context_frames=[0] * len(obs),
                      end_context_frames=[0] * len(obs))
    return np.stack([gss_enhance(
        torch.from_numpy(obs[b]), torch.from_numpy(acts[b]), int(tgts[b]),
        config=config, num_valid_samples=int(valids[b]),
        num_output_samples=N,
        start_context_frames=ctx['start_context_frames'][b],
        end_context_frames=ctx['end_context_frames'][b])[0].numpy()
        for b in range(len(obs))])


# ------------------------------------------------------------ schedulers --

def test_strided_shard():
    items = list(range(10))
    assert strided_shard(items, 0, 3) == [0, 3, 6, 9]
    assert strided_shard(items, 1, 3) == [1, 4, 7]
    all_items = sorted(sum((strided_shard(items, i, 3) for i in range(3)),
                           []))
    assert all_items == items


def test_length_balanced_shard():
    items = [(f'u{i}', ln) for i, ln in enumerate(
        [100, 1, 50, 60, 2, 99, 98, 3, 4, 97])]
    shards = [length_balanced_shard(items, lambda x: x[1], p, 3)
              for p in range(3)]
    merged = sorted(sum(shards, []))
    assert merged == sorted(items)
    totals = [sum(ln for _, ln in s) for s in shards]
    assert max(totals) - min(totals) <= 60, totals


@pytest.mark.parametrize('jobs', [1, 2, 3, 5])
def test_job_env_shards_as_jax(monkeypatch, jobs):
    """Under ``PB_JOB_ID`` / ``PB_NUM_JOBS`` (1-based job ids), the default
    shards give each job the share the JAX functions give it under the
    same variables, and the jobs' shares partition the items: the port
    used to give every job everything."""
    items = [(f'u{i}', ln) for i, ln in enumerate(
        [100, 1, 50, 60, 2, 99, 98, 3, 4, 97, 55, 56, 12])]
    monkeypatch.delenv('PB_JOB_ID', raising=False)
    monkeypatch.delenv('PB_NUM_JOBS', raising=False)
    assert process_info() == jax_scheduler.process_info() == (0, 1)
    shares = []
    for job in range(1, jobs + 1):
        monkeypatch.setenv('PB_JOB_ID', str(job))
        monkeypatch.setenv('PB_NUM_JOBS', str(jobs))
        assert process_info() == jax_scheduler.process_info() \
            == (job - 1, jobs)
        share = length_balanced_shard(items, lambda x: x[1])
        assert share == jax_scheduler.length_balanced_shard(
            items, lambda x: x[1])
        assert strided_shard(items) == jax_scheduler.strided_shard(items)
        shares.append(share)
    assert sorted(sum(shares, [])) == sorted(items)
    if jobs > 1:
        assert all(len(s) < len(items) for s in shares)


def test_file_queue_scheduler(tmp_path):
    items = [f'item{i}' for i in range(20)]
    w1 = FileQueueScheduler(tmp_path, worker_id='w1')
    w2 = FileQueueScheduler(tmp_path, worker_id='w2')
    got1 = list(w1(items))
    got2 = list(w2(items))
    assert sorted(got1) == sorted(items)
    assert got2 == []
    w3 = FileQueueScheduler(tmp_path, worker_id='w3')
    assert list(w3(items)) == []


def test_file_queue_shard_adapter(tmp_path):
    """``shard`` matches the ``shard_fn(examples, length_fn)`` contract,
    keys claims by example id (not length), and writes a done marker only
    on ``mark_complete``."""
    w = FileQueueScheduler(tmp_path, worker_id='w')
    examples = [{'example_id': f'utt{i}', 'num_samples': 100}
                for i in range(4)]
    shard = w.shard(examples, lambda ex: ex['num_samples'])
    got = list(shard)
    assert [e['example_id'] for e in got] == [f'utt{i}' for i in range(4)]
    assert not list(tmp_path.glob('*.done'))
    shard.mark_complete(got[0])
    shard.mark_complete('utt2')
    assert sorted(p.stem for p in tmp_path.glob('*.done')) == ['utt0',
                                                               'utt2']


def test_file_queue_interleaved(tmp_path):
    items = [f'x{i}' for i in range(10)]
    w1 = FileQueueScheduler(tmp_path, worker_id='w1')
    w2 = FileQueueScheduler(tmp_path, worker_id='w2')
    g1, g2 = w1(items), w2(items)
    out1, out2 = [], []
    for _ in range(5):
        out1.append(next(g1))
        out2.append(next(g2))
    out1 += list(g1)
    out2 += list(g2)
    assert sorted(out1 + out2) == sorted(items)
    assert set(out1) & set(out2) == set()


def test_file_queue_stale_claim_is_reclaimed(tmp_path):
    """A claim without a done marker is taken over once older than
    ``stale_seconds``, never before; a done item never again."""
    import os
    import time
    w1 = FileQueueScheduler(tmp_path, worker_id='w1', stale_seconds=60.0)
    w2 = FileQueueScheduler(tmp_path, worker_id='w2', stale_seconds=60.0)
    assert w1.try_claim('a') and not w2.try_claim('a')
    old = time.time() - 120
    os.utime(tmp_path / 'a.claim', (old, old))
    assert w2.try_claim('a')
    assert (tmp_path / 'a.claim').read_text() == 'w2'
    w2.mark_done('a')
    os.utime(tmp_path / 'a.claim', (old, old))
    assert not w1.try_claim('a')


# ------------------------------------------------------------------ mesh --

def test_make_mesh():
    mesh = make_mesh(data=2, freq=4, devices=CPU8)
    assert mesh.shape == {'data': 2, 'freq': 4}
    assert mesh.devices[1][3] == torch.device('cpu')
    assert make_mesh(freq=2, devices=CPU8).shape == {'data': 4, 'freq': 2}
    with pytest.raises(ValueError):
        make_mesh(data=3, freq=4, devices=CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(1, 1)


def test_batched_matches_single():
    """Twin of the JAX test (atol 1e-4): the port holds a row of the batch
    bit for bit to its serial chain on the CPU."""
    config = GssConfig(wpe=False, bss_iterations=4)
    obs, acts, tgts, valids, N = _batch(2)
    out = batched_gss_enhance(obs, acts, tgts, valids, config=config,
                              num_output_samples=N).numpy()
    single = _serial(obs, acts, tgts, valids, N, config)
    np.testing.assert_allclose(out, single, atol=1e-4)
    np.testing.assert_array_equal(out, single)


@pytest.mark.parametrize('config', [
    GssConfig(stft_size=256, stft_shift=64, wpe_taps=2, wpe_iterations=2,
              bss_iterations=3),
    GssConfig(stft_size=256, stft_shift=64, wpe_taps=2, wpe_chunk_size=16,
              bss_iterations=3, bss_em_backend='xla'),
    GssConfig(stft_size=256, stft_shift=64, wpe_taps=2, bss_iterations=3,
              bf='gev_ban', postfilter='mask_mul'),
], ids=['fused-em', 'xla-em-chunked-wpe', 'gev-mask-mul'])
def test_batched_rows_keep_their_own_quantities(config):
    """A batch of rows with other valid lengths, targets and context
    frames equals their serial chains: the frame masks, activities,
    targets, context frames and MVDR reference channels are per row (bit
    for bit for the fused EM; the per-frequency EM's batched products
    round otherwise, within the JAX test's 1e-4)."""
    obs, acts, tgts, valid, N, ctx = _mixed_batch(3, config)
    out = batched_gss_enhance(obs, acts, tgts, valid, config=config,
                              num_output_samples=N, **ctx).numpy()
    single = _serial(obs, acts, tgts, valid, N, config, ctx)
    np.testing.assert_allclose(out, single, atol=1e-4)
    if config.bss_em_backend != 'xla':
        np.testing.assert_array_equal(out, single)
    one = batched_gss_enhance(obs[1:2], acts[1:2], tgts[1:2], valid[1:2],
                              config=config, num_output_samples=N,
                              start_context_frames=ctx[
                                  'start_context_frames'][1:2],
                              end_context_frames=ctx[
                                  'end_context_frames'][1:2]).numpy()
    np.testing.assert_array_equal(one[0], single[1])


def test_data_parallel_matches_batched():
    """Twin of the JAX test (8 data groups, atol 1e-4); bit for bit here."""
    config = GssConfig(wpe=False, bss_iterations=4)
    obs, acts, tgts, valids, N = _batch(8)
    mesh = make_mesh(data=8, freq=1, devices=CPU8)
    out_sharded = sharded_gss_enhance(mesh, obs, acts, tgts, valids,
                                      config=config,
                                      num_output_samples=N).numpy()
    out_local = batched_gss_enhance(obs, acts, tgts, valids, config=config,
                                    num_output_samples=N).numpy()
    np.testing.assert_allclose(out_sharded, out_local, atol=1e-4)
    np.testing.assert_array_equal(out_sharded, out_local)


def test_freq_parallel_matches_batched():
    config = GssConfig(wpe=False, bss_iterations=4)
    obs, acts, tgts, valids, N = _batch(2)
    mesh = make_mesh(data=2, freq=4, devices=CPU8)
    out_sharded = sharded_gss_enhance(mesh, obs, acts, tgts, valids,
                                      config=config,
                                      num_output_samples=N).numpy()
    out_local = batched_gss_enhance(obs, acts, tgts, valids, config=config,
                                    num_output_samples=N).numpy()
    np.testing.assert_allclose(out_sharded, out_local, atol=1e-3)
    # the JAX factory's callable: the same call with its arguments bound
    from pb_chime5_tpu_torch.parallel.mesh import sharded_gss_fn
    np.testing.assert_array_equal(
        sharded_gss_fn(mesh, config, N)(obs, acts, tgts, valids).numpy(),
        out_sharded)


def test_freq_parallel_with_wpe_and_mvdr():
    obs, acts, tgts, valids, N = _batch(2)
    config = GssConfig(wpe=True, bss_iterations=3)
    mesh = make_mesh(data=1, freq=8, devices=CPU8)
    out_sharded = sharded_gss_enhance(
        mesh, obs[:1], acts[:1], tgts[:1], valids[:1], config=config,
        num_output_samples=N).numpy()
    out_local = batched_gss_enhance(
        obs[:1], acts[:1], tgts[:1], valids[:1], config=config,
        num_output_samples=N).numpy()
    assert out_sharded.shape == (1, N)
    np.testing.assert_allclose(out_sharded, out_local, atol=1e-3)


def test_data_freq_mesh_parity_wpe_and_mvdr():
    obs, acts, tgts, valids, N = _batch(8)
    config = GssConfig(wpe=True, wpe_taps=2, wpe_iterations=1,
                       bss_iterations=3)
    mesh = make_mesh(data=4, freq=2, devices=CPU8)
    out_sharded = sharded_gss_enhance(mesh, obs, acts, tgts, valids,
                                      config=config,
                                      num_output_samples=N).numpy()
    out_local = batched_gss_enhance(obs, acts, tgts, valids, config=config,
                                    num_output_samples=N).numpy()
    np.testing.assert_allclose(out_sharded, out_local, atol=1e-3)


def test_freq_sharded_with_pallas_em():
    """The fused E+M kernel's plain version on each frequency shard
    against the unsharded per-frequency ('xla') EM (the JAX test's 2e-3)."""
    obs, acts, tgts, valids, N = _batch(2)
    mesh = make_mesh(data=1, freq=8, devices=CPU8)
    out_sharded = sharded_gss_enhance(
        mesh, obs[:1], acts[:1], tgts[:1], valids[:1],
        config=GssConfig(wpe=False, bss_iterations=3,
                         bss_em_backend='pallas'),
        num_output_samples=N).numpy()
    out_local = batched_gss_enhance(
        obs[:1], acts[:1], tgts[:1], valids[:1],
        config=GssConfig(wpe=False, bss_iterations=3, bss_em_backend='xla'),
        num_output_samples=N).numpy()
    np.testing.assert_allclose(out_sharded, out_local, atol=2e-3)


def test_sharded_chunked_wpe_matches_unchunked():
    from pb_chime5_tpu_torch.utils import activity_time_to_frequency
    mesh = make_mesh(data=4, freq=2, devices=CPU8)
    rng = np.random.default_rng(0)
    B, D, N, K = 8, 4, 4000, 3
    obs = rng.standard_normal((B, D, N)).astype(np.float32)
    act = np.zeros((K, N), bool)
    act[0, :2500] = True
    act[1, 1500:] = True
    act[2] = True
    act_f = activity_time_to_frequency(
        act, 256, 64, stft_fading=True, stft_pad=True).astype(np.int8)
    act_b = np.broadcast_to(act_f, (B,) + act_f.shape).copy()
    tgt = np.zeros(B, np.int32)
    valid = np.full(B, N, np.int32)
    outs = {}
    for name, chunk in [('unchunked', None), ('chunked', 32)]:
        cfg = GssConfig(stft_size=256, stft_shift=64, wpe=True,
                        wpe_taps=2, wpe_iterations=1, bss_iterations=2,
                        wpe_chunk_size=chunk)
        x = sharded_gss_enhance(mesh, obs, act_b, tgt, valid, config=cfg,
                                num_output_samples=N).numpy()
        assert np.isfinite(x).all()
        outs[name] = x
    scale = np.abs(outs['unchunked']).max()
    np.testing.assert_allclose(outs['chunked'] / scale,
                               outs['unchunked'] / scale, rtol=0, atol=1e-4)


# port vs JAX on the same seeded inputs: the fused E+M (JAX: its Pallas
# kernel in interpret mode) at a 256 / 64 STFT, WPE on
PORT_VS_JAX = dict(stft_size=256, stft_shift=64, wpe_taps=2,
                   wpe_iterations=2, bss_iterations=3,
                   bss_em_backend='pallas')


@pytest.mark.parametrize('mesh_shape', [None, (2, 4)],
                         ids=['batched', 'data2-freq4'])
def test_batched_and_sharded_match_jax(mesh_shape):
    """``batched_gss_enhance`` and ``sharded_gss_enhance`` (data 2 x freq
    4) of both packages on the same batch, within 1e-2 of the peak."""
    config = GssConfig(**PORT_VS_JAX)
    jax_config = JaxGssConfig(**PORT_VS_JAX)
    obs, acts, tgts, valid, N, ctx = _mixed_batch(2, config)
    args = (obs, acts, tgts, valid)
    jargs = [jnp.asarray(a) for a in args]
    jctx = {k: jnp.asarray(v, jnp.int32) for k, v in ctx.items()}
    if mesh_shape is None:
        out = batched_gss_enhance(*args, config=config,
                                  num_output_samples=N, **ctx).numpy()
        want = np.asarray(jax_mesh.batched_gss_enhance(
            *jargs, config=jax_config, num_output_samples=N, **jctx))
    else:
        out = sharded_gss_enhance(make_mesh(*mesh_shape, devices=CPU8),
                                  *args, config=config,
                                  num_output_samples=N, **ctx).numpy()
        want = np.asarray(jax_mesh.sharded_gss_enhance(
            jax_make_mesh(*mesh_shape), *jargs, config=jax_config,
            num_output_samples=N, **jctx))
    assert out.shape == want.shape == (2, N)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, want, atol=1e-2 * np.abs(want).max())


def test_enhance_spectrogram_snr_reduce():
    """``enhance_spectrogram`` on a batch hands the MVDR statistics (B, D)
    to ``snr_reduce`` and picks each utterance's channel from what it
    returns; with the identity it is the unsharded chain."""
    config = GssConfig(stft_size=256, stft_shift=64, wpe=False,
                       bss_iterations=2)
    obs, acts, tgts, valid, N, ctx = _mixed_batch(2, config)
    Obs, fm, _ = _stft_and_mask(torch.from_numpy(obs), list(valid), config)
    seen = []

    def reduce(x):
        seen.append(tuple(x.shape))
        return x
    args = (Obs, torch.from_numpy(acts), list(tgts))
    kw = dict(config=config, frame_mask=fm, **ctx)
    X1, m1 = enhance_spectrogram(*args, snr_reduce=reduce, **kw)
    X0, m0 = enhance_spectrogram(*args, **kw)
    assert seen == [(2, 4), (2, 4)]
    assert torch.equal(X0, X1) and torch.equal(m0, m1)
    assert X0.shape == (2, 129, Obs.shape[-1])


def test_mvdr_reference_channel_per_utterance():
    """A batch of two utterances' PSDs picks each one's SNR-optimal
    channel, over its own frequencies: the unbatched choice of each."""
    rng = np.random.default_rng(3)
    F, D = 9, 4

    def hpd(scale):
        A = rng.standard_normal((F, D, D)) + 1j * rng.standard_normal(
            (F, D, D))
        return torch.as_tensor(A @ A.conj().swapaxes(-1, -2)
                               + np.diag(scale), dtype=torch.complex64)
    cov_x = torch.stack([hpd([9, 0, 0, 0]), hpd([0, 0, 0, 9])])
    cov_n = torch.stack([hpd([1, 1, 1, 1]), hpd([1, 1, 1, 1])])
    w, ref = beamform.mvdr_souden_vector(cov_x, cov_n,
                                         return_ref_channel=True)
    assert w.shape == (2, F, D) and ref.shape == (2,)
    for b in range(2):
        wb, rb = beamform.mvdr_souden_vector(cov_x[b], cov_n[b],
                                             return_ref_channel=True)
        assert int(rb) == int(ref[b])
        torch.testing.assert_close(wb, w[b], rtol=1e-6, atol=1e-7)
    assert int(ref[0]) != int(ref[1])   # a shared channel would fail one


def test_fused_em_batched_plain_version_bit_for_bit():
    """K1's plain version on a batch of B = 3 utterances (each with its
    own gate and frame mask) equals B separate calls bit for bit, and
    B = 1 the unbatched call."""
    from tests.test_torch_fused_em_cuda import batched_inputs, random_inputs
    F = 6
    z, params, act, fm = batched_inputs(F, 90, 8, 3, 3, seed=4)
    S, den = fused_em.fused_em_scatter(z, params, act, fm)   # CPU: plain
    for b in range(3):
        rows = slice(b * F, (b + 1) * F)
        Sb, denb = fused_em.fused_em_scatter_reference(
            z[rows], tuple(p[rows] for p in params), act[b], fm[b])
        assert torch.equal(S[rows], Sb) and torch.equal(den[rows], denb)
    z, params, act, fm = random_inputs(F, 90, 8, 3, seed=5)
    S1, den1 = fused_em.fused_em_scatter(z, params, act, fm)
    S2, den2 = fused_em.fused_em_scatter(z, params, act[None].contiguous(),
                                         fm[None].contiguous())
    assert torch.equal(S1, S2) and torch.equal(den1, den2)
    with pytest.raises(ValueError):
        fused_em.fused_em_scatter(z, params, act.expand(4, -1, -1)
                                  .contiguous(), fm.expand(4, -1)
                                  .contiguous())


def test_split_mode_matches_fused(rng):
    """Twin of ``tests/test_gss_pipeline.py::test_split_mode_matches_fused``:
    ``compile_mode='fast_start'`` equals the fused chain bit for bit, as a
    call and through ``GssPipeline`` (an eager chain has no compile to
    split: both modes run ``gss_enhance``'s front, EM and back stages)."""
    config = GssConfig(wpe=True, bss_iterations=5, compile_mode='fast_start')
    obs, activity, _ = make_scene(rng)
    act_f = torch.from_numpy(activity_to_freq(activity, config)
                             .astype(np.int8))
    obs = torch.from_numpy(obs.astype(np.float32))
    N = obs.shape[-1]
    kw = dict(config=config, start_context_frames=3, end_context_frames=3,
              num_valid_samples=N, num_output_samples=N)
    a, am = gss_enhance(obs, act_f, 0, **kw)
    b, bm = gss_enhance_split(obs, act_f, 0, **kw)
    assert torch.equal(a, b) and torch.equal(am, bm)
    from pb_chime5_tpu_torch.models.gss import GssPipeline
    fused, split = (
        GssPipeline(dataclasses.replace(config, compile_mode=mode),
                    device='cpu')(obs.numpy(), act_f.numpy(), 0,
                                  start_context_frames=3,
                                  end_context_frames=3)[0]
        for mode in ('fused', 'fast_start'))
    assert np.array_equal(fused, split)


def test_pipeline_warmup_both_modes():
    """Twin of ``tests/test_gss_pipeline.py::test_pipeline_warmup_both_modes``:
    ``GssPipeline.warmup`` runs every bucket (direct, trimmed and from a
    window) in both compile modes, parallel or not."""
    from pb_chime5_tpu_torch.models.gss import GssPipeline
    for mode in ('fused', 'fast_start'):
        for parallel in (True, False):
            pipe = GssPipeline(
                GssConfig(wpe=True, wpe_taps=2, bss_iterations=2,
                          compile_mode=mode),
                length_buckets=(8000, 16000), device='cpu')
            pipe.warmup(3, 2, parallel=parallel, trim_buckets=[(8000, 4000)],
                        cache_window_samples=20000, num_arrays=1,
                        cache_lengths=[8000])


def test_complex64_wpe_solve_floors_as_jax():
    """The complex64 twin of
    ``tests/test_torch_gss_float64.py::test_complex128_wpe_solve_floors_as_jax``
    at d = 264 (``wpe_taps=11``, D = 24), above K5's 256: the port's
    ``_solve_G`` floors the pivot at eps^2 * max(diag) as JAX does, and is
    finite where JAX's is (an all-ones R; a relative load of 1e-30, where
    the port raised ``LinAlgError`` before), within 1e-3 of JAX's relative
    Frobenius norm per frequency where the systems are well posed (the
    float32 WPE solve's rounding)."""
    from pb_chime5_tpu.ops.wpe import _solve_G as jax_solve_G
    from pb_chime5_tpu_torch.ops.kernels.chol_solve import supports
    from pb_chime5_tpu_torch.ops.wpe import _solve_G
    rng = np.random.default_rng(6)
    d, E = 11 * 24, 24
    assert not supports(d, E)
    A = rng.standard_normal((3, d, d + 40)) \
        + 1j * rng.standard_normal((3, d, d + 40))
    R = A @ A.conj().swapaxes(-1, -2)
    R[1] = 1.0                                  # rank one
    P = rng.standard_normal((3, d, E)) + 1j * rng.standard_normal((3, d, E))
    R, P = R.astype(np.complex64), P.astype(np.complex64)
    for load in (1e-4, 1e-30):
        got = _solve_G(torch.from_numpy(R), torch.from_numpy(P), load).numpy()
        want = np.asarray(jax_solve_G(jnp.asarray(R), jnp.asarray(P), load,
                                          jnp.float32))
        assert np.isfinite(want).all()
        assert np.isfinite(got).all(), load
        if load == 1e-4:
            for f in (0, 2):
                err = np.linalg.norm(got[f] - want[f]) / np.linalg.norm(
                    want[f])
                assert err < 1e-3, (f, err)
