"""The port's mesh session loop, its completion hook and warmup on the CPU:
twins of ``tests/test_enhancer.py``'s mesh, resume, fast_start and warmup
tests on the same synthetic corpus (the port's own corpus maker writes
the JAX one's bytes), with a mesh of 8 CPU slots in place of the JAX
tests' 8 virtual CPU devices.

Tolerances are the JAX tests': the data-only mesh writes WAVs
byte-identical to the serial path; data x freq with WPE and two rows a
device agrees to 1e-3.  There is no twin of
``test_mesh_dispatch_reuses_traced_executable``: an eager chain traces
nothing.  "No new compile" after warmup reads, in the port, as no nvcc
build and no library load (``ops/kernels/_build.stats``): on the CPU no
kernel library is ever built (warmup loads only the host readers'), so the
twin also checks that warmup ran the session's batches.
"""

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch.database.create_json import create_database
from pb_chime5_tpu_torch.io import dump_json, load_audio
from pb_chime5_tpu_torch.models.enhancer import get_enhancer
from pb_chime5_tpu_torch.ops.kernels import _build
from pb_chime5_tpu_torch.parallel import make_mesh
from pb_chime5_tpu_torch.parallel.scheduler import FileQueueScheduler
from pb_chime5_tpu_torch.scripts.run import make_experiment
from pb_chime5_tpu_torch.testing import create_synthetic_chime5

torch.set_num_threads(2)

SMALL = dict(bss_iterations=5, bss_iterations_post=1, context_samples=8000,
             length_buckets=(16000 * 2, 16000 * 4), device='cpu')
CPU8 = [torch.device('cpu')] * 8


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp('chime5_mesh')
    create_synthetic_chime5(
        root, session_ids=('S02',), duration_seconds=16.0,
        utterances_per_speaker=1, num_arrays=2, seed=11)
    json_path = root / 'chime5.json'
    dump_json(create_database(root), json_path)
    return json_path


def wavs_of(audio_dir):
    return sorted((audio_dir / 'dev').glob('*.wav'))


def assert_same_bytes(a_dir, b_dir):
    a, b = wavs_of(a_dir), wavs_of(b_dir)
    assert a and [p.name for p in a] == [p.name for p in b]
    for x, y in zip(a, b):
        assert x.read_bytes() == y.read_bytes(), x.name


def test_enhance_session_mesh_matches_serial(corpus, tmp_path):
    """The mesh session loop over 8 data slots writes WAVs byte-identical
    to the serial path, through the session-audio cache; the 4-utterance
    session is a partial batch (4 < 8), dispatched with its real rows."""
    enhancer = get_enhancer(database_path=str(corpus), wpe=False,
                            multiarray=False, **SMALL)
    enhancer.enhance_session(['S02'], tmp_path / 'serial',
                             audio_dir_exist_ok=True)
    hits_before = enhancer._audio_cache.stats['hits']
    enhancer.enhance_session(['S02'], tmp_path / 'mesh',
                             audio_dir_exist_ok=True,
                             mesh=make_mesh(data=8, freq=1, devices=CPU8))
    assert enhancer._audio_cache.stats['hits'] > hits_before
    assert_same_bytes(tmp_path / 'serial', tmp_path / 'mesh')


def test_enhance_session_mesh_data_freq_wpe(corpus, tmp_path, capsys):
    """A data x freq (4 x 2) mesh with WPE on and 2 utterances a data
    group: within 1e-3 of the serial path (the frequency shards' MVDR
    statistics are summed in another order); the loop warns that unchunked
    WPE holds its stacked signal for every row."""
    enhancer = get_enhancer(database_path=str(corpus), wpe=True, wpe_tabs=2,
                            wpe_iterations=1, multiarray=False, **SMALL)
    enhancer.enhance_session(['S02'], tmp_path / 'serial',
                             audio_dir_exist_ok=True)
    enhancer.enhance_session(['S02'], tmp_path / 'mesh',
                             audio_dir_exist_ok=True,
                             mesh=make_mesh(data=4, freq=2, devices=CPU8),
                             utterances_per_device=2)
    assert 'utterances_per_device > 1 with unchunked WPE' in \
        capsys.readouterr().out
    serial, meshed = wavs_of(tmp_path / 'serial'), wavs_of(tmp_path / 'mesh')
    assert serial and [p.name for p in serial] == [p.name for p in meshed]
    for a, b in zip(serial, meshed):
        xa, xb = load_audio(a), load_audio(b)
        assert xa.shape == xb.shape
        np.testing.assert_allclose(xa, xb, atol=1e-3)


@pytest.mark.parametrize('mesh', [False, True], ids=['serial', 'mesh'])
def test_enhance_session_resume_and_skip(corpus, tmp_path, mesh):
    """The session loop (serial and mesh) takes ``mark_complete`` from a
    ``FileQueueScheduler.shard``: a done marker for exactly the written
    WAVs; a resumed run skips them (no rewrite) and marks them complete in
    its own queue."""
    enhancer = get_enhancer(database_path=str(corpus), wpe=False,
                            multiarray=False, **SMALL)
    kw = dict(audio_dir_exist_ok=True)
    if mesh:
        kw['mesh'] = make_mesh(data=8, freq=1, devices=CPU8)
    q = FileQueueScheduler(tmp_path / 'queue', worker_id='w1')
    written = []

    def shard_fn(examples, length_fn):
        shard = q.shard(examples, length_fn)
        mark = shard.mark_complete

        def mark_complete(example_id):
            # called once the WAV is written, before its progress call
            assert (tmp_path / 'audio' / 'dev' / f'{example_id}.wav') \
                .exists()
            assert example_id not in written
            mark(example_id)
        shard.mark_complete = mark_complete
        return shard
    enhancer.enhance_session(['S02'], tmp_path / 'audio', shard_fn=shard_fn,
                             progress=written.append, **kw)
    wavs = wavs_of(tmp_path / 'audio')
    assert wavs and sorted(written) == [p.stem for p in wavs]
    done = sorted(p.stem for p in (tmp_path / 'queue').glob('*.done'))
    assert done == [p.stem for p in wavs]
    mtimes = {p.name: p.stat().st_mtime_ns for p in wavs}
    q2 = FileQueueScheduler(tmp_path / 'queue2', worker_id='w2')
    enhancer.enhance_session(['S02'], tmp_path / 'audio', shard_fn=q2.shard,
                             resume=True, **kw)
    assert {p.name: p.stat().st_mtime_ns
            for p in wavs_of(tmp_path / 'audio')} == mtimes
    assert sorted(p.stem for p in (tmp_path / 'queue2').glob('*.done')) \
        == done


def test_enhance_session_only_master_makes_audio_dir(corpus, tmp_path):
    """A non-master (``is_master=False``) makes no directory, so a master
    that comes after it makes its new audio dir with the default
    ``audio_dir_exist_ok=False``, dataset dirs included."""
    enhancer = get_enhancer(database_path=str(corpus), wpe=False,
                            multiarray=False, **SMALL)
    audio = tmp_path / 'audio'

    def nothing(examples, length_fn):
        return []
    enhancer.enhance_session(['S02'], audio, is_master=False,
                             shard_fn=nothing)
    assert not audio.exists()
    enhancer.enhance_session(['S02'], audio, shard_fn=nothing)
    assert (audio / 'dev').is_dir()
    with pytest.raises(FileExistsError):
        enhancer.enhance_session(['S02'], audio, shard_fn=nothing)


def test_run_cli_mesh(corpus, tmp_path):
    """The CLI's ``mesh=8 device=cpu mesh_freq=2 utterances_per_device=1
    warmup=True``: 8 CPU slots as a 4 x 2 mesh, the whole session."""
    exp = make_experiment(default_storage=tmp_path / 'runs')
    exp.run_commandline([
        'main', 'with', 'session_id=S02', f'database_path={corpus}',
        'wpe=False', 'bss_iterations=2', 'context_samples=8000',
        'length_buckets=(32000,)', 'device=cpu', 'mesh=8', 'mesh_freq=2',
        'utterances_per_device=1', 'warmup=True'])
    wavs = list((exp.run_dir / 'audio' / 'dev').glob('*.wav'))
    assert len(wavs) == 4, wavs
    for w in wavs:
        x = load_audio(w)
        assert np.isfinite(x).all() and np.abs(x).max() > 0
    with pytest.raises(ValueError):
        make_experiment(default_storage=tmp_path / 'runs').run_commandline([
            'main', 'with', 'session_id=S02', f'database_path={corpus}',
            'device=cpu', 'mesh=auto'])


def test_device_audio_cache_fast_start(corpus, tmp_path):
    """fast_start with the session-audio cache (its warmup included): WAVs
    byte-identical to the direct path in the same mode, and to the fused
    chain's."""
    kw = dict(database_path=str(corpus), wpe=False, multiarray=True, **SMALL)
    fused = get_enhancer(device_audio_cache=False, **kw)
    fused.enhance_session(['S02'], tmp_path / 'fused',
                          audio_dir_exist_ok=True)
    off = get_enhancer(device_audio_cache=False, compile_mode='fast_start',
                       **kw)
    off.enhance_session(['S02'], tmp_path / 'off', audio_dir_exist_ok=True)
    on = get_enhancer(device_audio_cache=True, cache_window_seconds=20.0,
                      compile_mode='fast_start', **kw)
    on._pipeline.warmup(8, 5, lengths=[16000 * 2], num_arrays=2,
                        cache_window_samples=int(20.0 * 16000))
    on.enhance_session(['S02'], tmp_path / 'on', audio_dir_exist_ok=True)
    assert on._audio_cache.stats['hits'] > 0
    assert_same_bytes(tmp_path / 'off', tmp_path / 'on')
    assert_same_bytes(tmp_path / 'fused', tmp_path / 'on')


def test_mesh_mixed_cached_and_direct_batches(corpus, tmp_path):
    """When the session-audio cache disables itself mid-session (a window
    that fits one bucket: wasteful refills), the mesh loop collates cached
    and direct rows and still matches the serial path byte for byte."""
    kw = dict(database_path=str(corpus), wpe=False, multiarray=False,
              **SMALL)
    serial = get_enhancer(device_audio_cache=False, **kw)
    serial.enhance_session(['S02'], tmp_path / 'serial',
                           audio_dir_exist_ok=True)
    meshy = get_enhancer(device_audio_cache=True, cache_window_seconds=6.0,
                         **kw)
    meshy.enhance_session(['S02'], tmp_path / 'mesh',
                          audio_dir_exist_ok=True,
                          mesh=make_mesh(data=8, freq=1, devices=CPU8))
    stats = meshy._audio_cache.stats
    assert stats['refills'] >= 1 and stats['direct'] >= 1, stats
    assert_same_bytes(tmp_path / 'serial', tmp_path / 'mesh')


def test_enhancer_warmup_derives_shapes(corpus, tmp_path, monkeypatch):
    """``Enhancer.warmup`` dispatches the session's real shapes: the
    channels of the multiarray selection, the classes of the activity,
    the dtype of the (float) audio files, the session's length buckets and
    device-trim
    output buckets, direct and through the window; then the session
    runs."""
    from pb_chime5_tpu_torch.models.gss import GssPipeline
    enhancer = get_enhancer(database_path=str(corpus), wpe=False,
                            multiarray=True, **SMALL)
    seen = []
    real = GssPipeline.warmup

    def spy(self, num_channels, num_classes, **kw):
        seen.append((num_channels, num_classes, kw))
        return real(self, num_channels, num_classes, **kw)
    monkeypatch.setattr(GssPipeline, 'warmup', spy)
    enhancer.warmup('S02')
    [(channels, classes, kw)] = seen
    assert (channels, classes) == (8, 5)
    assert np.dtype(kw['dtype']) == np.float32 and kw['num_arrays'] == 2
    buckets = {enhancer._pipeline.bucket_length(
        min(int(e) - int(s) for _p, s, e, _sel in enhancer._cache_spans(
            ex, ex['reference_array'])))
        for ex in enhancer.get_iterator('S02')}
    assert set(kw['lengths']) == buckets
    assert kw['trim_buckets'] and {b for b, _ in kw['trim_buckets']} \
        <= buckets
    assert kw['cache_window_samples'] == enhancer._audio_cache.window
    enhancer.enhance_session(['S02'], tmp_path / 'audio', dataset_slice=1,
                             audio_dir_exist_ok=True)
    assert list((tmp_path / 'audio' / 'dev').glob('*.wav'))


def test_mesh_warmup_no_new_build(corpus, tmp_path, monkeypatch):
    """``Enhancer.warmup(mesh=...)`` runs the mesh session's batches,
    direct and cached, for its buckets; the session after it builds and
    loads no kernel library, and writes the WAVs of an unwarmed run."""
    from pb_chime5_tpu_torch.parallel import mesh as mesh_module
    cfg = dict(SMALL, bss_iterations=4)
    enhancer = get_enhancer(database_path=str(corpus), wpe=False,
                            multiarray=False, **cfg)
    mesh = make_mesh(data=8, freq=1, devices=CPU8)
    enhancer.enhance_session(['S02'], tmp_path / 'cold',
                             audio_dir_exist_ok=True, mesh=mesh)
    batches = []
    for name in ('sharded_gss_enhance', 'sharded_gss_enhance_cached'):
        real = getattr(mesh_module, name)

        def spy(*args, _real=real, _name=name, **kw):
            batches.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(mesh_module, name, spy)
    enhancer.warmup('S02', mesh=mesh)
    assert 'sharded_gss_enhance' in batches
    assert 'sharded_gss_enhance_cached' in batches
    before = dict(_build.stats)
    enhancer.enhance_session(['S02'], tmp_path / 'mesh',
                             audio_dir_exist_ok=True, mesh=mesh)
    assert _build.stats == before
    assert_same_bytes(tmp_path / 'cold', tmp_path / 'mesh')
