"""The port's ``io`` package (``wav``, ``audio``, ``json_io`` and the
package's helpers) against the JAX package's, the twins of the 18 tests
of tests/test_io.py: each scenario runs through both packages on the
same seeded inputs, and the files written, the arrays read and the
errors raised must be the same.  ``test_python_and_native_readers_agree``
becomes the port's reader against the JAX package's.  The port reads
through its native library (``csrc/wav_ops.cpp``); where the JAX package
runs its Python parser (its ``_wav_ops`` not built), an error's text is
compared on the port's Python route, and the two native readers are held
to each other in ``tests/test_torch_native.py``.  Exact host
computations: compared exactly.
"""

import struct

import numpy as np
import pytest

from pb_chime5_tpu import io as jax_io
from pb_chime5_tpu.io import audio as jax_audio, wav as jax_wav
from pb_chime5_tpu_torch import io as port_io
from pb_chime5_tpu_torch.io import audio as port_audio, wav as port_wav

PACKAGES = {'port': port_io, 'jax': jax_io}


def both(tmp_path, write):
    """``write(io, path)`` through each package into its own file; the
    two files' bytes must be equal.  -> {name: path}"""
    paths = {}
    for name, io in PACKAGES.items():
        paths[name] = tmp_path / f'{name}.wav'
        write(io, paths[name])
    assert paths['port'].read_bytes() == paths['jax'].read_bytes()
    return paths


def same_reads(path, **kw):
    """The same file read by both packages -> the port's array."""
    got = port_io.load_audio(path, **kw)
    want = jax_io.load_audio(path, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def test_dump_load_roundtrip_no_normalize(tmp_path):
    a = np.array([1, 2, -4, 4], np.int16)
    paths = both(tmp_path, lambda io, f: io.dump_audio(a, f, normalize=False))
    np.testing.assert_array_equal(
        same_reads(paths['port'], dtype=np.int16), a)
    np.testing.assert_allclose(same_reads(paths['port']), a / 2 ** 15)


def test_dump_normalize_peak(tmp_path):
    a = np.array([1.0, 2.0, -4.0, 4.0])
    paths = both(tmp_path, lambda io, f: io.dump_audio(a, f, normalize=True))
    got = same_reads(paths['port'])
    peak = np.abs(got).max()
    np.testing.assert_allclose(peak, (2 ** 15 - 1) / 2 ** 15, atol=2e-5)


def test_segment_read(tmp_path):
    x = (np.arange(1000) % 100).astype(np.int16)
    paths = both(tmp_path, lambda io, f: io.dump_audio(x, f, normalize=False))
    f = paths['port']
    np.testing.assert_array_equal(
        same_reads(f, start=100, stop=200, dtype=np.int16), x[100:200])
    np.testing.assert_array_equal(
        same_reads(f, start=950, frames=10, dtype=np.int16), x[950:960])
    seg = same_reads(f, start=990, stop=1010, dtype=np.int16,
                     fill_value=-1)
    np.testing.assert_array_equal(seg[10:], -1)
    assert port_io.audio_length(f) == jax_io.audio_length(f) == 1000


def test_multichannel_layout(tmp_path):
    x = np.random.default_rng(1).integers(-1000, 1000, (3, 200)) \
        .astype(np.int16)
    paths = both(tmp_path, lambda io, f: io.dump_audio(x, f, normalize=False))
    np.testing.assert_array_equal(
        same_reads(paths['port'], dtype=np.int16), x)
    assert port_io.audio_channels(paths['port']) == 3
    # a list of paths stacks; a dict keeps its keys
    stacked = port_io.load_audio([paths['port'], paths['jax']])
    np.testing.assert_array_equal(
        stacked, jax_io.load_audio([paths['port'], paths['jax']]))
    assert stacked.shape == (2, 3, 200)
    tree = port_io.load_audio({'a': paths['port'], 'b': [paths['jax']]},
                              dtype=np.int16)
    assert tree['a'].shape == (3, 200) and tree['b'].shape == (1, 3, 200)


def test_unit_seconds(tmp_path):
    x = np.linspace(-0.5, 0.5, 32000)
    paths = both(tmp_path, lambda io, f: io.dump_audio(x, f, normalize=False))
    seg = same_reads(paths['port'], start=0.5, stop=1.0, unit='seconds')
    assert seg.shape == (8000,)
    assert port_io.audio_length(paths['port'], unit='seconds') == \
        jax_io.audio_length(paths['port'], unit='seconds') == 2.0
    with pytest.raises(ValueError):
        port_io.load_audio(paths['port'], unit='minutes')


def test_expected_sample_rate(tmp_path):
    x = np.zeros(100)
    paths = both(tmp_path, lambda io, f: io.dump_audio(
        x, f, sample_rate=8000, normalize=False))
    for io in PACKAGES.values():
        with pytest.raises(ValueError, match='Requested sampling rate'):
            io.load_audio(paths['port'], expected_sample_rate=16000)
    signal, rate = port_io.load_audio(paths['port'], expected_sample_rate=8000,
                                      return_sample_rate=True)
    assert rate == 8000 and signal.shape == (100,)


def test_incremental_write(tmp_path):
    def write(io, f):
        io.dump_audio(np.zeros(10), f, normalize=False, dtype=np.int16)
        io.dump_audio(np.array([1, 2, 3], np.int16), f, normalize=False,
                      dtype=np.int16, start=4)
        io.dump_audio(np.array([7, 7], np.int16), f, normalize=False,
                      dtype=np.int16, start=15)   # past the end: zero gap
    paths = both(tmp_path, write)
    got = same_reads(paths['port'], dtype=np.int16)
    np.testing.assert_array_equal(
        got, [0, 0, 0, 0, 1, 2, 3, 0, 0, 0, 0, 0, 0, 0, 0, 7, 7])


def test_incremental_write_fresh_file(tmp_path):
    paths = both(tmp_path, lambda io, f: io.dump_audio(
        np.array([8, 9]) / 32, f, normalize=False, dtype=None, start=5))
    got = same_reads(paths['port'])
    assert got.shape == (7,)
    np.testing.assert_allclose(got[5:], [0.25, 0.28125])


def test_float32_wav(tmp_path):
    x = np.linspace(-1, 1, 100).astype(np.float32)
    paths = both(tmp_path, lambda io, f: io.dump_audio(
        x, f, normalize=False, dtype=None))
    np.testing.assert_array_equal(
        same_reads(paths['port'], dtype=np.float32), x)


def test_port_and_jax_readers_agree(tmp_path):
    """The port's RIFF reader against the JAX package's (the twin of
    ``test_python_and_native_readers_agree``), on a seeded 3-channel file
    and on an extensible-format header."""
    x = np.random.default_rng(0).integers(-2000, 2000, (3, 500)) \
        .astype(np.int16)
    f = tmp_path / 'agree.wav'
    jax_io.dump_audio(x, f, normalize=False)
    got, sr = port_wav.read_wav(f, 17, 230)
    want, sr_jax = jax_wav.read_wav(f, 17, 230)
    np.testing.assert_array_equal(got, want)
    assert sr == sr_jax == 16000
    assert port_wav.wav_info(f) == port_wav.WavInfo(
        **vars(jax_wav.wav_info(f)))
    # WAVE_FORMAT_EXTENSIBLE: 40-byte fmt, sub-format PCM
    data = x.T.tobytes()
    fmt = struct.pack('<HHIIHH', 0xFFFE, 3, 16000, 96000, 6, 16) + \
        struct.pack('<HHI', 22, 16, 0) + struct.pack('<H', 1) + b'\0' * 14
    ext = tmp_path / 'ext.wav'
    ext.write_bytes(b'RIFF' + struct.pack('<I', 4 + 8 + 40 + 8 + len(data))
                    + b'WAVE' + b'fmt ' + struct.pack('<I', 40) + fmt
                    + b'data' + struct.pack('<I', len(data)) + data)
    np.testing.assert_array_equal(same_reads(ext, dtype=np.int16), x)
    # the write twins: the same bytes from both writers
    both(tmp_path, lambda io, f: (port_wav if io is port_io else jax_wav)
         .write_wav(f, x.T, 16000))


def test_json_numpy_roundtrip(tmp_path):
    obj = {'a': np.int64(3), 'b': np.arange(3), 'c': np.float32(1.5)}
    port_io.dump_json(obj, tmp_path / 'port.json')
    jax_io.dump_json(obj, tmp_path / 'jax.json')
    assert (tmp_path / 'port.json').read_text() == \
        (tmp_path / 'jax.json').read_text()
    assert port_io.load_json(tmp_path / 'port.json') == \
        {'a': 3, 'b': [0, 1, 2], 'c': 1.5}
    assert port_io.dumps_json(obj) == jax_io.dumps_json(obj)
    assert port_io.loads_json(port_io.dumps_json(obj)) == \
        jax_io.loads_json(jax_io.dumps_json(obj))
    assert port_io.dumps_json(obj, indent=None, sort_keys=False) == \
        jax_io.dumps_json(obj, indent=None, sort_keys=False)


def test_recursive_transform():
    tree = {'x': {'u': 'a.wav', 'v': 'b.wav'}, 'y': ['c.wav'], 'z': ('d',)}
    starts = {'x': {'u': 1, 'v': 2}, 'y': [3], 'z': 4}
    fn = lambda p, s: f'{p}@{s}'   # noqa: E731
    got = port_io.recursive_transform(fn, tree, starts)
    assert got == jax_io.recursive_transform(fn, tree, starts)
    assert got['x'] == {'u': 'a.wav@1', 'v': 'b.wav@2'}


def test_mkdir_symlink(tmp_path):
    d = tmp_path / 'a' / 'b'
    port_io.mkdir_p(d)
    port_io.mkdir_p(d)
    assert d.is_dir()
    target = tmp_path / 'target'
    target.write_text('x')
    link = tmp_path / 'link'
    port_io.symlink(target, link)
    port_io.symlink(target, link)      # idempotent
    assert link.read_text() == 'x'
    other = tmp_path / 'other'
    for io in PACKAGES.values():
        with pytest.raises(FileExistsError):
            io.symlink(other, link)
    port_io.symlink(other, link, override=True)
    assert link.resolve() == other.resolve()


def raised(fn):
    try:
        fn()
    except Exception as e:     # the type and message are compared
        return type(e), str(e)
    raise AssertionError('no error raised')


def same_error(path, expected, match, monkeypatch):
    """The port's reader raises ``expected`` with ``match`` in its text,
    and on the route the JAX package's reader takes (native where its
    extension is built, else Python) the same type and text as JAX's."""
    got = raised(lambda: port_io.load_audio(path))
    assert got[0] is expected and match in got[1]
    if not jax_audio.HAVE_NATIVE:
        monkeypatch.setattr(port_audio, '_native_read', port_audio._py_read)
        got = raised(lambda: port_io.load_audio(path))
    want = raised(lambda: jax_io.load_audio(path))
    assert got[0] is want[0] is expected
    assert match in got[1] and got[1] == want[1]


def test_nist_sphere_diagnostic(tmp_path):
    sph = tmp_path / 'fake.wav'
    sph.write_bytes(b'NIST_1A\n   1024\nsample_rate -i 16000\nend_head\n')
    got = raised(lambda: port_io.load_audio(sph))
    assert got[0] is RuntimeError and 'NIST SPHERE' in got[1]
    assert raised(lambda: jax_io.load_audio(sph))[0] is RuntimeError


def test_wrong_suffix_diagnostic(tmp_path, monkeypatch):
    bad = tmp_path / 'fake.flac'
    bad.write_bytes(b'fLaC....')
    same_error(bad, RuntimeError, 'Wrong suffix .flac', monkeypatch)


def test_legacy_audioread(tmp_path):
    sig = np.linspace(-0.5, 0.5, 32000)
    paths = both(tmp_path, lambda io, f: io.dump_audio(
        sig, f, sample_rate=16000, normalize=False))
    out, rate = port_audio.audioread(paths['port'], offset=0.5, duration=1.0)
    want, want_rate = jax_audio.audioread(paths['port'], offset=0.5,
                                          duration=1.0)
    assert rate == want_rate == 16000
    assert out.dtype == np.float32 and out.shape == (16000,)
    np.testing.assert_array_equal(out, want)
    with pytest.raises(ValueError, match='Requested sampling rate'):
        port_audio.audioread(paths['port'], expected_sample_rate=8000)


def test_truncated_fmt_chunk_diagnostic(tmp_path, monkeypatch):
    bad = tmp_path / 'cut.wav'
    bad.write_bytes(b'RIFF' + struct.pack('<I', 100) + b'WAVE'
                    + b'fmt ' + struct.pack('<I', 16) + b'\x01\x00')
    same_error(bad, ValueError, 'truncated fmt chunk', monkeypatch)


def test_truncated_extensible_fmt_chunk_diagnostic(tmp_path, monkeypatch):
    bad = tmp_path / 'cut_ext.wav'
    fmt16 = struct.pack('<HHIIHH', 0xFFFE, 1, 16000, 32000, 2, 16)
    bad.write_bytes(b'RIFF' + struct.pack('<I', 100) + b'WAVE'
                    + b'fmt ' + struct.pack('<I', 40) + fmt16 + b'\x00' * 4)
    same_error(bad, ValueError, 'truncated fmt chunk', monkeypatch)
