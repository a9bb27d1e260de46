"""The port's native host readers (``csrc/wav_ops.cpp``,
``csrc/interval_ops.cpp``, built by ``ops/kernels/_build.py`` with the
host compiler) against the JAX package's own extensions, compiled here
from ``cpp/`` into a temporary directory and loaded as CPython modules
(nothing is written into the JAX package), and against both packages'
Python routes.  Every comparison is exact: the same bytes, the same
tuples, the same error type and text.

Where the two JAX routes differ (a data chunk cut inside a frame; the
lax ``std::stoll`` parse of ``'1:4x'``, ``'1:4:5'`` and ``''``), each port
route is held to its JAX counterpart.  The one deviation: an ``fmt ``
chunk shorter than 16 bytes raises on the port's native reader, as on
both Python readers; JAX's native reader reads past what it read there,
so it is not run on that file.
"""

import errno
import faulthandler
import importlib.machinery
import importlib.util
import os
import shutil
import struct
import subprocess
import sysconfig
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from pb_chime5_tpu.io import audio as jax_audio, wav as jax_wav
from pb_chime5_tpu.utils import array_interval as jax_ai
from pb_chime5_tpu_torch.io import audio as port_audio, wav as port_wav
from pb_chime5_tpu_torch.models.gss import GssPipeline
from pb_chime5_tpu_torch.ops.kernels import _build
from pb_chime5_tpu_torch.utils import array_interval as port_ai

REPO = Path(__file__).resolve().parents[1]
JAX_SOURCES = {'_wav_ops': REPO / 'cpp' / 'wav_ops.cpp',
               '_interval_ops': REPO / 'cpp' / 'interval_ops.cpp'}


@pytest.fixture(scope='module')
def jax_native(tmp_path_factory):
    """{'_wav_ops': module, '_interval_ops': module}: the JAX package's
    extensions built from ``cpp/`` with its flags (setup.py)."""
    cxx = os.environ.get('CXX') or shutil.which('c++') or shutil.which('g++')
    include = Path(sysconfig.get_paths()['include'])
    if not cxx:
        pytest.skip('no host C++ compiler (c++ / g++ / $CXX) for the JAX '
                    'extensions')
    if not (include / 'Python.h').exists():
        pytest.skip(f'no Python.h under {include} for the JAX extensions')
    out = tmp_path_factory.mktemp('jax_native')
    suffix = importlib.machinery.EXTENSION_SUFFIXES[0]
    builds = {name: (out / f'{name}{suffix}', subprocess.Popen(
        [*cxx.split(), '-O3', '-std=c++17', '-shared', '-fPIC',
         f'-I{include}', '-o', str(out / f'{name}{suffix}'), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
        for name, source in JAX_SOURCES.items()}
    modules = {}
    for name, (path, proc) in builds.items():
        log = proc.communicate(timeout=300)[0].decode()
        assert proc.returncode == 0, log
        loader = importlib.machinery.ExtensionFileLoader(name, str(path))
        spec = importlib.util.spec_from_file_location(name, path,
                                                      loader=loader)
        modules[name] = importlib.util.module_from_spec(spec)
        loader.exec_module(modules[name])
    return modules


# ------------------------------------------------------------------ reads --

FORMATS = {'int16': (1, 16), 'int32': (1, 32), 'float32': (3, 32),
           'float64': (3, 64)}
FRAMES = 300
SEGMENTS = {'[0, n)': (0, FRAMES), '[17, 230)': (17, 230),
            'stop=None': (5, None), 'start > frames': (FRAMES + 9, None),
            'stop < start': (200, 100), 'stop > frames': (250, FRAMES + 77)}


def seeded_frames(dtype, channels, frames=FRAMES, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == 'i':
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, (frames, channels),
                            dtype=dtype, endpoint=True)
    return rng.standard_normal((frames, channels)).astype(dtype)


def wav_bytes(data, fmt, bits, *, extensible=False, list_chunk=False,
              rate=16000, fmt_size=None):
    """A RIFF/WAVE file of ``data`` ((frames, channels)): a plain or
    ``WAVE_FORMAT_EXTENSIBLE`` 40-byte ``fmt ``, an odd-sized ``LIST``
    chunk (with its pad byte) before ``data`` when asked; ``fmt_size``
    cuts the ``fmt `` chunk to that many bytes."""
    channels = data.shape[1]
    block = channels * bits // 8
    fields = struct.pack('<HHIIHH', 0xFFFE if extensible else fmt, channels,
                         rate, rate * block, block, bits)
    if extensible:   # cbSize, valid bits, channel mask, sub-format GUID
        fields += struct.pack('<HHIH', 22, bits, 0, fmt) + b'\x71' * 14
    if fmt_size is not None:
        fields = fields[:fmt_size]
    body = b'WAVE' + b'fmt ' + struct.pack('<I', len(fields)) + fields
    if list_chunk:
        body += b'LIST' + struct.pack('<I', 7) + b'INFOabc' + b'\0'
    raw = data.tobytes()
    body += b'data' + struct.pack('<I', len(raw)) + raw
    return b'RIFF' + struct.pack('<I', len(body)) + body


def route_reads(jax_native, monkeypatch):
    """{route: read(path, start, stop) -> (array, sample_rate)}: the port's
    native and Python routes, JAX's Python and native routes."""
    def jax_native_read(path, start, stop):
        with monkeypatch.context() as m:
            m.setattr(jax_audio, '_wav_ops', jax_native['_wav_ops'])
            return jax_audio._read(path, start, stop)
    return {'port native': port_audio._read,
            'port Python': port_audio._py_read,
            'JAX Python': jax_wav.read_wav,
            'JAX native': jax_native_read}


def assert_same(results):
    (_, (want, want_rate)), *rest = results.items()
    for route, (got, rate) in rest:
        assert got.dtype == want.dtype and got.shape == want.shape, route
        assert got.tobytes() == want.tobytes() and rate == want_rate, route


@pytest.mark.parametrize('layout', ['plain', 'extensible', 'plain + LIST',
                                    'extensible + LIST'])
@pytest.mark.parametrize('channels', [1, 24])
@pytest.mark.parametrize('dtype', list(FORMATS))
def test_four_routes_read_the_same(jax_native, monkeypatch, tmp_path, dtype,
                                   channels, layout):
    data = seeded_frames(dtype, channels)
    path = tmp_path / 'x.wav'
    path.write_bytes(wav_bytes(data, *FORMATS[dtype],
                               extensible=layout.startswith('extensible'),
                               list_chunk=layout.endswith('LIST')))
    reads = route_reads(jax_native, monkeypatch)
    for name, (start, stop) in SEGMENTS.items():
        results = {route: read(path, start, stop)
                   for route, read in reads.items()}
        assert_same(results)
        want = data[min(start, FRAMES):stop]
        got = results['port native'][0]
        assert got.tobytes() == want.tobytes(), name
        assert got.shape == (want[:, 0] if channels == 1 else want).shape


# ----------------------------------------------------------------- writes --

def write_routes(jax_native, monkeypatch):
    """{route: dump(obj, path, **kw)}: ``dump_audio`` by the port's native
    and Python writers and by JAX's native writer."""
    def port_python(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(port_audio, '_native_write',
                      lambda path, data, rate: port_wav.write_wav(
                          path, data, rate))
            return port_audio.dump_audio(*args, **kw)

    def jax_native_dump(*args, **kw):
        with monkeypatch.context() as m:
            m.setattr(jax_audio, '_wav_ops', jax_native['_wav_ops'])
            return jax_audio.dump_audio(*args, **kw)
    return {'port native': port_audio.dump_audio, 'port Python': port_python,
            'JAX native': jax_native_dump}


@pytest.mark.parametrize('channels', [1, 24])
@pytest.mark.parametrize('source,kw', [
    ('float64', {}),                                       # int16, peak 1
    ('int16', {'normalize': False}),
    ('float64', {'dtype': np.int32, 'normalize': False}),
    ('float32', {'dtype': None, 'normalize': False}),
    ('float64', {'dtype': np.float64, 'normalize': False}),
], ids=['normalized', 'int16', 'int32', 'float32', 'float64'])
def test_writers_write_the_same_bytes(jax_native, monkeypatch, tmp_path,
                                      source, kw, channels):
    obj = seeded_frames(source, channels, frames=400, seed=1).T
    if source.startswith('float'):
        obj = obj * 0.2
    obj = obj[0] if channels == 1 else obj
    files = {}
    for route, dump in write_routes(jax_native, monkeypatch).items():
        files[route] = tmp_path / f'{route}.wav'
        dump(obj, files[route], sample_rate=8000, **kw)
    written = {route: f.read_bytes() for route, f in files.items()}
    assert len(set(written.values())) == 1, written.keys()


def test_incremental_writes_stay_on_the_python_writer(jax_native,
                                                      monkeypatch, tmp_path):
    monkeypatch.setattr(jax_audio, '_wav_ops', jax_native['_wav_ops'])

    def refuse(*args):
        raise AssertionError('an incremental write went to the native '
                             'writer')
    monkeypatch.setattr(port_audio, '_native_write', refuse)
    chunks = seeded_frames(np.int16, 3, frames=500, seed=2).T
    for name, io in (('port', port_audio), ('jax', jax_audio)):
        path = tmp_path / f'{name}.wav'
        io.dump_audio(chunks[:, :200], path, start=100, normalize=False)
        io.dump_audio(chunks[:, 200:], path, start=300, normalize=False)
    assert (tmp_path / 'port.wav').read_bytes() == \
        (tmp_path / 'jax.wav').read_bytes()


# ------------------------------------------------------- divergent inputs --

def raised(fn):
    try:
        fn()
    except Exception as e:     # the type and message are compared
        return type(e), str(e)
    raise AssertionError('no error raised')


def test_data_cut_inside_a_frame(jax_native, monkeypatch, tmp_path):
    """The native readers shrink a data chunk cut inside a frame to whole
    frames (port = JAX); the Python readers fail in ``frombuffer`` /
    ``reshape`` (port = JAX)."""
    data = seeded_frames(np.int16, 24, seed=3)
    path = tmp_path / 'cut.wav'
    path.write_bytes(wav_bytes(data, 1, 16)[:-17])     # 17 bytes into a frame
    reads = route_reads(jax_native, monkeypatch)
    for start, stop in SEGMENTS.values():
        native = {route: reads[route](path, start, stop)
                  for route in ('port native', 'JAX native')}
        assert_same(native)
        assert native['port native'][0].tobytes() == \
            data[:FRAMES - 1][min(start, FRAMES):stop].tobytes()
    assert raised(lambda: port_audio._py_read(path, 0, None)) == \
        raised(lambda: jax_wav.read_wav(path, 0, None))
    assert raised(lambda: port_audio._py_read(path, 0, None))[0] is ValueError


def malformed_wav(case):
    """(file name, bytes) of a file each reader refuses."""
    fmt16 = struct.pack('<HHIIHH', 1, 2, 16000, 64000, 4, 16)
    fmt = b'fmt ' + struct.pack('<I', 16) + fmt16
    data = b'data' + struct.pack('<I', 8) + bytes(range(8))
    riff = b'RIFF' + struct.pack('<I', 100) + b'WAVE'
    ext = struct.pack('<HHIIHH', 0xFFFE, 1, 16000, 32000, 2, 16)
    return {
        'not RIFF': ('x.wav', b'RIFX' + bytes(40)),
        'not WAVE': ('x.wav', b'RIFF' + struct.pack('<I', 4) + b'AVI '),
        'empty': ('x.wav', b''),
        'no data chunk': ('x.wav', riff + fmt),
        'data before fmt': ('x.wav', riff + data + fmt),
        'extensible fmt cut at 20 bytes': (
            'x.wav', riff + b'fmt ' + struct.pack('<I', 40) + ext
            + b'\x00' * 4),
        'wrong suffix': ('x.flac', b'fLaC' + bytes(40)),
        'missing file': ('missing.wav', None),
    }[case]


@pytest.mark.parametrize('case', [
    'not RIFF', 'not WAVE', 'empty', 'no data chunk', 'data before fmt',
    'extensible fmt cut at 20 bytes', 'wrong suffix', 'missing file'])
def test_native_errors_match_jax_native(jax_native, monkeypatch, tmp_path,
                                        case):
    """The default (native) read route raises JAX's native route's error
    type and text, through ``load_audio`` as well."""
    from pb_chime5_tpu.io import load_audio as jax_load
    from pb_chime5_tpu_torch.io import load_audio as port_load
    name, raw = malformed_wav(case)
    path = tmp_path / name
    if raw is not None:
        path.write_bytes(raw)
    got = [raised(lambda: port_audio._read(path, 0, None)),
           raised(lambda: port_load(path))]
    with monkeypatch.context() as m:
        m.setattr(jax_audio, '_wav_ops', jax_native['_wav_ops'])
        want = [raised(lambda: jax_audio._read(path, 0, None)),
                raised(lambda: jax_load(path))]
    assert got == want
    assert got[0][0] is {'wrong suffix': RuntimeError,
                         'missing file': FileNotFoundError}.get(case,
                                                                ValueError)


def test_short_fmt_chunk_raises(tmp_path):
    """The deviation: a 14-byte ``fmt `` chunk raises ``ValueError`` on the
    port's native reader, as on both Python readers."""
    path = tmp_path / 'short_fmt.wav'
    path.write_bytes(wav_bytes(seeded_frames(np.int16, 2), 1, 16,
                               fmt_size=14))
    for read in (port_audio._read, port_audio._py_read, jax_wav.read_wav):
        kind, text = raised(lambda: read(path, 0, None))
        assert kind is ValueError and 'truncated fmt chunk' in text


@pytest.mark.parametrize('text', ['1:4x', '1:4:5', ''])
def test_lax_interval_strings(jax_native, monkeypatch, text):
    """``add_intervals_from_str`` on the strings the two JAX parsers read
    differently: the port's native route = JAX's native route, the port's
    Python route = JAX's Python route."""
    def outcome(module):
        track = module.ArrayInterval(100)
        try:
            track.add_intervals_from_str(text)
        except Exception as e:
            return type(e), str(e)
        return track.normalized_intervals

    ops = jax_native['_interval_ops']
    native = outcome(port_ai)
    with monkeypatch.context() as m:
        m.setattr(jax_ai, '_str_to_intervals', ops.str_to_intervals)
        m.setattr(jax_ai, '_normalize', ops.normalize)
        assert native == outcome(jax_ai)
    assert native == {'1:4x': ((1, 4),), '1:4:5': ((1, 4),), '': ()}[text]
    python = []
    for module in (port_ai, jax_ai):
        with monkeypatch.context() as m:
            m.setattr(module, '_str_to_intervals',
                      module._py_str_to_intervals)
            m.setattr(module, '_normalize', module._py_normalize)
            python.append(outcome(module))
    assert python[0] == python[1] and python[0][0] is ValueError


# ---------------------------------------------------------- interval ops --

def random_intervals(rng):
    """Up to 12 intervals over [-20, 60): empty lists, touching, nested,
    repeated and zero-length intervals, stops below starts."""
    n = int(rng.integers(0, 13))
    out = []
    for _ in range(n):
        s = int(rng.integers(-20, 60))
        kind = rng.integers(5)
        if kind == 0:
            e = s                                   # zero length
        elif kind == 1 and out:
            s = out[-1][1]                          # touching the last
            e = s + int(rng.integers(1, 9))
        elif kind == 2 and out:
            s, e = out[-1][0], out[-1][1]           # nested / repeated
            if e - s > 2:
                s, e = s + 1, e - 1
        elif kind == 3:
            e = s - int(rng.integers(1, 5))         # stop below start
        else:
            e = s + int(rng.integers(1, 25))
        out.append((s, e))
    return tuple(out)


def op_cases(op):
    rng = np.random.default_rng(11)
    for _ in range(200):
        ivs = random_intervals(rng)
        interval = tuple(sorted(int(v) for v in rng.integers(-25, 65, 2)))
        if op == 'normalize':
            yield (ivs,)
        elif op == 'str_to_intervals':
            yield (', '.join(f'{s}:{e}' for s, e in ivs)
                   + ',' * int(rng.integers(0, 3)),)
        else:
            yield interval, ivs


@pytest.mark.parametrize('op', ['intersection', 'non_intersection',
                                'normalize', 'str_to_intervals'])
def test_interval_ops_agree(jax_native, op):
    routes = (getattr(port_ai, f'_{op}'), getattr(port_ai, f'_py_{op}'),
              getattr(jax_ai, f'_py_{op}'),
              getattr(jax_native['_interval_ops'], op))
    for args in op_cases(op):
        if op == 'str_to_intervals' and not args[0].strip(','):
            continue          # '' parses only natively (test_lax_...)
        results = [route(*args) for route in routes]
        assert all(r == results[0] for r in results), (args, results)
        assert all(type(r) is tuple and all(type(p) is tuple for p in r)
                   for r in results[:1])


@pytest.mark.parametrize('text', ['1:2, x:3', '5', '1:', ':2', '1:2,,3:4',
                                  '99999999999999999999:1', '1-3'])
def test_bad_token_text_matches_jax_native(jax_native, text):
    got = raised(lambda: port_ai._str_to_intervals(text))
    want = raised(lambda: jax_native['_interval_ops'].str_to_intervals(text))
    assert got == want and got == (ValueError,
                                   f'bad interval token in {text}')


# ------------------------------------------------------------------ build --

@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """``_build`` with an empty build directory, no library loaded and its
    own counts; the port's sources."""
    monkeypatch.setattr(_build, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_build, '_libraries', {})
    monkeypatch.setattr(_build, 'stats', {'builds': 0, 'loads': 0})
    return tmp_path


def test_second_load_builds_nothing(fresh_build, monkeypatch):
    _build.load_libraries(_build.HOST_LIBRARIES)
    assert _build.stats == {'builds': 2, 'loads': 2}
    _build.load_libraries(_build.HOST_LIBRARIES)
    assert _build.stats == {'builds': 2, 'loads': 2}
    monkeypatch.setattr(_build, '_libraries', {})    # as a new process
    _build.load_libraries(_build.HOST_LIBRARIES)
    assert _build.stats == {'builds': 2, 'loads': 4}
    assert 'build_seconds=' in _build.build_log('wav_ops')


def test_edited_source_builds_anew(fresh_build, monkeypatch):
    _build.load_libraries(_build.HOST_LIBRARIES)
    before = _build._library_path('wav_ops')
    csrc = fresh_build / 'csrc'
    csrc.mkdir()
    for name in _build.HOST_LIBRARIES:
        shutil.copy(_build.CSRC_DIR / f'{name}.cpp', csrc)
    with open(csrc / 'wav_ops.cpp', 'a') as f:
        f.write('// edited\n')
    monkeypatch.setattr(_build, 'CSRC_DIR', csrc)
    monkeypatch.setattr(_build, '_libraries', {})
    _build.load_libraries(_build.HOST_LIBRARIES)
    assert _build._library_path('wav_ops') != before
    assert _build.stats == {'builds': 3, 'loads': 4}


def test_failed_build_raises_with_its_log(fresh_build, monkeypatch):
    monkeypatch.setenv('CXX', 'false')
    with pytest.raises(RuntimeError) as info:
        _build.load_library('interval_ops')
    log = _build._library_path('interval_ops').with_suffix('.log')
    assert f'(log {log})' in str(info.value) and log.exists()
    assert 'interval_ops' not in _build._libraries


def test_interval_ops_keep_the_gil(fresh_build):
    """The interval algebra's calls are shorter than a hand-over of the
    GIL: its library is a ``ctypes.PyDLL``, whose calls keep it; the WAV
    reads and writes release it (a ``ctypes.CDLL``)."""
    import ctypes
    assert isinstance(_build.load_library('interval_ops'), ctypes.PyDLL)
    assert not isinstance(_build.load_library('wav_ops'), ctypes.PyDLL)


def test_warmup_loads_the_host_libraries(monkeypatch):
    """``GssPipeline.warmup`` loads the host readers on any device, so a
    session after it loads nothing (``_build.stats``)."""
    monkeypatch.setattr(_build, '_libraries', {})
    monkeypatch.setattr(_build, 'stats', {'builds': 0, 'loads': 0})
    GssPipeline._load_kernels(['cpu'])
    assert set(_build._libraries) == set(_build.HOST_LIBRARIES)
    assert _build.stats['loads'] == 2


# ---------------------------------------------------------------- threads --

def test_read_runs_while_another_thread_holds_the_gil(tmp_path):
    """``load_audio``'s read blocks in ``fopen`` on a FIFO until a writer
    opens it; this thread, holding the GIL, opens it and writes a WAV, which
    only works because the foreign call released the GIL, and is read whole
    only because the read opens the file once (a second open would wait for
    a writer that has gone).  A reader still waiting after 60 s is released
    with an empty stream, and a watchdog ends the process if that fails."""
    from pb_chime5_tpu_torch.io import load_audio
    data = seeded_frames(np.int16, 4, seed=4)
    raw = wav_bytes(data, 1, 16, list_chunk=True)
    fifo = tmp_path / 'fifo.wav'
    os.mkfifo(fifo)
    result = {}

    def reader():
        try:
            result['read'] = load_audio(fifo, dtype=None)
        except Exception as e:
            result['error'] = e

    def open_writer():
        while True:
            try:
                return os.open(fifo, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:   # ENXIO: no reader has opened it yet
                assert e.errno == errno.ENXIO and thread.is_alive()
                time.sleep(0.001)
    faulthandler.dump_traceback_later(180, exit=True)
    try:
        thread = threading.Thread(target=reader, daemon=True)
        thread.start()
        fd = open_writer()
        try:
            os.set_blocking(fd, True)
            os.write(fd, raw)
        finally:
            os.close(fd)
        thread.join(timeout=60)
        if thread.is_alive():      # a second open waits for a writer
            os.close(open_writer())
            thread.join(timeout=60)
        assert not thread.is_alive()
    finally:
        faulthandler.cancel_dump_traceback_later()
    assert 'error' not in result, result['error']
    assert result['read'].tobytes() == data.T.tobytes()


def test_native_routes_are_the_default(monkeypatch, tmp_path):
    """``HAVE_NATIVE`` is true, ``load_audio`` reads through the native
    reader and ``ArrayInterval`` edits through the native algebra: no
    Python fallback is selected."""
    from pb_chime5_tpu_torch.io import load_audio
    assert port_audio.HAVE_NATIVE and port_ai.HAVE_NATIVE
    assert 'HAVE_NATIVE' in port_audio.__all__
    assert 'HAVE_NATIVE' in port_ai.__all__
    calls = []
    for module, name in ((port_audio, '_native_read'),
                         (port_ai, '_non_intersection'),
                         (port_ai, '_normalize'), (port_ai, '_intersection')):
        real = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _real=real, _name=name:
                            calls.append(_name) or _real(*a))
    path = tmp_path / 'x.wav'
    path.write_bytes(wav_bytes(seeded_frames(np.int16, 2), 1, 16))
    load_audio(path, start=3, stop=9)
    track = port_ai.ArrayInterval(50)
    track[5:20] = 1
    track[8:9] = 0
    track[0:50]
    assert calls == ['_native_read', '_normalize', '_non_intersection',
                     '_normalize', '_intersection']
