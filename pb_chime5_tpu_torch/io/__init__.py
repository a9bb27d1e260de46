"""Host I/O: audio, JSON, filesystem helpers.

Mirrors the reference's pb_chime5/io package surface.

The port's copy of ``pb_chime5_tpu/io/__init__.py``.
"""

import contextlib
import os
from pathlib import Path

import numpy as np

from pb_chime5_tpu_torch.io.audio import (
    load_audio as _load_audio_single, dump_audio, audio_length,
    audio_channels)
from pb_chime5_tpu_torch.io.json_io import (
    Encoder, SummaryEncoder, load_json, loads_json, dump_json,
    dumps_json)

__all__ = [
    'load_audio', 'dump_audio', 'audio_length', 'audio_channels',
    'load_json', 'loads_json', 'dump_json', 'dumps_json', 'Encoder',
    'SummaryEncoder',
    'mkdir_p', 'symlink', 'change_directory', 'recursive_transform',
]


def recursive_load_decorator(default_list_to='list'):
    """Make a loader map over nested dict/list path trees, stacking lists
    (reference io/load_decorator.py:4-50; the reference's public
    ``load_audio`` is the audio reader wrapped with
    ``default_list_to='array'`` so a CHiME array's 4 per-channel wav paths
    load as one (4, N) array)."""
    def decorator(func):
        def wrapper(path, *args, list_to=default_list_to, **kwargs):
            def self_call(p):
                return wrapper(p, *args, list_to=list_to, **kwargs)
            if isinstance(path, (list, tuple)):
                if list_to == 'dict':
                    return {f: self_call(f) for f in path}
                if list_to == 'array':
                    return np.array([self_call(f) for f in path])
                if list_to == 'list':
                    return [self_call(f) for f in path]
                raise ValueError(list_to)
            if isinstance(path, dict):
                return type(path)(
                    {k: self_call(v) for k, v in path.items()})
            return func(path, *args, **kwargs)
        return wrapper
    return decorator


load_audio = recursive_load_decorator(default_list_to='array')(
    _load_audio_single)


def mkdir_p(path):
    Path(path).expanduser().mkdir(parents=True, exist_ok=True)


def symlink(source, link_name, *, override=False):
    """Idempotent symlink (reference io/file_handling.py:24-80)."""
    link_name = Path(link_name).expanduser()
    source = Path(source)
    if link_name.is_symlink():
        if os.readlink(str(link_name)) == str(source):
            return
        if override:
            link_name.unlink()
        else:
            raise FileExistsError(
                f'{link_name} already points to '
                f'{os.readlink(str(link_name))}')
    link_name.symlink_to(source)


@contextlib.contextmanager
def change_directory(directory):
    cwd = os.getcwd()
    os.chdir(str(directory))
    try:
        yield
    finally:
        os.chdir(cwd)


def recursive_transform(func, tree, *parallel_trees):
    """Apply ``func`` to every leaf of a nested dict/list structure,
    zipping in parallel structures (reference io/load_decorator.py:4-50 and
    database.py recursive_transform)."""
    if isinstance(tree, dict):
        return {
            k: recursive_transform(
                func, v, *[p[k] if isinstance(p, dict) else p
                           for p in parallel_trees])
            for k, v in tree.items()
        }
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            recursive_transform(
                func, v,
                *[p[i] if isinstance(p, (list, tuple)) else p
                  for p in parallel_trees])
            for i, v in enumerate(tree)
        )
    return func(tree, *parallel_trees)
