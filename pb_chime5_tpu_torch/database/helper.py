"""Database-building helpers (reference: pb_chime5/database/helper.py).

The port's copy of ``pb_chime5_tpu/database/helper.py``.
"""

import concurrent.futures
import os
from pathlib import Path

from pb_chime5_tpu_torch.database import keys
from pb_chime5_tpu_torch.io import dump_json

__all__ = ['flatten_with_key_paths', 'check_audio_files_exist',
           'dump_database_as_json']


def flatten_with_key_paths(tree, sep='/', prefix=''):
    """Nested dict/list -> {joined/key/path: leaf}
    (reference helper.py:13-50)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(flatten_with_key_paths(
                v, sep, f'{prefix}{sep}{k}' if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten_with_key_paths(
                v, sep, f'{prefix}{sep}{i}' if prefix else str(i)))
    else:
        out[prefix] = tree
    return out


def check_audio_files_exist(database_dict, speedup='thread'):
    """Assert every *.wav path referenced in the database exists
    (reference helper.py:53-125; threaded)."""
    paths = [
        v for k, v in flatten_with_key_paths(database_dict).items()
        if isinstance(v, str) and v.endswith('.wav')
        and keys.AUDIO_PATH in k
    ]
    if speedup == 'thread':
        with concurrent.futures.ThreadPoolExecutor(os.cpu_count()) as pool:
            exists = list(pool.map(lambda p: Path(p).exists(), paths))
    else:
        exists = [Path(p).exists() for p in paths]
    missing = [p for p, e in zip(paths, exists) if not e]
    assert not missing, f'missing audio files: {missing[:10]}'


def dump_database_as_json(filename, database_dict):
    """Write the database dict as JSON (reference helper.py:128-143)."""
    dump_json(database_dict, filename, indent=4, sort_keys=False)
