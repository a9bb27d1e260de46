"""JSON load/dump with numpy / Path / datetime awareness
(reference: pb_chime5/io/json_module.py).

The port's copy of ``pb_chime5_tpu/io/json_io.py``.
"""

import datetime
import io
import json
from pathlib import Path

import numpy as np

__all__ = ['Encoder', 'SummaryEncoder', 'load_json', 'loads_json',
           'dump_json', 'dumps_json']


class Encoder(json.JSONEncoder):
    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, Path):
            return str(obj)
        if isinstance(obj, (datetime.datetime, datetime.date)):
            return obj.isoformat()
        return super().default(obj)


class SummaryEncoder(Encoder):
    """Summarize numpy arrays as 'ndarray: shape ..., dtype ...' instead
    of dumping their values (reference json_module.py:30-53)."""

    def default(self, obj):
        if isinstance(obj, np.ndarray):
            return f'ndarray: shape {obj.shape}, dtype {obj.dtype}'
        return super().default(obj)


def load_json(path):
    with open(Path(path).expanduser()) as f:
        return json.load(f)


def loads_json(text):
    return json.loads(text)


def dump_json(obj, path, *, indent=2, create_path=True, sort_keys=True,
              **kwargs):
    path = Path(path).expanduser()
    if create_path:
        path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, 'w') as f:
        json.dump(obj, f, cls=Encoder, indent=indent, sort_keys=sort_keys,
                  **kwargs)


def dumps_json(obj, *, indent=2, sort_keys=True, **kwargs):
    fd = io.StringIO()
    json.dump(obj, fd, cls=Encoder, indent=indent, sort_keys=sort_keys,
              **kwargs)
    return fd.getvalue()
