"""Database core: JSON-backed example databases -> lazy dataset pipelines.

Same capability as the reference's pb_chime5/database/__init__.py:109-249:
a database JSON has the shape ``{"datasets": {name: {example_id: {...}}},
"alias": {name: [names]}}``; ``get_datasets`` returns a LazyDataset over
one or more (possibly aliased) datasets with ``example_id`` and
``dataset`` keys injected.

The port's copy of ``pb_chime5_tpu/database/__init__.py``.
"""

import weakref
from pathlib import Path

from pb_chime5_tpu_torch.database import keys as K
from pb_chime5_tpu_torch.database.lazy import LazyDataset, concatenate
from pb_chime5_tpu_torch.io import load_json

__all__ = ['DictDatabase', 'JsonDatabase', 'to_list']


def to_list(x, item_type=None):
    if item_type is not None:
        return [x] if isinstance(x, item_type) else list(x)
    return x if isinstance(x, (list, tuple)) else [x]


class DictDatabase:
    def __init__(self, database_dict: dict):
        self._database_dict = database_dict
        self._dataset_cache = weakref.WeakValueDictionary()

    @property
    def database_dict(self):
        return self._database_dict

    @property
    def dataset_names(self):
        return tuple(self.database_dict[K.DATASETS].keys()) + tuple(
            self.database_dict.get(K.ALIAS, {}).keys())

    def _examples_for(self, dataset_name):
        alias = self.database_dict.get(K.ALIAS, {})
        if dataset_name in alias:
            examples = {}
            for name in alias[dataset_name]:
                new = self.database_dict[K.DATASETS][name]
                overlap = examples.keys() & new.keys()
                assert not overlap, sorted(overlap)[:5]
                examples.update(new)
            return examples
        return self.database_dict[K.DATASETS][dataset_name]

    def get_datasets(self, dataset_names, use_weakref=True):
        """One LazyDataset over the given dataset name(s)."""
        dataset_names = to_list(dataset_names, item_type=str)
        datasets = []
        for name in dataset_names:
            if use_weakref and name in self._dataset_cache:
                datasets.append(self._dataset_cache[name])
                continue
            try:
                examples = self._examples_for(name)
            except KeyError:
                import difflib
                similar = difflib.get_close_matches(
                    name, self.dataset_names, n=5, cutoff=0)
                raise KeyError(
                    name, f'close_matches: {similar}', self) from None
            if not examples:
                raise RuntimeError(
                    f'The requested dataset {name!r} is empty.')
            for example_id, example in examples.items():
                example[K.EXAMPLE_ID] = example_id
                example[K.DATASET_NAME] = name
            ds = LazyDataset.from_dict(examples)
            if use_weakref:
                self._dataset_cache[name] = ds
            datasets.append(ds)
        return concatenate(*datasets)

    def get_lengths(self, datasets, length_transform_fn=lambda x: x):
        it = self.get_datasets(datasets)
        lengths = {}
        for example in it:
            num_samples = example[K.NUM_SAMPLES]
            if isinstance(num_samples, dict):
                num_samples = num_samples[K.OBSERVATION]
            lengths[example[K.EXAMPLE_ID]] = length_transform_fn(num_samples)
        return lengths


class JsonDatabase(DictDatabase):
    def __init__(self, json_path):
        self._json_path = Path(json_path)
        self._loaded = None
        self._dataset_cache = weakref.WeakValueDictionary()

    @property
    def database_dict(self):
        if self._loaded is None:
            self._loaded = load_json(self._json_path)
        return self._loaded

    def __repr__(self):
        return f'{type(self).__name__}({str(self._json_path)!r})'
