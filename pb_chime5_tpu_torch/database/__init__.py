"""JSON-backed example database -> lazily transformed example sequences.

The part of ``pb_chime5_tpu.database`` (``DictDatabase``,
``JsonDatabase``, ``lazy.LazyDataset``) that the session loops use.  A database JSON has
the shape ``{"datasets": {name: {example_id: {...}}}, "alias": {name:
[names]}}``; ``get_datasets`` returns a :class:`LazyDataset` over one or
more (possibly aliased) datasets, with ``example_id`` and ``dataset``
keys injected.
"""

import copy
from pathlib import Path

from pb_chime5_tpu_torch.io import load_json

__all__ = ['LazyDataset', 'DictDatabase', 'JsonDatabase']


class LazyDataset:
    """An ordered, keyed collection of example dicts with lazily applied
    transforms.  Each access deep-copies the stored example, so the
    transforms' in-place edits never leak between accesses."""

    def __init__(self, examples: dict, transforms=()):
        self._examples = examples
        self._keys = tuple(examples.keys())
        self._transforms = tuple(transforms)

    def _evaluate(self, key):
        ex = copy.deepcopy(self._examples[key])
        for t in self._transforms:
            ex = t(ex)
        return ex

    def __len__(self):
        return len(self._keys)

    def keys(self):
        return self._keys

    def __iter__(self):
        for k in self._keys:
            yield self._evaluate(k)

    def __getitem__(self, item):
        if isinstance(item, str):
            return self._evaluate(item)
        if isinstance(item, slice):
            return LazyDataset(
                {k: self._examples[k] for k in self._keys[item]},
                self._transforms)
        raise TypeError(item)

    def map(self, fn):
        return LazyDataset(self._examples, self._transforms + (fn,))

    def filter(self, predicate):
        """Eager: keeps ``len`` and positional indexing."""
        return LazyDataset({k: self._examples[k] for k in self._keys
                            if predicate(self._evaluate(k))},
                           self._transforms)

    def groupby(self, key_fn):
        groups = {}
        for k in self._keys:
            groups.setdefault(key_fn(self._evaluate(k)), {})[k] = \
                self._examples[k]
        return {g: LazyDataset(ex, self._transforms)
                for g, ex in groups.items()}


class DictDatabase:
    """Datasets of a database dict (the subclasses make it)."""

    def __init__(self, database_dict: dict):
        self._database_dict = database_dict

    @property
    def database_dict(self):
        return self._database_dict

    def _examples_for(self, name):
        db = self.database_dict
        names = db.get('alias', {}).get(name, [name])
        examples = {}
        for n in names:
            try:
                new = db['datasets'][n]
            except KeyError:
                raise KeyError(f'{n!r} is not a dataset of {self}') from None
            overlap = examples.keys() & new.keys()
            assert not overlap, sorted(overlap)[:5]
            examples.update(new)
        if not examples:
            raise RuntimeError(f'The requested dataset {name!r} is empty.')
        for example_id, example in examples.items():
            example['example_id'] = example_id
            example['dataset'] = name
        return examples

    def get_datasets(self, dataset_names):
        """One LazyDataset over the given dataset name(s)."""
        if isinstance(dataset_names, str):
            dataset_names = [dataset_names]
        examples = {}
        for name in dataset_names:
            new = self._examples_for(name)
            overlap = examples.keys() & new.keys()
            assert not overlap, f'duplicate example ids: {sorted(overlap)[:5]}'
            examples.update(new)
        return LazyDataset(examples)


class JsonDatabase(DictDatabase):
    def __init__(self, json_path):
        self._json_path = Path(json_path)
        self._loaded = None

    @property
    def database_dict(self):
        if self._loaded is None:
            self._loaded = load_json(self._json_path)
        return self._loaded

    def __repr__(self):
        return f'{type(self).__name__}({str(self._json_path)!r})'
