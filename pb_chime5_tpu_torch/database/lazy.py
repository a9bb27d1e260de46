"""Lazy functional dataset pipeline over example dicts.

Replaces the external ``lazy_dataset`` dependency with the subset of its
API the front-end uses (reference call sites:
pb_chime5/database/__init__.py:221-228, database/chime5/database.py:96-130,
activity.py:107, core.py:371-381):

* ``from_dict`` / ``concatenate``
* ``map`` (lazy), ``filter`` (lazy or eager), ``groupby``
* indexing by position, example id, slice, or tuple/list of ids/positions
* ``keys``, ``len``, iteration

Examples are deep-copied on access so downstream in-place mutation (the
reference's transforms mutate the example dicts) never leaks between
iterations.

The port's copy of ``pb_chime5_tpu/database/lazy.py``.
"""

import copy

__all__ = ['LazyDataset', 'from_dict', 'concatenate']


class LazyDataset:
    """An ordered, keyed, lazily-transformed collection of example dicts."""

    def __init__(self, examples: dict, transforms=()):
        self._examples = examples
        self._keys = tuple(examples.keys())
        self._transforms = tuple(transforms)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_dict(cls, examples: dict):
        return cls(examples)

    def _with(self, transform):
        return LazyDataset(self._examples,
                           self._transforms + (transform,))

    # -- core access -------------------------------------------------------

    def _evaluate(self, key):
        ex = copy.deepcopy(self._examples[key])
        for t in self._transforms:
            ex = t(ex)
        return ex

    def keys(self):
        return self._keys

    def __len__(self):
        return len(self._keys)

    def __iter__(self):
        for k in self._keys:
            yield self._evaluate(k)

    def __getitem__(self, item):
        if isinstance(item, str):
            return self._evaluate(item)
        if isinstance(item, int):
            return self._evaluate(self._keys[item])
        if isinstance(item, slice):
            sub = {k: self._examples[k] for k in self._keys[item]}
            return LazyDataset(sub, self._transforms)
        if isinstance(item, (tuple, list)):
            sub = {}
            for i in item:
                k = i if isinstance(i, str) else self._keys[i]
                sub[k] = self._examples[k]
            return LazyDataset(sub, self._transforms)
        raise TypeError(item)

    # -- functional ops ----------------------------------------------------

    def map(self, fn):
        return self._with(fn)

    def filter(self, predicate, lazy=True):
        """Lazy filtering is not supported (it would break ``len`` and
        positional indexing, exactly like in lazy_dataset); the reference
        always passes ``lazy=False`` (database/chime5/database.py:99)."""
        if lazy:
            raise NotImplementedError(
                'lazy filtering breaks len/indexing; use lazy=False')
        kept = {k: self._examples[k] for k in self._keys
                if predicate(self._evaluate(k))}
        return LazyDataset(kept, self._transforms)

    def groupby(self, key_fn):
        groups = {}
        for k in self._keys:
            groups.setdefault(key_fn(self._evaluate(k)), []).append(k)
        return {
            g: LazyDataset({k: self._examples[k] for k in ks},
                           self._transforms)
            for g, ks in groups.items()
        }

    def sort(self, key_fn):
        order = sorted(self._keys, key=lambda k: key_fn(self._evaluate(k)))
        return LazyDataset({k: self._examples[k] for k in order},
                           self._transforms)

    def __repr__(self):
        return (f'{type(self).__name__}(len={len(self)}, '
                f'transforms={len(self._transforms)})')


from_dict = LazyDataset.from_dict


def concatenate(*datasets):
    if len(datasets) == 1 and isinstance(datasets[0], (list, tuple)):
        datasets = tuple(datasets[0])
    if len(datasets) == 1:
        return datasets[0]
    merged = {}
    transforms = datasets[0]._transforms
    for ds in datasets:
        assert ds._transforms == transforms, \
            'can only concatenate datasets with identical transforms'
        overlap = merged.keys() & ds._examples.keys()
        assert not overlap, f'duplicate example ids: {sorted(overlap)[:5]}'
        merged.update({k: ds._examples[k] for k in ds._keys})
    return LazyDataset(merged, transforms)
