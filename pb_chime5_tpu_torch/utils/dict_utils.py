"""Small dict helpers — the port of ``pb_chime5_tpu/utils/dict_utils.py``
(reference pb_chime5/mapping.py:1-10, pb_chime5/utils/dict_utils.py)."""

__all__ = ['Dispatcher', 'merge']


class Dispatcher(dict):
    """A dict whose KeyError lists the available keys."""

    def __getitem__(self, item):
        try:
            return super().__getitem__(item)
        except KeyError:
            raise KeyError(
                f'Invalid option {item!r}. Possible keys are '
                f'{tuple(self.keys())!r}.') from None


def merge(*dicts):
    """Merge dicts with disjoint keys; conflicting keys raise."""
    out = {}
    for d in dicts:
        overlap = out.keys() & d.keys()
        assert not overlap, f'conflicting keys: {sorted(overlap)}'
        out.update(d)
    return out
