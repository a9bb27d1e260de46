"""Host-side array utilities (reference: pb_chime5/utils/numpy_utils.py).

Includes the reference's ``morph`` reshape/transpose/reduce mini-DSL
(numpy_utils.py:662-707), used across the pipeline
(e.g. ``morph('ACTF->A*CTF', obs)`` core.py:439,
``morph('DTF->FT', mask, reduce=np.median)`` beamforming_wrapper.py:30),
plus ``pad_axis``, ``roll_zeropad``, ``labels_to_one_hot`` and the
``Cutter`` band mask.  ``segment_axis`` lives in
pb_chime5_tpu_torch.utils.activity_freq.

The port's copy of ``pb_chime5_tpu/utils/numpy_utils.py``.
"""

import numpy as np

from pb_chime5_tpu_torch.utils.activity_freq import segment_axis  # noqa: F401

__all__ = ['morph', 'pad_axis', 'roll_zeropad', 'labels_to_one_hot',
           'Cutter', 'segment_axis', 'tbf_to_tbchw', 'stack_context',
           'unstack_context', 'split_complex_features',
           'merge_complex_features', 'add_context']


def _parse_morph_side(side):
    """'A*CTF' -> groups [['A','C'],['T'],['F']] (letters merged by '*');
    '1' denotes a literal singleton axis."""
    groups = []
    letters = []
    i = 0
    while i < len(side):
        ch = side[i]
        if ch == '*':
            i += 1
            assert groups, side
            nxt = side[i]
            groups[-1].append(nxt)
            letters.append(nxt)
            i += 1
            continue
        groups.append([ch])
        letters.append(ch)
        i += 1
    return groups, letters


def morph(pattern, array, reduce=None, **axis_sizes):
    """Reshape/transpose/reduce DSL.

    >>> import numpy as np
    >>> morph('ACTF->A*CTF', np.zeros((2, 3, 4, 5))).shape
    (6, 4, 5)
    >>> morph('A*CTF->ACTF', np.zeros((6, 4, 5)), A=2).shape
    (2, 3, 4, 5)
    >>> morph('DTF->FT', np.zeros((3, 4, 5)), reduce=np.median).shape
    (5, 4)
    >>> morph('TF->FT', np.zeros((4, 5))).shape
    (5, 4)
    >>> morph('1DTF->FT', np.zeros((1, 3, 4, 5)), reduce=np.median).shape
    (5, 4)
    """
    array = np.asarray(array)
    src, dst = [s.strip() for s in pattern.split('->')]
    src_groups, src_letters = _parse_morph_side(src)
    dst_groups, dst_letters = _parse_morph_side(dst)

    # 1. split merged source groups using known axis sizes
    shape = []
    for dim, group in zip(array.shape, src_groups):
        if len(group) == 1:
            if group[0] == '1':
                assert dim == 1, (pattern, array.shape)
            shape.append((group[0], dim))
        else:
            known = {g: axis_sizes[g] for g in group if g in axis_sizes}
            unknown = [g for g in group if g not in axis_sizes]
            prod_known = int(np.prod(list(known.values()) or [1]))
            assert len(unknown) <= 1, (pattern, 'underdetermined split')
            sizes = []
            for g in group:
                if g in known:
                    sizes.append(known[g])
                else:
                    assert dim % prod_known == 0, (pattern, array.shape)
                    sizes.append(dim // prod_known)
            shape.extend(zip(group, sizes))
    array = array.reshape([s for _, s in shape])
    letters = [l for l, _ in shape]

    # 2. drop axes absent from the target: squeeze singletons ('1'),
    #    reduce the rest
    dst_set = set(dst_letters) - {'1'}
    keep, drop = [], []
    for idx, letter in enumerate(letters):
        (keep if letter in dst_set else drop).append(idx)
    if drop:
        squeezable = [i for i in drop if array.shape[i] == 1
                      and letters[i] == '1']
        real_drop = [i for i in drop if i not in squeezable]
        if squeezable:
            array = array.reshape([
                s for i, s in enumerate(array.shape)
                if i not in squeezable])
            letters = [l for i, l in enumerate(letters)
                       if i not in squeezable]
            keep = [letters.index(letters_keep)
                    for letters_keep in [letters[i] for i in range(
                        len(letters)) if letters[i] in dst_set]]
            real_drop = [i for i, l in enumerate(letters)
                         if l not in dst_set]
        if real_drop:
            assert reduce is not None, (
                f'{pattern}: axes {[letters[i] for i in real_drop]} are '
                f'dropped but no reduce function was given')
            array = reduce(array, axis=tuple(real_drop))
            letters = [l for i, l in enumerate(letters)
                       if i not in real_drop]

    # 3. transpose to target letter order
    flat_dst = [l for l in dst_letters if l != '1']
    order = [letters.index(l) for l in flat_dst]
    array = np.transpose(array, order)

    # 4. merge target groups / insert singletons
    out_shape = []
    pos = 0
    for group in dst_groups:
        if group == ['1']:
            out_shape.append(1)
            continue
        size = 1
        for _ in group:
            size *= array.shape[pos]
            pos += 1
        out_shape.append(size)
    return array.reshape(out_shape)


def pad_axis(array, pad_width, axis=-1, mode='constant', **kwargs):
    """np.pad on a single axis (reference numpy_utils.py:496)."""
    array = np.asarray(array)
    if isinstance(pad_width, int):
        pad_width = (pad_width, pad_width)
    npad = [(0, 0)] * array.ndim
    npad[axis] = pad_width
    return np.pad(array, npad, mode=mode, **kwargs)


def roll_zeropad(a, shift, axis=None):
    """np.roll that shifts in zeros instead of wrapping
    (reference numpy_utils.py:733)."""
    a = np.asarray(a)
    if shift == 0:
        return a.copy()
    if axis is None:
        flat = roll_zeropad(a.ravel(), shift, axis=0)
        return flat.reshape(a.shape)
    out = np.zeros_like(a)
    idx_src = [slice(None)] * a.ndim
    idx_dst = [slice(None)] * a.ndim
    if shift > 0:
        idx_src[axis] = slice(0, a.shape[axis] - shift)
        idx_dst[axis] = slice(shift, None)
    else:
        idx_src[axis] = slice(-shift, None)
        idx_dst[axis] = slice(0, a.shape[axis] + shift)
    if a.shape[axis] > abs(shift):
        out[tuple(idx_dst)] = a[tuple(idx_src)]
    return out


def labels_to_one_hot(labels, categories, axis=0, keepdims=False,
                      dtype=bool):
    """Integer labels -> one-hot (reference numpy_utils.py:828)."""
    labels = np.asarray(labels)
    one_hot = np.eye(categories, dtype=dtype)[labels]
    # move the new category axis where requested
    one_hot = np.moveaxis(one_hot, -1, axis)
    if keepdims:
        one_hot = np.expand_dims(one_hot, axis + 1 if axis >= 0 else axis)
    return one_hot


class Cutter:
    """Low/high frequency band masking for mask post-processing
    (reference numpy_utils.py:873-922): keep bins in [low_cut, high_cut),
    zero outside; ``overwrite(mask, value)`` sets the outside region to a
    constant instead."""

    def __init__(self, low_cut=0, high_cut=None):
        self.low_cut = low_cut
        self.high_cut = high_cut

    def _region(self, num_bins):
        high = num_bins if self.high_cut is None else self.high_cut
        inside = np.zeros(num_bins, bool)
        inside[self.low_cut:high] = True
        return inside

    def cut(self, mask, axis=-1):
        mask = np.asarray(mask)
        inside = self._region(mask.shape[axis])
        shape = [1] * mask.ndim
        shape[axis] = -1
        return mask * inside.reshape(shape)

    __call__ = cut

    def overwrite(self, mask, value, axis=-1):
        mask = np.array(mask, copy=True)
        inside = self._region(mask.shape[axis])
        idx = [slice(None)] * mask.ndim
        idx[axis] = ~inside
        mask[tuple(idx)] = value
        return mask


# ---------------------------------------------------------------------------
# NN-feature context stacking (reference numpy_utils.py:374-479).  Used by
# neural acoustic-model front-ends trained in frames mode; kept for API
# completeness of the utils layer.

def tbf_to_tbchw(x, left_context, right_context, step_width,
                 pad_mode='symmetric', pad_kwargs=None):
    """(T, B, F) features -> (T', B, C=1, H=F, W=window) convolution
    layout with +-context frames as the filter width
    (reference numpy_utils.py:448-479).

    The time axis is padded ``(left_context, right_context)`` with
    ``pad_mode`` and framed into windows of ``left + 1 + right`` frames
    advancing by ``step_width``.
    """
    x = np.asarray(x)
    x = np.pad(x, ((left_context, right_context), (0, 0), (0, 0)),
               mode=pad_mode, **(pad_kwargs or {}))
    window = left_context + right_context + 1
    # (T', B, F, W) windows at stride step_width ('cut' tail semantics)
    win = np.lib.stride_tricks.sliding_window_view(
        x, window, axis=0)[::step_width]
    return win[:, :, None, :, :]


def stack_context(X, left_context=0, right_context=0, step_width=1):
    """Stack (T, B, F) features with symmetric-padded context frames
    concatenated along the feature axis, window-major:
    ``out[t, b] = [X[t-l, b], ..., X[t, b], ..., X[t+r, b]]``
    (reference numpy_utils.py:374-396).
    """
    tbchw = tbf_to_tbchw(X, left_context=left_context,
                         right_context=right_context,
                         step_width=step_width)
    # (T', B, F, W) -> (T', B, W, F) -> (T', B, W*F): window-major blocks
    win_major = tbchw[:, :, 0].transpose(0, 1, 3, 2)
    Tn, B, W, F = win_major.shape
    return np.ascontiguousarray(win_major).reshape(Tn, B, W * F)


def unstack_context(X, mode, left_context=0, right_context=0,
                    step_width=1):
    """Inverse of :func:`stack_context` for ``mode='center'``: return the
    center frame's feature block (reference numpy_utils.py:399-426; the
    reference forgets to ``raise`` on other modes — here it raises).
    """
    assert step_width == 1, step_width
    context_length = left_context + 1 + right_context
    assert X.shape[2] % context_length == 0, (X.shape, context_length)
    F = X.shape[2] // context_length
    if mode == 'center':
        return X[:, :, left_context * F:(left_context + 1) * F]
    raise NotImplementedError(
        'All other unstack methods are not yet implemented.')


def split_complex_features(X):
    """(T, B, F) complex -> (T, B, 2F) real: [real | imag]
    (reference numpy_utils.py:429-435)."""
    return np.concatenate((np.asarray(X.real), np.asarray(X.imag)),
                          axis=2)


def merge_complex_features(X):
    """(T, B, 2F) real [real | imag] -> (T, B, F) complex
    (reference numpy_utils.py:438-445)."""
    bins = X.shape[-1]
    return X[:, :, :bins // 2] + 1j * X[:, :, bins // 2:]


def add_context(data, left_context=0, right_context=0, step=1,
                cnn_features=False, deltas_as_channel=False,
                num_deltas=2, sequence_output=True):
    """Context-window frontend dispatcher (reference
    numpy_utils.py:710-729): dense stacking via :func:`stack_context`,
    or the convolutional (T, B, C, H, W) layout via
    :func:`tbf_to_tbchw` with zero padding — optionally splitting
    delta-feature blocks into channels, or flattening the batch axis
    for non-sequence outputs."""
    if cnn_features:
        data = tbf_to_tbchw(data, left_context, right_context, step,
                            pad_mode='constant',
                            pad_kwargs=dict(constant_values=(0,)))
        if deltas_as_channel:
            feature_size = data.shape[3] // (1 + num_deltas)
            data = np.concatenate(
                [data[:, :, :, i * feature_size:(i + 1) * feature_size, :]
                 for i in range(1 + num_deltas)], axis=2)
    else:
        data = stack_context(data, left_context=left_context,
                             right_context=right_context, step_width=step)
        if not sequence_output:
            data = np.concatenate(
                [data[:, i, ...].reshape((-1, data.shape[-1]))
                 for i in range(data.shape[1])], axis=0)
    return data
