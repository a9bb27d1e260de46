"""Unsupervised energy masks (optional beamformer front-ends) — port of
``pb_chime5_tpu/ops/masks.py`` (the capability of pb_bss
``mask_module.lorenz_mask`` / ``quantile_mask``, reference
wrapper:211-251):

* :func:`lorenz_mask`: along ``axis``, the bins that together carry the
  top ``lorenz_fraction`` of the total power are "speech"; the mask is a
  soft {weight, 1 - weight} assignment.
* :func:`quantile_mask`: for q >= 0 the loudest ``q`` fraction of bins
  along ``axis``, for q < 0 the quietest ``|q|`` fraction; a list of
  quantiles gives a tuple of masks.

The quantile is the JAX one (``jnp.quantile``'s linear interpolation,
``low * (1 - w) + high * w`` with the weight in float64), since the mask
compares every bin with it.
"""

import torch

__all__ = ['lorenz_mask', 'quantile_mask']


def lorenz_mask(observation, *, axis=-1, lorenz_fraction=0.98, weight=0.999):
    """observation (..., N, ...) real or complex tensor -> mask of its
    power's real dtype and shape."""
    power = torch.movedim(observation.abs() ** 2, axis, -1)
    sorted_power = torch.sort(power, dim=-1, descending=True).values
    total = torch.clamp_min(sorted_power.sum(dim=-1, keepdim=True),
                            torch.finfo(power.dtype).tiny)
    cum = torch.cumsum(sorted_power, dim=-1) / total
    # the last sorted bin still inside the fraction sets the threshold
    inside = cum < lorenz_fraction
    threshold = torch.where(inside, sorted_power,
                            sorted_power[..., :1]).amin(dim=-1, keepdim=True)
    mask = _soft(power >= threshold, weight, power)
    return torch.movedim(mask, -1, axis)


def _soft(mask, weight, like):
    """``weight`` where ``mask``, ``1 - weight`` elsewhere, in ``like``'s
    dtype (the scalars rounded once, to that dtype)."""
    return torch.where(mask, like.new_tensor(weight),
                       like.new_tensor(1.0 - weight))


def _quantile(x, q, dim):
    """``jnp.quantile(x, q, axis=dim, keepdims=True)``, linear
    interpolation between the sorted neighbours."""
    s = torch.sort(x, dim=dim).values
    pos = q * (x.shape[dim] - 1)
    lo, hi = int(pos // 1), -int(-pos // 1)
    w = pos - lo
    low = s.narrow(dim, lo, 1).to(torch.float64)
    high = s.narrow(dim, hi, 1).to(torch.float64)
    return (low * (1.0 - w) + high * w).to(x.dtype)


def quantile_mask(observation, quantile=0.9, *, sensor_axis=None, axis=-1,
                  weight=0.999):
    """observation tensor -> mask of |observation|'s dtype (``sensor_axis``
    summed before the quantile and dropped from the mask), or a tuple of
    masks for a list of quantiles."""
    if isinstance(quantile, (tuple, list)):
        return tuple(quantile_mask(observation, q, sensor_axis=sensor_axis,
                                   axis=axis, weight=weight)
                     for q in quantile)
    power = observation.abs()
    if sensor_axis is not None:
        power = power.sum(dim=sensor_axis, keepdim=True)
    dim = axis % power.dim()
    if quantile >= 0:
        mask = power >= _quantile(power, 1.0 - quantile, dim)
    else:
        mask = power <= _quantile(power, -quantile, dim)
    mask = _soft(mask, weight, power)
    if sensor_axis is not None:
        mask = mask.squeeze(sensor_axis)
    return mask
