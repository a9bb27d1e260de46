"""The Gauss-Jordan kernel's two entries (K3
``hermitian_inverse_and_logdet_2d``, K4 ``hermitian_inverse_and_logdet``)
— their plain PyTorch versions, which the entries run on the CPU — vs the
JAX Pallas kernels in interpret mode.

Tolerances: on HPD input the inverse at atol 1e-5 / rtol 1e-4 and the
logdet at rtol 1e-5, the pin ``tests/test_pallas_kernels.py`` holds K3 to
against the XLA Gauss-Jordan (the same elimination; float32 rounding in
another association).  On the non-HPD input the values reach ~1e37, so
the inverse is compared at rtol 1e-5 alone; the logdets are exact
(one floored term dominates, or -inf).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops.pallas import (
    hermitian_inverse_and_logdet as jax_k4)
from pb_chime5_tpu.ops.pallas.gj_inverse2d import (
    hermitian_inverse_and_logdet_2d as jax_k3)
from pb_chime5_tpu_torch.ops.kernels import gj_inverse
from tests.test_torch_kernels_cuda import (
    GJ_ENTRIES, em_like_batch, negative_pivot_matrix, random_hpd)

torch.set_num_threads(2)

JAX_KERNELS = {'k3': jax_k3, 'k4': jax_k4}


def _jax(entry, B):
    inv, ld = JAX_KERNELS[entry](jnp.asarray(B.numpy()), interpret=True)
    return np.asarray(inv), np.asarray(ld)


@pytest.mark.parametrize('entry,shape,D', [
    ('k3', (7,), 4), ('k3', (7,), 24), ('k3', (2, 3), 8),
    ('k4', (7,), 4), ('k4', (7,), 8), ('k4', (2, 3), 8),
])
def test_reference_matches_jax_kernel(entry, shape, D):
    B = random_hpd(shape, D, seed=D)
    _, reference = GJ_ENTRIES[entry]
    inv, ld = reference(B)
    inv_j, ld_j = _jax(entry, B)
    assert inv.dtype == torch.complex64 and ld.dtype == torch.float32
    assert inv.shape == B.shape and ld.shape == shape
    np.testing.assert_allclose(inv.numpy(), inv_j, atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ld.numpy(), ld_j, rtol=1e-5)


@pytest.mark.parametrize('entry', sorted(GJ_ENTRIES))
def test_floor_modes_follow_their_jax_kernel_on_a_negative_pivot(entry):
    B = negative_pivot_matrix()
    _, reference = GJ_ENTRIES[entry]
    inv, ld = reference(B)
    inv_j, ld_j = _jax(entry, B)
    np.testing.assert_array_equal(ld.numpy(), ld_j)
    np.testing.assert_allclose(inv.numpy(), inv_j, rtol=1e-5)
    assert np.isfinite(inv.numpy()).all()
    if entry == 'k3':
        # the pivot floored to FLT_MIN: a logdet term of log(FLT_MIN)
        assert -88 < float(ld) < -87 and np.abs(inv_j).max() > 1e36
    else:
        # 1e-38 is flushed to zero by XLA: log(0); reciprocal of -0.5
        assert float(ld) == -np.inf and np.abs(inv_j).max() < 10


def test_modes_agree_on_hpd_input():
    B = em_like_batch(6, 5, 8, seed=2)
    inv3, ld3 = gj_inverse.hermitian_inverse_and_logdet_2d(B)
    inv4, ld4 = gj_inverse.hermitian_inverse_and_logdet(B)
    assert torch.equal(inv3, inv4) and torch.equal(ld3, ld4)
    assert torch.isfinite(inv3).all()


@pytest.mark.parametrize('entry', sorted(GJ_ENTRIES))
def test_entry_runs_reference_on_cpu_without_counting(entry):
    kernel, reference = GJ_ENTRIES[entry]
    B = random_hpd((3, 2), 5, seed=1)
    before = kernel.launches
    inv, ld = kernel(B)
    inv_r, ld_r = reference(B)
    torch.testing.assert_close(inv, inv_r, rtol=0, atol=0)
    torch.testing.assert_close(ld, ld_r, rtol=0, atol=0)
    assert kernel.launches == before


@pytest.mark.parametrize('bad', ['D', 'dtype', 'layout', 'square', 'empty'])
def test_entries_reject_unsupported_inputs(bad):
    B = random_hpd((2,), gj_inverse.MAX_D + 1 if bad == 'D' else 4)
    if bad == 'dtype':
        B = B.to(torch.complex128)
    elif bad == 'layout':
        B = B.transpose(-2, -1)
    elif bad == 'square':
        B = B[..., :3]
    elif bad == 'empty':
        B = B[:0]
    for kernel, _ in GJ_ENTRIES.values():
        with pytest.raises(ValueError):
            kernel(B)
