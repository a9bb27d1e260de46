"""The fused E+M kernel's Hermitian form for S, stated in plain PyTorch
(``frame_features`` in ``ops/kernels/fused_em.py``), against the plain
version's full S; and the kernel's compile-time constants against the
wrapper's.

The kernel sums, per class, c_kt times the D^2 real features of
z_t z_t^H (the lower triangle) and writes S in full, its upper triangle
the conjugate mirror.  These tests pin that layout and that write: the
features summed with the plain version's own coefficients gamma / q and
mirrored give the plain version's S (also where P is not Hermitian: S
sees P only through q).  Tolerance: 1e-5 relative Frobenius per (f, k)
(float32 sums of up to T = 40 terms in two orders).
"""

import re

import numpy as np
import pytest
import torch

from pb_chime5_tpu_torch.ops.kernels import _build, fused_em
from tests.test_torch_fused_em_cuda import random_inputs

RTOL = 1e-5


def matrix_from_features(x, D):
    """(..., D^2) features -> (..., D, D) complex Hermitian, as the kernel
    writes S: entry (d, e) from pair (max, min), Im negated above the
    diagonal."""
    d = torch.arange(D)[:, None].expand(D, D)
    e = torch.arange(D)[None, :].expand(D, D)
    hi, lo = torch.maximum(d, e), torch.minimum(d, e)
    j = torch.where(d == e, D * (D - 1) + d, hi * (hi - 1) + 2 * lo)
    re = x[..., j]
    im = torch.where(d == e, 0.0, x[..., (j + 1).clamp_max(D * D - 1)])
    return torch.complex(re, torch.where(d < e, -im, im))


def hermitian_form_S(z, params, act, fm):
    """S through the features: sum_t (gamma / q)_kt features_t, with the
    plain version's gamma and q, mirrored to the full matrix."""
    log_weight, precision, logdet = params
    D = z.shape[-1]
    tiny = torch.finfo(torch.float32).tiny
    q = torch.clamp_min(fused_em.quadratic_form(z, precision), tiny)
    log_pdf = log_weight[..., None] - D * torch.log(q) - logdet[..., None]
    gamma = torch.exp(log_pdf - log_pdf.amax(dim=1, keepdim=True)) * act
    gamma = gamma / torch.clamp_min(gamma.sum(dim=1, keepdim=True), tiny)
    c = gamma * fm / q                                       # (F, K, T)
    x = torch.einsum('fkt,ftj->fkj', c, fused_em.frame_features(z))
    return matrix_from_features(x, D)


@pytest.mark.parametrize('D', [1, 2, 5, 16, 24])
@pytest.mark.parametrize('case', ['hpd', 'identity', 'non_hermitian'])
def test_hermitian_form_gives_the_full_S(D, case):
    inputs = random_inputs(4, 40, D, 3, seed=D, identity=case == 'identity',
                           skew=0.5 if case == 'non_hermitian' else 0.0)
    if case == 'non_hermitian':
        precision = inputs[1][1]
        assert not torch.allclose(precision, precision.mH)
    want = fused_em.fused_em_scatter_reference(*inputs)[0]
    got = hermitian_form_S(*inputs)
    assert got.shape == want.shape and got.dtype == torch.complex64
    err = torch.linalg.matrix_norm(got - want)
    assert (err <= RTOL * torch.linalg.matrix_norm(want)).all(), err.max()


def test_zero_rows_give_zero_forms():
    z, (_, precision, _), _, _ = random_inputs(3, 30, 24, 5, seed=3,
                                               skew=0.2)
    z[:, [0, 7, 29]] = 0
    assert not fused_em.frame_features(z)[:, [0, 7, 29]].any()
    assert not fused_em.quadratic_form(z, precision)[..., [0, 7, 29]].any()


def test_layout_order():
    """Features: Re, Im of z_d conj(z_e) for d > e in row-major order,
    then |z_d|^2."""
    D = 3
    z = torch.tensor([1 + 2j, 3 - 1j, -2 + 0.5j], dtype=torch.complex64)
    want = []
    for d, e in [(1, 0), (2, 0), (2, 1)]:
        m = complex(z[d]) * complex(z[e]).conjugate()
        want += [m.real, m.imag]
    want += [abs(complex(z[d])) ** 2 for d in range(D)]
    np.testing.assert_allclose(fused_em.frame_features(z).numpy(), want,
                               rtol=1e-6)


@pytest.mark.parametrize('name,value', [
    ('kChunk', fused_em.CHUNK), ('kCluster', fused_em.CLUSTER),
    ('kMaxD', fused_em.MAX_D), ('kMaxK', fused_em.MAX_K)])
def test_constants_match_the_kernel_source(name, value):
    """The wrapper's statement of the kernel's frame split and size limits
    (which the card tests use to place their boundaries) is the source's."""
    source = (_build.CSRC_DIR / 'fused_em.cu').read_text()
    m = re.search(rf'constexpr int {name} = (\d+);', source)
    assert m and int(m[1]) == value
