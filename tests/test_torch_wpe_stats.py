"""The WPE statistics kernel's plain PyTorch version (which
``wpe_statistics`` runs on the CPU) and the port's ``wpe(stats_backend=
'pallas')`` vs the JAX package, its Pallas kernel in interpret mode.

Tolerances: R and P at a relative Frobenius error per frequency of 1e-5
(float32 sums over 700 frames in another order: the JAX kernel pads T to
1024 and contracts real 2x2-block planes, the port multiplies complex
matrices; measured 3.8e-7 for R and 5.6e-7 for P).  WPE itself at atol
2e-4 of the output scale, the pin of
``tests/test_wpe.py::test_pallas_stats_backend_matches_xla`` (two
iterations through an ill-conditioned 1e-4-loaded solve amplify that
rounding).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pb_chime5_tpu.ops.pallas.wpe_stats import (
    wpe_statistics as jax_wpe_statistics)
from pb_chime5_tpu.ops.wpe import wpe as jax_wpe
from pb_chime5_tpu_torch.ops import wpe as port
from pb_chime5_tpu_torch.ops.kernels import wpe_stats
from tests.test_torch_kernels_cuda import stats_errors, wpe_inputs

torch.set_num_threads(2)


def reference_vs_jax_kernel(F, D, T, taps, seed):
    """The plain version and the JAX kernel in interpret mode on the same
    inputs: (R, P) of the plain version, relative errors of R and P."""
    Yt, Y, w, _ = wpe_inputs(F, D, T, taps=taps, seed=seed)
    R, P = wpe_stats.wpe_statistics_reference(Yt, Y, w)
    R_j, P_j = jax_wpe_statistics(jnp.asarray(Yt.numpy()),
                                  jnp.asarray(Y.numpy()),
                                  jnp.asarray(w.numpy()), interpret=True)
    rel_R, rel_P, _ = stats_errors(R, P, torch.from_numpy(np.array(R_j)),
                                   torch.from_numpy(np.array(P_j)))
    return R, P, rel_R, rel_P


def test_reference_matches_jax_kernel():
    """F = 9, taps * D = 12, T = 700 with a near-silent stretch and a
    masked tail of 70 frames."""
    R, P, rel_R, rel_P = reference_vs_jax_kernel(9, 3, 700, 4, seed=1)
    assert R.shape == (9, 12, 12) and P.shape == (9, 12, 3)
    assert R.dtype == P.dtype == torch.complex64
    assert rel_R <= 1e-5 and rel_P <= 1e-5, (rel_R, rel_P)


# (F, D, T, taps): dim 72 and 75 cross the card kernel's 64-row block, D 25
# its 24 columns of P beside the diagonal block
@pytest.mark.parametrize('shape', [(3, 24, 130, 3), (2, 25, 70, 3)],
                         ids=lambda s: 'F{}-D{}-T{}-taps{}'.format(*s))
def test_reference_matches_jax_kernel_across_tiles(shape):
    _, _, rel_R, rel_P = reference_vs_jax_kernel(*shape, seed=8)
    assert rel_R <= 1e-5 and rel_P <= 1e-5, (rel_R, rel_P)


def test_wpe_pallas_backend_matches_jax(rng):
    """The shapes of the JAX pin: F = 9, D = 3, T = 700, 4 taps, delay 1,
    2 iterations, complex64."""
    F, D, T = 9, 3, 700
    Y = (rng.standard_normal((F, D, T))
         + 1j * rng.standard_normal((F, D, T))).astype(np.complex64)
    kw = dict(taps=4, delay=1, iterations=2, stats_backend='pallas')
    got = port.wpe(torch.from_numpy(Y), **kw).numpy()
    want = np.asarray(jax_wpe(jnp.asarray(Y), **kw))
    assert got.dtype == np.complex64
    scale = np.abs(want).max()
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4)


def test_pallas_backend_on_cpu_equals_the_matmul_statistics(rng):
    """On the CPU the kernel's plain version is the matmul statistics
    themselves: the two backends agree bit for bit, frame mask included."""
    F, D, T = 5, 2, 120
    Y = torch.from_numpy((rng.standard_normal((F, D, T))
                          + 1j * rng.standard_normal((F, D, T)))
                         .astype(np.complex64))
    fm = torch.arange(T) < 100
    a = port.wpe(Y, taps=3, frame_mask=fm, stats_backend='pallas')
    b = port.wpe(Y, taps=3, frame_mask=fm, stats_backend='auto')
    torch.testing.assert_close(a, b, rtol=0, atol=0)


# the route of each backend, dtype and device without ``chunk_size``
ROUTES = {
    ('auto', 'complex64', 'cuda'): 'kernel',
    ('auto', 'complex64', 'cpu'): 'tiles',
    ('auto', 'complex128', 'cuda'): 'tiles',
    ('auto', 'complex128', 'cpu'): 'tiles',
    ('xla', 'complex64', 'cuda'): 'tiles',
    ('xla', 'complex64', 'cpu'): 'tiles',
    ('xla', 'complex128', 'cuda'): 'tiles',
    ('xla', 'complex128', 'cpu'): 'tiles',
    ('pallas', 'complex64', 'cuda'): 'kernel',
    ('pallas', 'complex64', 'cpu'): 'kernel',
    ('pallas', 'complex128', 'cuda'): 'kernel',
    ('pallas', 'complex128', 'cpu'): 'kernel',
}


@pytest.mark.parametrize('chunked', [False, True],
                         ids=['whole', 'chunked'])
@pytest.mark.parametrize('case', sorted(ROUTES), ids='-'.join)
def test_stats_route_table(case, chunked):
    """'auto' takes the kernel for complex64 on CUDA, 'pallas' always
    ('pallas' rejects complex128 in the kernel's wrapper), 'xla' never;
    ``chunk_size`` takes the chunked matmuls whatever the backend."""
    backend, dtype, device_type = case
    route = port.stats_route(backend, getattr(torch, dtype), device_type,
                             chunked)
    assert route == ('chunked' if chunked else ROUTES[case])


@pytest.mark.parametrize('chunk_size', [None, 40], ids=['whole', 'chunked'])
@pytest.mark.parametrize('backend', ['auto', 'xla', 'pallas'])
def test_wpe_takes_the_route_on_the_cpu(rng, monkeypatch, backend,
                                        chunk_size):
    """``wpe`` calls the statistics entry of its route once an iteration
    (on the CPU 'auto' takes the tiles), and neither with ``chunk_size``;
    the kernel's wrapper still launches nothing on the CPU."""
    calls = {'wpe_statistics': 0, 'wpe_statistics_reference': 0}
    for name in calls:
        def counted(*args, name=name, real=getattr(port, name)):
            calls[name] += 1
            return real(*args)
        monkeypatch.setattr(port, name, counted)
    F, D, T = 3, 2, 100
    Y = torch.from_numpy((rng.standard_normal((F, D, T))
                          + 1j * rng.standard_normal((F, D, T)))
                         .astype(np.complex64))
    before = wpe_stats.wpe_statistics.launches
    port.wpe(Y, taps=3, iterations=2, chunk_size=chunk_size,
             stats_backend=backend)
    name = {'auto': 'wpe_statistics_reference',
            'xla': 'wpe_statistics_reference',
            'pallas': 'wpe_statistics'}[backend]
    expected = dict.fromkeys(calls, 0)
    if chunk_size is None:
        expected[name] = 2
    assert calls == expected
    assert wpe_stats.wpe_statistics.launches == before


def test_wpe_rejects_unported_backends():
    Y = torch.zeros((2, 2, 10), dtype=torch.complex64)
    with pytest.raises(NotImplementedError):
        port.wpe(Y, stats_backend='real')
    with pytest.raises(ValueError):
        port.wpe(Y, stats_backend='no_such_backend')


def test_wrapper_runs_reference_on_cpu_without_counting():
    Yt, Y, w, _ = wpe_inputs(3, 2, 60, taps=3, seed=2)
    before = wpe_stats.wpe_statistics.launches
    R, P = wpe_stats.wpe_statistics(Yt, Y, w)
    R_r, P_r = wpe_stats.wpe_statistics_reference(Yt, Y, w)
    torch.testing.assert_close(R, R_r, rtol=0, atol=0)
    torch.testing.assert_close(P, P_r, rtol=0, atol=0)
    assert wpe_stats.wpe_statistics.launches == before


@pytest.mark.parametrize('bad', ['dtype', 'weight', 'layout', 'shape',
                                 'rank'])
def test_wrapper_rejects_unsupported_inputs(bad):
    Yt, Y, w, _ = wpe_inputs(2, 3, 40, taps=2, seed=3)
    if bad == 'dtype':
        Yt = Yt.to(torch.complex128)
    elif bad == 'weight':
        w = w.double()
    elif bad == 'layout':
        Y = Y.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == 'shape':
        w = w[:, :30]
    elif bad == 'rank':
        Y = Y[0]
    with pytest.raises(ValueError):
        wpe_stats.wpe_statistics(Yt, Y, w)
