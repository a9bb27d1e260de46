"""The port's smaller host pieces against the JAX package's: the twins of
tests/test_aux.py's ``change_directory`` and ``summary_encoder``; the
``Experiment`` decorators (``capture_kwargs``, ``command``, ``main``);
the package roots; the blocked Cholesky of ``ops/linalg.py`` and its
solve.  Host computations compared exactly; the blocked Cholesky in
complex128 at 1e-12 (JAX's panels mirrored one for one) and in complex64
at 1e-5.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pb_chime5_tpu
import pb_chime5_tpu_torch
from pb_chime5_tpu import io as jax_io
from pb_chime5_tpu.ops import linalg as jax_linalg
from pb_chime5_tpu.scripts.experiment import Experiment as JaxExperiment
from pb_chime5_tpu_torch import io
from pb_chime5_tpu_torch.ops import linalg
from pb_chime5_tpu_torch.scripts.experiment import Experiment


def test_change_directory(tmp_path):
    cwd = os.getcwd()
    for mod in (io, jax_io):
        with mod.change_directory(tmp_path):
            assert os.getcwd() == str(tmp_path)
        assert os.getcwd() == cwd
    with pytest.raises(RuntimeError):
        with io.change_directory(tmp_path):
            raise RuntimeError
    assert os.getcwd() == cwd


def test_summary_encoder():
    obj = {'a': np.zeros((3, 4)), 'b': np.float32(2.5), 'c': [np.int8(1)]}
    got = json.dumps(obj, cls=io.SummaryEncoder)
    assert got == json.dumps(obj, cls=jax_io.SummaryEncoder)
    assert 'shape (3, 4)' in got
    assert json.dumps(obj['c'], cls=io.Encoder) == '[1]'


def run_decorated(cls, tmp_path, argv):
    """A factory, a command and a main registered by the decorators, run
    from a command line -> what they saw."""
    seen = {}

    def factory(a=1, b='x', c=None):
        return a, b, c
    exp = cls('decorated', default_storage_dir=tmp_path)
    exp.add_config_from_signature(factory)
    exp.add_config({'extra': 3})

    @exp.command
    def show(experiment):
        seen['show'] = experiment.capture_kwargs(factory)

    @exp.main
    def run(experiment):
        seen['main'] = factory(**experiment.capture_kwargs(factory))
    exp.run_commandline(argv, create_run_dir=False)
    return seen


@pytest.mark.parametrize('argv', [
    ['show', 'with', 'a=5'], ['with', 'b="y"', 'c=(1, 2)'], []])
def test_experiment_decorators_match_jax(tmp_path, argv):
    got = run_decorated(Experiment, tmp_path / 'port', argv)
    assert got == run_decorated(JaxExperiment, tmp_path / 'jax', argv)
    assert got


def test_package_roots():
    assert pb_chime5_tpu_torch.repo_root == pb_chime5_tpu.repo_root
    assert pb_chime5_tpu_torch.package_root == \
        pb_chime5_tpu.repo_root / 'pb_chime5_tpu_torch'


def _random_hpd(d, dtype, seed, batch=(3,)):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((*batch, d, d)) \
        + 1j * rng.standard_normal((*batch, d, d))
    return (A @ A.conj().swapaxes(-1, -2) / d + 0.5 * np.eye(d)).astype(
        dtype), rng


@pytest.mark.parametrize('d', [8, 32, 40, 70])
@pytest.mark.parametrize('dtype,rtol', [(np.complex128, 1e-12),
                                        (np.complex64, 1e-5)])
def test_blocked_cholesky_matches_jax(d, dtype, rtol):
    A, rng = _random_hpd(d, dtype, seed=d)
    B = (rng.standard_normal((3, d, 4))
         + 1j * rng.standard_normal((3, d, 4))).astype(dtype)
    L = linalg.blocked_cholesky(torch.from_numpy(A))
    L_jax = np.asarray(jax_linalg.blocked_cholesky(jnp.asarray(A)))
    assert torch.equal(L, L.tril())
    np.testing.assert_allclose(L.numpy(), L_jax, rtol=0,
                               atol=rtol * np.abs(L_jax).max())
    X = linalg.blocked_cholesky_solve(L, torch.from_numpy(B))
    X_jax = np.asarray(jax_linalg.blocked_cholesky_solve(
        jnp.asarray(L_jax), jnp.asarray(B)))
    np.testing.assert_allclose(X.numpy(), X_jax, rtol=0,
                               atol=10 * rtol * np.abs(X_jax).max())
    # a batch of batches, and the floored pivot of a singular matrix
    L4 = linalg.blocked_cholesky(torch.from_numpy(A).reshape(1, 3, d, d))
    assert torch.equal(L4[0], L)
    Z = np.zeros((1, d, d), dtype)
    Z[0, 0, 0] = 1
    assert torch.isfinite(linalg.blocked_cholesky(torch.from_numpy(Z))).all()
    with pytest.raises(NotImplementedError):
        linalg.blocked_cholesky(torch.from_numpy(A), block=16)
