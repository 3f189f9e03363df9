"""The JAX package's ``tests/gpflow_tpu/test_linalg.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

ops.linalg custom-VJP composites must match stock autodiff exactly (f64).
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch.ops.linalg import chol_and_inverse, triangular_inverse
from . import test_torch_translated_support as support
from .test_torch_translated_support import X64, asarray, solve_triangular, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)


def _spd(m, batch=()):
    a = rng.randn(*batch, m, m)
    return asarray(a @ np.swapaxes(a, -1, -2) + m * np.eye(m))


@pytest.mark.parametrize("m", [5, 17])
def test_triangular_inverse_matches_solve(m):
    L = torch.linalg.cholesky(_spd(m))
    np.testing.assert_allclose(
        np.asarray(triangular_inverse(L)),
        np.asarray(solve_triangular(L, torch.eye(m, **X64), lower=True)),
        rtol=1e-12,
    )


@pytest.mark.parametrize("m", [5, 17])
def test_triangular_inverse_grad_matches_autodiff(m):
    L = torch.linalg.cholesky(_spd(m))
    f_ref = lambda l: torch.sum(torch.sin(solve_triangular(l, torch.eye(m, **X64), lower=True)))
    f_new = lambda l: torch.sum(torch.sin(triangular_inverse(l)))
    g_ref = torch.tril(support.grad(f_ref)(L))  # only the lower triangle is read
    g_new = support.grad(f_new)(L)
    np.testing.assert_allclose(np.asarray(g_ref), np.asarray(g_new), atol=1e-12)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_chol_and_inverse_grad_matches_autodiff(batch):
    m = 8
    K = _spd(m, batch)
    eye = torch.eye(m, **X64)

    def h_ref(k):
        L = torch.linalg.cholesky(k)
        Li = solve_triangular(L, torch.broadcast_to(eye, L.shape), lower=True)
        return torch.sum(torch.sin(L) * 1.3) + torch.sum(torch.cos(Li) * 0.7)

    def h_new(k):
        L, Li = chol_and_inverse(k)
        return torch.sum(torch.sin(L) * 1.3) + torch.sum(torch.cos(Li) * 0.7)

    np.testing.assert_allclose(np.asarray(h_ref(K)), np.asarray(h_new(K)), rtol=1e-12)
    g_ref, g_new = support.grad(h_ref)(K), support.grad(h_new)(K)
    np.testing.assert_allclose(np.asarray(g_ref), np.asarray(g_new), atol=1e-12)
