"""The JAX package's ``tests/gpflow_tpu/conditionals/test_conditionals.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Dense-conditional dispatcher behaviors (reference
``tests/gpflow/conditionals/test_conditionals.py``): diag vs full-diagonal
q_sqrt equality, whitened == unwhitened prediction, triangular-mask
invariance of values AND gradients, and the dispatcher vs a NumPy oracle
through a real kernel.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose
import torch

import gpflow_tpu_torch
from gpflow_tpu_torch.conditionals import conditional
from gpflow_tpu_torch.config import default_jitter
from gpflow_tpu_torch.inducing_variables import InducingPoints
from . import test_torch_translated_support as support
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(123)

Ln = 2
Nn = 10
Mn = 20


@pytest.fixture(scope="module")
def kernel():
    k = gpflow_tpu_torch.kernels.Matern32() + gpflow_tpu_torch.kernels.White()
    k.kernels[1].variance.assign(0.01)
    return k


Xdata = rng.randn(Nn, 1)
Xnew = rng.randn(Mn, 1)
mu = rng.randn(Nn, Ln)
sqrt = rng.randn(Nn, Ln)
chol = np.stack([np.diag(sqrt[:, i]) for i in range(Ln)])


@pytest.mark.parametrize("white", [True, False])
def test_diag_equals_diagonal_chol(kernel, white):
    """[N, L] diagonal q_sqrt and the equivalent [L, N, N] diagonal
    Cholesky must give identical conditionals."""
    mean1, var1 = conditional(Xnew, Xdata, kernel, mu, q_sqrt=sqrt, white=white)
    mean2, var2 = conditional(Xnew, Xdata, kernel, mu, q_sqrt=chol, white=white)
    assert_allclose(np.asarray(mean1), np.asarray(mean2), atol=1e-10)
    assert_allclose(np.asarray(var1), np.asarray(var2), atol=1e-10)


def test_whiten(kernel):
    """Whitened prediction with V = L^-1 mu equals unwhitened with mu."""
    K = np.asarray(kernel(Xdata)) + np.eye(Nn) * default_jitter()
    L = np.linalg.cholesky(K)
    V = np.linalg.solve(L, mu)
    mean1, var1 = conditional(Xnew, Xdata, kernel, mu)
    mean2, var2 = conditional(Xnew, Xdata, kernel, V, white=True)
    assert_allclose(np.asarray(mean1), np.asarray(mean2), atol=1e-9)
    assert_allclose(np.asarray(var1), np.asarray(var2), atol=1e-9)


def test_gaussian_whiten(kernel):
    """Whitened q_sqrt = L^-1 diag(F_sqrt) equals unwhitened diag F_sqrt."""
    F_sqrt = rng.rand(Nn, Ln)
    K = np.asarray(kernel(Xdata)) + np.eye(Nn) * default_jitter()
    L = np.linalg.cholesky(K)
    V = np.linalg.solve(L, mu)
    V_sqrt = np.stack([np.linalg.solve(L, np.diag(F_sqrt[:, i])) for i in range(Ln)])

    mean, var = conditional(Xnew, Xdata, kernel, mu, q_sqrt=F_sqrt)
    mean_w, var_w = conditional(Xnew, Xdata, kernel, V, q_sqrt=V_sqrt, white=True)
    assert_allclose(np.asarray(mean), np.asarray(mean_w), atol=1e-8)
    assert_allclose(np.asarray(var), np.asarray(var_w), atol=1e-8)


@pytest.mark.parametrize("white", [True, False])
def test_q_sqrt_lower_triangle_only(kernel, white):
    """The conditional must depend only on the lower triangle of q_sqrt —
    values AND gradients — matching the KL's triangular constraint."""
    tril = np.tril(rng.randn(Ln, Nn, Nn))
    strict_upper = np.triu(rng.randn(Ln, Nn, Nn), 1)

    def var_sum(q_sqrt):
        _, fvar = conditional(Xnew, Xdata, kernel, mu, q_sqrt=q_sqrt, white=white)
        return torch.sum(fvar)

    v1, g1 = support.value_and_grad(var_sum)(asarray(tril))
    v2, g2 = support.value_and_grad(var_sum)(asarray(tril + strict_upper))
    assert_allclose(float(v1), float(v2), rtol=1e-12)
    # gradients agree on the lower triangle; upper-triangle grads are dead
    assert_allclose(np.tril(np.asarray(g1)), np.tril(np.asarray(g2)), rtol=1e-10)
    assert_allclose(np.triu(np.asarray(g2), 1), 0.0, atol=1e-12)


@pytest.mark.parametrize("full_cov", [True, False])
@pytest.mark.parametrize("features_inducing_points", [False, True])
def test_conditional_vs_numpy_oracle(full_cov, features_inducing_points):
    """Dispatcher + real kernel vs a slow-but-clear NumPy implementation."""
    Dy, N, M, Dx = 5, 4, 3, 2
    r = np.random.RandomState(7)
    X = r.randn(N, Dx)
    Z = r.randn(M, Dx)
    kern = gpflow_tpu_torch.kernels.Matern52(lengthscales=0.5)
    q_mu = r.randn(M, Dy)
    q_sqrt = np.tril(r.randn(Dy, M, M), -1)

    Kmm = np.asarray(kern(Z, Z)) + np.eye(M) * default_jitter()
    Kmn = np.asarray(kern(Z, X))
    Knn = np.asarray(kern(X, X))
    S = q_sqrt @ np.transpose(q_sqrt, [0, 2, 1])
    Kmm_inv = np.linalg.inv(Kmm)
    mean_np = np.einsum("mn,mM,Md->nd", Kmn, Kmm_inv, q_mu)
    cov_np = Knn[None] + Kmn.T[None] @ Kmm_inv[None] @ (S - Kmm[None]) @ (
        Kmm_inv @ Kmn
    )[None]

    feat = InducingPoints(Z) if features_inducing_points else Z
    mean, cov = conditional(
        X, feat, kern, q_mu, q_sqrt=q_sqrt, white=False, full_cov=full_cov
    )
    if not full_cov:
        cov_np = np.diagonal(cov_np, axis1=-1, axis2=-2).T
    assert_allclose(mean_np, np.asarray(mean), atol=1e-8)
    assert_allclose(cov_np, np.asarray(cov), atol=1e-8)
