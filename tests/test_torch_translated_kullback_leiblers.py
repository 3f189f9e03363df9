"""The JAX package's ``tests/gpflow_tpu/test_kullback_leiblers.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

gauss_kl vs a naive NumPy oracle across the full argument grid
(pattern from reference ``tests/gpflow/test_kullback_leiblers.py``):
q_sqrt diag [M, L] vs tril [L, M, M]; p white vs shared K [M, M] vs
batched K [L, M, M]; K vs precomputed K_cholesky.
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch.kullback_leiblers import gauss_kl, prior_kl
from gpflow_tpu_torch.inducing_variables import InducingPoints
from gpflow_tpu_torch import kernels
from . import test_torch_translated_support as support
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)
M, L = 6, 3


def _rand_spd(n):
    A = rng.randn(n, n)
    return A @ A.T + n * np.eye(n)


def _np_kl_single(mu, S, K):
    """KL[N(mu, S) || N(0, K)] via the closed form, dense NumPy."""
    Kinv = np.linalg.inv(K)
    _, logdet_K = np.linalg.slogdet(K)
    _, logdet_S = np.linalg.slogdet(S)
    n = len(mu)
    return 0.5 * (
        np.trace(Kinv @ S) + mu @ Kinv @ mu - n + logdet_K - logdet_S
    )


def _oracle(q_mu, q_sqrt, K):
    """Sum of per-column KLs; K None = identity, [M,M] shared, or [L,M,M]."""
    M_, L_ = q_mu.shape
    total = 0.0
    for l in range(L_):
        mu = q_mu[:, l]
        if q_sqrt.ndim == 2:
            S = np.diag(q_sqrt[:, l] ** 2)
        else:
            Lq = np.tril(q_sqrt[l])
            S = Lq @ Lq.T
        if K is None:
            Kl = np.eye(M_)
        elif K.ndim == 2:
            Kl = K
        else:
            Kl = K[l]
        total += _np_kl_single(mu, S, Kl)
    return total


@pytest.fixture(params=["diag", "tril"])
def q_sqrt(request):
    if request.param == "diag":
        return np.abs(rng.randn(M, L)) + 0.3
    return np.stack([np.tril(rng.randn(M, M)) + 2 * np.eye(M) for _ in range(L)])


@pytest.fixture(params=["white", "shared", "batched"])
def K(request):
    if request.param == "white":
        return None
    if request.param == "shared":
        return _rand_spd(M)
    return np.stack([_rand_spd(M) for _ in range(L)])


def test_gauss_kl_vs_oracle(q_sqrt, K):
    q_mu = rng.randn(M, L)
    kl = float(gauss_kl(q_mu, q_sqrt, K))
    np.testing.assert_allclose(kl, _oracle(q_mu, q_sqrt, K), rtol=1e-9)
    assert kl > 0


def test_gauss_kl_cholesky_argument_equivalent(q_sqrt, K):
    if K is None:
        pytest.skip("no K to factor")
    q_mu = rng.randn(M, L)
    K_chol = np.linalg.cholesky(K)
    np.testing.assert_allclose(
        float(gauss_kl(q_mu, q_sqrt, K)),
        float(gauss_kl(q_mu, q_sqrt, K_cholesky=K_chol)),
        rtol=1e-9,
    )


def test_gauss_kl_rejects_both_K_and_cholesky():
    q_mu = rng.randn(M, L)
    q_sqrt = np.abs(rng.randn(M, L))
    K = _rand_spd(M)
    with pytest.raises(ValueError, match="one of"):
        gauss_kl(q_mu, q_sqrt, K, K_cholesky=np.linalg.cholesky(K))


def test_gauss_kl_zero_at_matching_distribution():
    # q == p  =>  KL == 0: q_mu=0, q_sqrt = chol(K)
    K = _rand_spd(M)
    Lk = np.linalg.cholesky(K)
    q_mu = np.zeros((M, 1))
    q_sqrt = Lk[None]
    np.testing.assert_allclose(float(gauss_kl(q_mu, q_sqrt, K)), 0.0, atol=1e-9)
    # white version
    np.testing.assert_allclose(
        float(gauss_kl(np.zeros((M, 2)), np.ones((M, 2)), None)), 0.0, atol=1e-12
    )


@pytest.mark.parametrize("whiten", [True, False])
def test_prior_kl_dispatcher_matches_gauss_kl(whiten):
    Z = rng.randn(M, 2)
    iv = InducingPoints(Z)
    kernel = kernels.SquaredExponential()
    q_mu = rng.randn(M, L)
    q_sqrt = np.stack([np.tril(rng.randn(M, M)) + 2 * np.eye(M) for _ in range(L)])
    kl = float(prior_kl(iv, kernel, q_mu, q_sqrt, whiten=whiten))
    if whiten:
        expected = float(gauss_kl(q_mu, q_sqrt, None))
    else:
        from gpflow_tpu_torch.covariances import Kuu
        from gpflow_tpu_torch.config import default_jitter

        K = np.asarray(Kuu(iv, kernel, jitter=default_jitter()))
        expected = float(gauss_kl(q_mu, q_sqrt, K))
    np.testing.assert_allclose(kl, expected, rtol=1e-10)


@pytest.mark.parametrize("white", [True, False])
def test_q_sqrt_triangular_constraint_invariance(white):
    """A q_sqrt stored WITHOUT the triangular transform (full dense matrix)
    must give the same conditional values and gradients as the
    triangular-constrained one: the math must only read the lower triangle
    (reference ``test_kullback_leiblers.py:248-279``)."""

    from gpflow_tpu_torch.base import Parameter
    from gpflow_tpu_torch.conditionals import conditional
    from gpflow_tpu_torch.utilities import triangular

    Nn, Ln = 6, 2
    Z = rng.randn(Nn, 1)
    Xs = rng.randn(4, 1)
    q_mu = rng.randn(Nn, Ln)
    tril = np.tril(rng.randn(Ln, Nn, Nn))
    dense = tril + np.triu(rng.randn(Ln, Nn, Nn), 1)  # junk ABOVE the diagonal

    kernel = kernels.Matern32()
    iv = InducingPoints(Z)

    p_tril = Parameter(tril, transform=triangular())
    p_dense = Parameter(dense)

    def predict(q_sqrt_value):
        return conditional(
            Xs, iv, kernel, q_mu, q_sqrt=q_sqrt_value, white=white, full_cov=False
        )

    m1, v1 = predict(p_tril.value)
    m2, v2 = predict(p_dense.value)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), atol=1e-12)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), atol=1e-12)

    def loss(q_sqrt_value):
        m, v = predict(q_sqrt_value)
        return torch.sum(m) + torch.sum(v)

    g1 = np.asarray(support.grad(loss)(asarray(tril)))
    g2 = np.asarray(support.grad(loss)(asarray(dense)))
    # gradients agree on the lower triangle; the upper triangle of the dense
    # parameterization receives zero gradient (the value is never read)
    np.testing.assert_allclose(np.tril(g1), np.tril(g2), atol=1e-12)
    np.testing.assert_allclose(np.triu(g2, 1), 0.0, atol=1e-12)


@pytest.mark.parametrize("white", [True, False])
def test_oned_hand_calculation(white):
    """KL of N x 1-D Gaussians matches the scalar formula
    0.5 (s^2/p + mu^2/p - 1 + log(p/s^2)) summed (reference ``test_oned``)."""
    n = 5
    mu1d = rng.randn(1, n)  # [1, N]: N independent 1-D distributions
    s1d = np.abs(rng.randn(n, 1, 1)) + 0.3  # [N, 1, 1]
    K1d = np.abs(rng.randn(n, 1, 1)) + 0.5  # [N, 1, 1]

    kl = float(gauss_kl(mu1d, s1d, None if white else K1d))
    mu_f, s_f = mu1d.ravel(), s1d.ravel()
    p_f = np.ones(n) if white else K1d.ravel()
    expected = float(
        np.sum(0.5 * (s_f**2 / p_f + mu_f**2 / p_f - 1 + np.log(p_f / s_f**2)))
    )
    np.testing.assert_allclose(kl, expected, rtol=1e-10)
