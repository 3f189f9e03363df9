"""The JAX package's ``tests/gpflow_tpu/conditionals/test_sample_conditional.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

sample_conditional tests (pattern from reference
``tests/gpflow/conditionals/test_sample_conditionals.py``).
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch import kernels
from gpflow_tpu_torch.conditionals import conditional, sample_conditional
from gpflow_tpu_torch.inducing_variables import (
    InducingPoints,
    SharedIndependentInducingVariables,
)
from .test_torch_translated_support import X64, seeded_generator, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)
M, N, D, P, L = 5, 200, 2, 3, 2


def test_sample_conditional_moments_match():
    Z = rng.randn(M, D)
    X = rng.randn(8, D)
    q_mu = rng.randn(M, 1)
    q_sqrt = np.tril(0.2 * rng.randn(1, M, M) + np.eye(M))
    kernel = kernels.SquaredExponential()
    iv = InducingPoints(Z)

    samples, mean, cov = sample_conditional(
        X, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True, num_samples=20000,
        generator=seeded_generator(0),
    )
    s = np.asarray(samples)
    assert s.shape == (20000, 8, 1)
    np.testing.assert_allclose(s.mean(0), np.asarray(mean), atol=0.05)
    np.testing.assert_allclose(s.var(0), np.asarray(cov), atol=0.05)


def test_sample_conditional_full_cov():
    Z = rng.randn(M, D)
    X = rng.randn(6, D)
    q_mu = rng.randn(M, 1)
    kernel = kernels.SquaredExponential()
    iv = InducingPoints(Z)
    samples, mean, cov = sample_conditional(
        X, iv, kernel, q_mu, q_sqrt=None, white=True, full_cov=True, num_samples=4000,
        generator=seeded_generator(1),
    )
    s = np.asarray(samples)
    assert s.shape == (4000, 6, 1)
    emp_cov = np.cov(s[:, :, 0].T)
    np.testing.assert_allclose(emp_cov, np.asarray(cov)[0], atol=0.08)


def test_sample_conditional_coregionalization_efficient_path():
    ks = [kernels.SquaredExponential(lengthscales=0.5 + i) for i in range(L)]
    W = rng.randn(P, L)
    kernel = kernels.LinearCoregionalization(ks, W=W)
    iv = SharedIndependentInducingVariables(InducingPoints(rng.randn(M, D)))
    q_mu = rng.randn(M, L)
    q_sqrt = np.tril(0.2 * rng.randn(L, M, M) + np.eye(M))
    X = rng.randn(7, D)
    samples, mean, cov = sample_conditional(
        X, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True, num_samples=20000,
        generator=seeded_generator(2),
    )
    s = np.asarray(samples)
    assert s.shape == (20000, 7, P)
    np.testing.assert_allclose(s.mean(0), np.asarray(mean), atol=0.06)
    # moments must match the generic conditional
    m2, v2 = conditional(X, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True)
    np.testing.assert_allclose(np.asarray(mean), np.asarray(m2), atol=1e-8)
    np.testing.assert_allclose(np.asarray(cov), np.asarray(v2), atol=1e-8)


@pytest.mark.parametrize("full_cov", [True, False])
def test_sample_mvn_moments(full_cov):
    """10k draws from a known MVN recover its mean/cov (reference
    ``test_multioutput.py:242-261``)."""
    from gpflow_tpu_torch.conditionals.util import sample_mvn

    n, d = 10000, 2
    means = torch.ones((n, d), **X64)
    covs = torch.tile(torch.eye(d, **X64), (n, 1, 1)) if full_cov else torch.ones((n, d), **X64)
    samples = np.asarray(sample_mvn(means, covs, full_cov, generator=seeded_generator(0)))
    np.testing.assert_array_almost_equal(samples.mean(0), [1.0, 1.0], decimal=1)
    np.testing.assert_array_almost_equal(
        np.cov(samples, rowvar=False), [[1.0, 0.0], [0.0, 1.0]], decimal=1
    )


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("full_cov", [True, False])
def test_sample_conditional_inducing_points_vs_raw_array(whiten, full_cov):
    """The InducingPoints route and the raw-Z-array route must give identical
    moments and statistically matching samples (reference
    ``test_multioutput.py:264-322``)."""
    M_, P_ = 4, 3
    r = np.random.RandomState(10)
    q_mu = r.rand(M_, P_)
    q_sqrt = np.stack([np.tril(r.rand(M_, M_)) for _ in range(P_)])
    Z = r.randn(M_, D)
    Xs = np.ones((6, D))
    kernel = kernels.SquaredExponential()

    value_f, mean_f, var_f = sample_conditional(
        Xs, InducingPoints(Z), kernel, q_mu, q_sqrt=q_sqrt, white=whiten,
        full_cov=full_cov, num_samples=30000, generator=seeded_generator(5),
    )
    value_x, mean_x, var_x = sample_conditional(
        Xs, Z, kernel, q_mu, q_sqrt=q_sqrt, white=whiten,
        full_cov=full_cov, num_samples=30000, generator=seeded_generator(6),
    )
    np.testing.assert_allclose(np.asarray(mean_x), np.asarray(mean_f), atol=1e-10)
    np.testing.assert_allclose(np.asarray(var_x), np.asarray(var_f), atol=1e-10)
    vf = np.asarray(value_f).reshape(-1, P_)
    vx = np.asarray(value_x).reshape(-1, P_)
    np.testing.assert_array_almost_equal(vf.mean(0), vx.mean(0), decimal=1)
    np.testing.assert_array_almost_equal(
        np.cov(vf, rowvar=False), np.cov(vx, rowvar=False), decimal=1
    )


def test_sample_conditional_mixedkernel_vs_separate_then_mix():
    """Sampling through the efficient LinearCoregionalization route matches
    sampling the independent latents and mixing with W afterwards
    (reference ``test_multioutput.py:323-356``)."""
    M_, L_, P_ = 4, 2, 3
    r = np.random.RandomState(11)
    q_mu = r.rand(M_, L_)
    q_sqrt = np.stack([np.tril(r.rand(M_, M_)) for _ in range(L_)])
    Z = r.randn(M_, D)
    Xs = np.ones((40000, D))
    W = r.randn(P_, L_)

    mixed_kernel = kernels.LinearCoregionalization(
        [kernels.SquaredExponential() for _ in range(L_)], W=W
    )
    value, mean, var = sample_conditional(
        Xs, SharedIndependentInducingVariables(InducingPoints(Z)), mixed_kernel,
        q_mu, q_sqrt=q_sqrt, white=True, generator=seeded_generator(7),
    )

    separate_kernel = kernels.SeparateIndependent(
        [kernels.SquaredExponential() for _ in range(L_)]
    )
    value2, mean2, var2 = sample_conditional(
        Xs, SharedIndependentInducingVariables(InducingPoints(Z)), separate_kernel,
        q_mu, q_sqrt=q_sqrt, white=True, generator=seeded_generator(8),
    )
    value2 = np.asarray(value2) @ W.T
    np.testing.assert_array_almost_equal(
        np.asarray(value).mean(0), value2.mean(0), decimal=1
    )
    np.testing.assert_array_almost_equal(
        np.cov(np.asarray(value), rowvar=False), np.cov(value2, rowvar=False), decimal=1
    )


def test_sample_conditional_coregionalization_full_cov_moments():
    """mixing + full_cov: sample moments must match (f_mu, f_var) — this path
    is a TPU-build extension (the reference raises NotImplementedError,
    ``multioutput/sample_conditionals.py:53``)."""
    ks = [kernels.SquaredExponential(lengthscales=0.5 + i) for i in range(L)]
    W = rng.randn(P, L)
    kernel = kernels.LinearCoregionalization(ks, W=W)
    iv = SharedIndependentInducingVariables(InducingPoints(rng.randn(M, D)))
    q_mu = rng.randn(M, L)
    q_sqrt = np.tril(0.2 * rng.randn(L, M, M) + np.eye(M))
    X = rng.randn(6, D)
    S = 20000

    samples, mean, cov = sample_conditional(
        X, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True, full_cov=True,
        num_samples=S, generator=seeded_generator(2),
    )
    s = np.asarray(samples)
    assert s.shape == (S, 6, P)
    assert np.asarray(cov).shape == (P, 6, 6)
    np.testing.assert_allclose(s.mean(0), np.asarray(mean), atol=0.06)
    for p in range(P):
        emp_cov = np.cov(s[:, :, p].T)
        np.testing.assert_allclose(emp_cov, np.asarray(cov)[p], atol=0.08)
    # The joint structure across N must be the mixed per-latent full covs,
    # not merely the marginals: compare against the diag-only path's variance.
    _, _, var_diag = sample_conditional(
        X, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True, full_cov=False,
        num_samples=2, generator=seeded_generator(3),
    )
    np.testing.assert_allclose(
        np.einsum("pnn->np", np.asarray(cov)), np.asarray(var_diag), rtol=1e-6
    )


@pytest.mark.parametrize("full_cov", [False, True])
def test_sample_conditional_coregionalization_full_output_cov(full_cov):
    """mixing + full_output_cov (reference raises NotImplementedError): the
    returned across-output moments must match the W-mixed diag-path variance,
    and sample moments must agree."""
    ks = [kernels.SquaredExponential(lengthscales=0.5 + i) for i in range(L)]
    W = rng.randn(P, L)
    kernel = kernels.LinearCoregionalization(ks, W=W)
    iv = SharedIndependentInducingVariables(InducingPoints(rng.randn(M, D)))
    q_mu = rng.randn(M, L)
    q_sqrt = np.tril(0.2 * rng.randn(L, M, M) + np.eye(M))
    X = rng.randn(5, D)
    S = 20000

    samples, mean, cov = sample_conditional(
        X, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True,
        full_cov=full_cov, full_output_cov=True,
        num_samples=S, generator=seeded_generator(4),
    )
    s = np.asarray(samples)
    cov = np.asarray(cov)
    assert s.shape == (S, 5, P)
    if full_cov:
        assert cov.shape == (5, P, 5, P)
        marg = np.einsum("npnq->npq", cov)
    else:
        assert cov.shape == (5, P, P)
        marg = cov
    np.testing.assert_allclose(s.mean(0), np.asarray(mean), atol=0.06)
    # empirical across-output covariance at each input point vs returned [P, P]
    for n in range(5):
        emp = np.cov(s[:, n, :].T)
        np.testing.assert_allclose(emp, marg[n], atol=0.08)
    # moments must be the W-mixed per-latent vars: cross-check vs the diag path
    _, _, var_diag = sample_conditional(
        X, iv, kernel, q_mu, q_sqrt=q_sqrt, white=True,
        full_cov=False, full_output_cov=False,
        num_samples=2, generator=seeded_generator(5),
    )
    np.testing.assert_allclose(
        np.einsum("npp->np", marg), np.asarray(var_diag), rtol=1e-6
    )
