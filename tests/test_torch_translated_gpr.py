"""The JAX package's ``tests/gpflow_tpu/models/test_gpr.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

GPR end-to-end: NLML parity vs a NumPy oracle, prediction equations,
Scipy L-BFGS training (minimum end-to-end slice, SURVEY.md §7.2 stage 5).
"""
import numpy as np
import pytest
from scipy.linalg import cho_factor, cho_solve

import gpflow_tpu_torch
from gpflow_tpu_torch.models import GPR
from gpflow_tpu_torch.kernels import SquaredExponential
from gpflow_tpu_torch.optimizers import Scipy
from .test_torch_translated_support import seeded_generator, translated_test_environment  # noqa: F401

rng = np.random.RandomState(42)
N, D = 30, 2
X = rng.randn(N, D)
F = np.sin(X[:, :1]) + 0.5 * np.cos(X[:, 1:])
Y = F + 0.1 * rng.randn(N, 1)


def numpy_nlml(X, Y, variance, lengthscales, noise):
    """Oracle log marginal likelihood for RBF-kernel GPR."""
    d = X[:, None, :] - X[None, :, :]
    r2 = np.sum((d / lengthscales) ** 2, -1)
    K = variance * np.exp(-0.5 * r2) + noise * np.eye(len(X))
    c, low = cho_factor(K, lower=True)
    L = np.tril(c)
    alpha = cho_solve((c, low), Y)
    return float(
        -0.5 * np.sum(Y * alpha)
        - np.sum(np.log(np.diag(L)))
        - 0.5 * len(X) * Y.shape[1] * np.log(2 * np.pi)
    )


def test_gpr_lml_vs_numpy_oracle():
    model = GPR((X, Y), kernel=SquaredExponential(variance=1.3, lengthscales=0.7),
                noise_variance=0.05)
    lml = float(model.log_marginal_likelihood())
    expected = numpy_nlml(X, Y, 1.3, 0.7, 0.05)
    np.testing.assert_allclose(lml, expected, rtol=1e-10)
    # training loss is the negative
    np.testing.assert_allclose(float(model.training_loss()), -expected, rtol=1e-10)


def test_gpr_predict_vs_numpy_oracle():
    noise = 0.05
    model = GPR((X, Y), kernel=SquaredExponential(), noise_variance=noise)
    Xnew = rng.randn(5, D)

    d = X[:, None, :] - X[None, :, :]
    K = np.exp(-0.5 * np.sum(d ** 2, -1)) + noise * np.eye(N)
    ds = X[:, None, :] - Xnew[None, :, :]
    Ks = np.exp(-0.5 * np.sum(ds ** 2, -1))  # [N, 5]
    Kss = np.exp(-0.5 * np.sum((Xnew[:, None, :] - Xnew[None, :, :]) ** 2, -1))
    Kinv = np.linalg.inv(K)
    mean_expected = Ks.T @ Kinv @ Y
    cov_expected = Kss - Ks.T @ Kinv @ Ks

    mean, var = model.predict_f(Xnew)
    np.testing.assert_allclose(np.asarray(mean), mean_expected, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(var)[:, 0], np.diag(cov_expected), rtol=1e-7, atol=1e-10)

    mean_fc, cov_fc = model.predict_f(Xnew, full_cov=True)
    np.testing.assert_allclose(np.asarray(mean_fc), mean_expected, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(cov_fc)[0], cov_expected, rtol=1e-7, atol=1e-9)


def test_gpr_posterior_cache_matches_fused():
    model = GPR((X, Y), kernel=SquaredExponential(), noise_variance=0.1)
    Xnew = rng.randn(7, D)
    posterior = model.posterior()
    m1, v1 = posterior.predict_f(Xnew)
    m2, v2 = model.predict_f(Xnew)
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-10)


def test_gpr_predict_y_and_log_density():
    noise = 0.1
    model = GPR((X, Y), kernel=SquaredExponential(), noise_variance=noise)
    Xnew = rng.randn(4, D)
    fmean, fvar = model.predict_f(Xnew)
    ymean, yvar = model.predict_y(Xnew)
    np.testing.assert_allclose(np.asarray(ymean), np.asarray(fmean), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(yvar), np.asarray(fvar) + noise, rtol=1e-8)
    Ynew = np.sin(Xnew[:, :1])
    ld = np.asarray(model.predict_log_density((Xnew, Ynew)))
    from scipy import stats

    expected = stats.norm.logpdf(
        Ynew[:, 0], loc=np.asarray(ymean)[:, 0], scale=np.sqrt(np.asarray(yvar)[:, 0])
    )
    np.testing.assert_allclose(ld, expected, rtol=1e-7)


def test_gpr_scipy_training_improves_and_recovers_noise():
    model = GPR((X, Y), kernel=SquaredExponential(), noise_variance=1.0)
    initial_loss = float(model.training_loss())
    result = Scipy().minimize(
        model.training_loss, model.trainable_variables, options={"maxiter": 200}
    )
    final_loss = float(model.training_loss())
    assert result.success or result.status in (0, 1, 2)
    assert final_loss < initial_loss - 1.0
    # learned noise should be near the true 0.01 variance
    learned_noise = float(model.likelihood.variance.value)
    assert learned_noise < 0.1


def test_gpr_training_loss_closure_jit():
    model = GPR((X, Y), kernel=SquaredExponential(), noise_variance=0.5)
    closure = model.training_loss_closure(compile=True)
    l1 = float(closure())
    np.testing.assert_allclose(l1, float(model.training_loss()), rtol=1e-10)
    # mutating a parameter is picked up without retracing
    model.likelihood.variance.assign(0.25)
    np.testing.assert_allclose(float(closure()), float(model.training_loss()), rtol=1e-10)


def test_gpr_predict_f_samples_shapes():
    model = GPR((X, Y), kernel=SquaredExponential(), noise_variance=0.1)
    Xnew = rng.randn(6, D)
    s = model.predict_f_samples(Xnew, generator=seeded_generator(0))
    assert np.asarray(s).shape == (6, 1)
    s10 = model.predict_f_samples(Xnew, num_samples=10, generator=seeded_generator(0))
    assert np.asarray(s10).shape == (10, 6, 1)
    # statistical sanity: mean of many samples approaches predictive mean
    s_many = np.asarray(
        model.predict_f_samples(Xnew, num_samples=4000, full_cov=False, generator=seeded_generator(1))
    )
    mean, var = model.predict_f(Xnew)
    np.testing.assert_allclose(
        s_many.mean(0), np.asarray(mean), atol=4 * np.sqrt(np.asarray(var).max() / 4000) + 0.02
    )


def test_gpr_prior_map_changes_loss():
    from gpflow_tpu_torch import priors

    model = GPR((X, Y), kernel=SquaredExponential(), noise_variance=0.1)
    base = float(model.training_loss())
    model.kernel.variance.prior = priors.LogNormal(0.0, 1.0)
    with_prior = float(model.training_loss())
    assert with_prior != base
    expected_delta = -float(model.kernel.variance.log_prior_density())
    np.testing.assert_allclose(with_prior - base, expected_delta, rtol=1e-8)
