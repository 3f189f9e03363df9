"""The JAX package's ``tests/gpflow_tpu/test_expectations.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Expectations framework tests: analytic psi statistics vs quadrature
(pattern from reference ``tests/gpflow/expectations``).
"""
import numpy as np
import pytest
import torch

import gpflow_tpu_torch
from gpflow_tpu_torch import functions as mfn
from gpflow_tpu_torch import kernels
from gpflow_tpu_torch.expectations import expectation, quadrature_expectation
from gpflow_tpu_torch.inducing_variables import InducingPoints
from gpflow_tpu_torch.probability_distributions import DiagonalGaussian, Gaussian
from . import test_torch_translated_support as support
from .test_torch_translated_support import X64, asarray, seeded_generator, translated_test_environment  # noqa: F401

rng = np.random.RandomState(5)
N, D, M = 6, 2, 4

Xmu = rng.randn(N, D)
Xvar_diag = 0.05 + 0.1 * rng.rand(N, D)
# full covariances (PSD)
a = 0.2 * rng.randn(N, D, D)
Xcov = np.einsum("nij,nkj->nik", a, a) + 0.08 * np.eye(D)
Z = rng.randn(M, D)


def _gauss():
    return Gaussian(Xmu, Xcov)


def _diag():
    return DiagonalGaussian(Xmu, Xvar_diag)


KERNELS = [
    kernels.SquaredExponential(variance=1.4, lengthscales=0.8),
    kernels.SquaredExponential(variance=0.9, lengthscales=np.array([0.5, 1.2])),
    kernels.Linear(variance=1.3),
]


@pytest.mark.parametrize("kernel", KERNELS, ids=["rbf", "rbf-ard", "linear"])
def test_psi0_analytic_vs_quadrature(kernel):
    p = _gauss()
    analytic = np.asarray(expectation(p, kernel))
    quad = np.asarray(quadrature_expectation(p, kernel, nghp=25))
    np.testing.assert_allclose(analytic, quad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kernel", KERNELS, ids=["rbf", "rbf-ard", "linear"])
def test_psi1_analytic_vs_quadrature(kernel):
    p = _gauss()
    iv = InducingPoints(Z.copy())
    analytic = np.asarray(expectation(p, (kernel, iv)))
    quad = np.asarray(quadrature_expectation(p, (kernel, iv), nghp=25))
    assert analytic.shape == (N, M)
    np.testing.assert_allclose(analytic, quad, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("kernel", KERNELS, ids=["rbf", "rbf-ard", "linear"])
def test_psi2_analytic_vs_quadrature(kernel):
    p = _gauss()
    iv = InducingPoints(Z.copy())
    analytic = np.asarray(expectation(p, (kernel, iv), (kernel, iv)))
    quad = np.asarray(quadrature_expectation(p, (kernel, iv), (kernel, iv), nghp=25))
    assert analytic.shape == (N, M, M)
    np.testing.assert_allclose(analytic, quad, rtol=1e-4, atol=1e-6)


def test_psi_stats_diagonal_gaussian():
    kernel = KERNELS[0]
    iv = InducingPoints(Z.copy())
    p = _diag()
    analytic = np.asarray(expectation(p, (kernel, iv)))
    quad = np.asarray(quadrature_expectation(p, (kernel, iv), nghp=25))
    np.testing.assert_allclose(analytic, quad, rtol=1e-5, atol=1e-7)


def test_exKxz_vs_quadrature():
    kernel = KERNELS[0]
    iv = InducingPoints(Z.copy())
    p = _gauss()
    analytic = np.asarray(expectation(p, mfn.Identity(D), (kernel, iv)))
    quad = np.asarray(quadrature_expectation(p, mfn.Identity(D), (kernel, iv), nghp=25))
    assert analytic.shape == (N, D, M)
    np.testing.assert_allclose(analytic, quad, rtol=1e-5, atol=1e-7)


def test_mean_function_expectations():
    p = _gauss()
    A = rng.randn(D, 3)
    b = rng.randn(3)
    lin = mfn.Linear(A, b)
    const = mfn.Constant(rng.randn(3))
    for m1, m2 in [(lin, lin), (lin, const), (const, lin), (const, const)]:
        analytic = np.asarray(expectation(p, m1, m2))
        quad = np.asarray(quadrature_expectation(p, m1, m2, nghp=25))
        np.testing.assert_allclose(analytic, quad, rtol=1e-5, atol=1e-7)


def test_sum_kernel_psi2():
    p = _gauss()
    iv = InducingPoints(Z.copy())
    k = kernels.SquaredExponential(variance=0.7) + kernels.Linear(variance=0.5)
    analytic = np.asarray(expectation(p, (k, iv), (k, iv)))
    quad = np.asarray(quadrature_expectation(p, (k, iv), (k, iv), nghp=25))
    np.testing.assert_allclose(analytic, quad, rtol=1e-4, atol=1e-6)


def test_product_kernel_separate_dims():
    p = _diag()
    iv = InducingPoints(Z.copy())
    k = kernels.SquaredExponential(active_dims=[0]) * kernels.SquaredExponential(active_dims=[1])
    analytic = np.asarray(expectation(p, (k, iv)))
    quad = np.asarray(quadrature_expectation(p, (k, iv), nghp=25))
    np.testing.assert_allclose(analytic, quad, rtol=1e-5, atol=1e-7)


def test_cross_sqexp_linear():
    p = _gauss()
    iv = InducingPoints(Z.copy())
    ks = kernels.SquaredExponential(variance=1.2, lengthscales=0.9)
    kl = kernels.Linear(variance=0.8)
    analytic = np.asarray(expectation(p, (ks, iv), (kl, iv)))
    quad = np.asarray(quadrature_expectation(p, (ks, iv), (kl, iv), nghp=25))
    np.testing.assert_allclose(analytic, quad, rtol=1e-4, atol=1e-6)
    # transpose relation
    analytic_t = np.asarray(expectation(p, (kl, iv), (ks, iv)))
    np.testing.assert_allclose(analytic_t, np.swapaxes(analytic, -1, -2), rtol=1e-10)


def test_quadrature_fallback_for_matern():
    """Matern has no analytic psi stats: entry point must silently fall back."""
    p = _gauss()
    iv = InducingPoints(Z.copy())
    k = kernels.Matern52()
    res = np.asarray(expectation(p, (k, iv)))
    quad = np.asarray(quadrature_expectation(p, (k, iv)))
    np.testing.assert_allclose(res, quad, rtol=1e-12)


def test_uncertain_conditional_vs_monte_carlo():
    from gpflow_tpu_torch.conditionals import uncertain_conditional

    M_, Dout = 5, 2
    Zu = rng.randn(M_, D)
    q_mu = rng.randn(M_, Dout)
    qs = 0.2 * rng.randn(Dout, M_, M_)
    q_sqrt = np.tril(qs + 1.0 * np.eye(M_))
    kernel = kernels.SquaredExponential(variance=1.1, lengthscales=0.9)
    iv = InducingPoints(Zu)

    fmean, fvar = uncertain_conditional(
        Xmu, Xcov, iv, kernel, q_mu, q_sqrt, white=False
    )
    assert np.asarray(fmean).shape == (N, Dout)
    assert np.asarray(fvar).shape == (N, Dout)

    # Monte-Carlo oracle
    from gpflow_tpu_torch.conditionals import conditional

    S = 30000
    key = seeded_generator(0)
    chol = np.linalg.cholesky(Xcov)
    eps = np.asarray(torch.randn((S, N, D), generator=key, **X64))
    Xsamples = Xmu[None] + np.einsum("nij,snj->sni", chol, eps)  # [S, N, D]
    mus, vars_ = conditional(
        asarray(Xsamples.reshape(S * N, D)), iv, kernel, q_mu, q_sqrt=q_sqrt, white=False
    )
    mus = np.asarray(mus).reshape(S, N, Dout)
    vars_ = np.asarray(vars_).reshape(S, N, Dout)
    mc_mean = mus.mean(0)
    mc_var = vars_.mean(0) + mus.var(0)

    np.testing.assert_allclose(np.asarray(fmean), mc_mean, atol=0.03)
    np.testing.assert_allclose(np.asarray(fvar), mc_var, atol=0.05)


def test_bayesian_gplvm_elbo_and_training():
    from gpflow_tpu_torch.models import BayesianGPLVM
    from gpflow_tpu_torch.optimizers import Scipy

    Q = 1
    Nl, P = 15, 4
    t = np.linspace(0, 2 * np.pi, Nl)[:, None]
    Ydata = np.concatenate([np.sin(t), np.cos(t), np.sin(2 * t), np.cos(2 * t)], axis=1)
    Ydata += 0.05 * rng.randn(Nl, P)

    model = BayesianGPLVM(
        Ydata,
        X_data_mean=0.1 * rng.randn(Nl, Q),
        X_data_var=0.5 * np.ones((Nl, Q)),
        kernel=kernels.SquaredExponential(lengthscales=np.ones(Q)),
        num_inducing_variables=8,
    )
    initial = float(model.elbo())
    assert np.isfinite(initial)
    Scipy().minimize(model.training_loss, model.trainable_variables, options={"maxiter": 50})
    assert float(model.elbo()) > initial + 1.0
    mean, var = model.predict_f(rng.randn(3, Q))
    assert np.asarray(mean).shape == (3, P)
    assert np.all(np.asarray(var) > 0)


def test_gplvm_trains():
    from gpflow_tpu_torch.models import GPLVM
    from gpflow_tpu_torch.optimizers import Scipy

    Nl, P = 12, 3
    t = np.linspace(0, 1, Nl)[:, None]
    Ydata = np.concatenate([t, t ** 2, np.sin(t)], axis=1) + 0.01 * rng.randn(Nl, P)
    model = GPLVM(Ydata, latent_dim=1)
    initial = float(model.training_loss())
    Scipy().minimize(model.training_loss, model.trainable_variables, options={"maxiter": 30})
    assert float(model.training_loss()) < initial


# --- no-uncertainty degenerate checks (reference test_expectations.py:201-235)


def _dirac_diag():
    return DiagonalGaussian(Xmu, np.zeros_like(Xvar_diag))


@pytest.mark.parametrize("kernel", KERNELS, ids=["rbf", "rbf-ard", "linear"])
def test_eKdiag_no_uncertainty(kernel):
    eKdiag = np.asarray(expectation(_dirac_diag(), kernel))
    Kdiag = np.asarray(kernel(Xmu, full_cov=False))
    np.testing.assert_allclose(eKdiag, Kdiag, rtol=1e-8)


@pytest.mark.parametrize("kernel", KERNELS, ids=["rbf", "rbf-ard", "linear"])
def test_eKxz_no_uncertainty(kernel):
    eKxz = np.asarray(expectation(_dirac_diag(), (kernel, InducingPoints(Z))))
    Kxz = np.asarray(kernel(Xmu, Z))
    np.testing.assert_allclose(eKxz, Kxz, rtol=1e-8)


@pytest.mark.parametrize("kernel", KERNELS, ids=["rbf", "rbf-ard", "linear"])
def test_eKzxKxz_no_uncertainty(kernel):
    iv_ = InducingPoints(Z)
    eKzxKxz = np.asarray(expectation(_dirac_diag(), (kernel, iv_), (kernel, iv_)))
    Kxz = np.asarray(kernel(Xmu, Z))
    KzxKxz = Kxz[:, :, None] * Kxz[:, None, :]
    np.testing.assert_allclose(eKzxKxz, KzxKxz, rtol=1e-8)


def test_rbf_eKzxKxz_gradient_not_nan_when_Kzz_underflows():
    """psi2 gradient stays finite when K_{Z,Z} underflows to zero at distant
    inducing points (reference ``test_expectations.py:237-257``, PR #595)."""

    p = Gaussian(np.array([[10.0]]), np.array([[[0.1]]]))
    Zfar = np.array([[-10.0], [10.0]])

    def objective(log_ls):
        kernel = kernels.SquaredExponential(variance=2.0, lengthscales=1.0)
        kernel.lengthscales._parameters["unconstrained"] = kernel.lengthscales.transform.inverse(
            torch.exp(log_ls)
        )
        ekz = expectation(p, (kernel, InducingPoints(Zfar)), (kernel, InducingPoints(Zfar)))
        return torch.sum(ekz)

    grad = support.grad(objective)(np.log(0.1))
    assert np.isfinite(np.asarray(grad)), grad
