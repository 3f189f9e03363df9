"""The JAX package's ``tests/gpflow_tpu/likelihoods/test_likelihoods.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Likelihood tests: closed-form results must agree with the generic
Gauss-Hermite quadrature fallback (pattern from reference
``tests/gpflow/likelihoods/test_likelihoods.py``).
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch import likelihoods
from gpflow_tpu_torch.quadrature import NDiagGHQuadrature
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(3)
N = 10

X = rng.randn(N, 2)
F = rng.randn(N, 1)
Fmu = rng.randn(N, 1)
Fvar = 0.01 * (rng.randn(N, 1) ** 2 + 0.2)


def _quadrature_fallbacks(lik, Y):
    """Computes varexp/pld/pmv through the raw QuadratureLikelihood path."""
    base = likelihoods.ScalarLikelihood  # access unbound quadrature implementations
    ve = likelihoods.QuadratureLikelihood._variational_expectations(lik, X, Fmu, Fvar, Y)
    pld = likelihoods.QuadratureLikelihood._predict_log_density(lik, X, Fmu, Fvar, Y)
    pmv = likelihoods.QuadratureLikelihood._predict_mean_and_var(lik, X, Fmu, Fvar)
    return ve, pld, pmv


LIKELIHOOD_SETUPS = [
    (likelihoods.Gaussian(0.3), lambda: rng.randn(N, 1)),
    (likelihoods.StudentT(scale=0.8, df=4.0), lambda: rng.randn(N, 1)),
    (likelihoods.Beta(scale=2.0), lambda: rng.rand(N, 1) * 0.8 + 0.1),
    (likelihoods.Gamma(), lambda: 0.3 + rng.rand(N, 1)),
    (likelihoods.Exponential(), lambda: 0.3 + rng.rand(N, 1)),
    (likelihoods.Poisson(), lambda: rng.poisson(2.0, (N, 1)).astype(float)),
    (likelihoods.Bernoulli(), lambda: (rng.rand(N, 1) > 0.5).astype(float)),
    (likelihoods.Ordinal(np.array([-1.0, 1.0])), lambda: rng.randint(0, 3, (N, 1)).astype(float)),
]


@pytest.mark.parametrize(
    "lik,y_gen", LIKELIHOOD_SETUPS, ids=lambda s: type(s).__name__ if not callable(s) else ""
)
def test_variational_expectations_vs_quadrature(lik, y_gen):
    Y = y_gen()
    analytic = np.asarray(lik.variational_expectations(X, Fmu, Fvar, Y))
    # quadrature route through ScalarLikelihood machinery
    quad = np.asarray(
        lik._quadrature_reduction(lik.quadrature(lik._quadrature_log_prob, Fmu, Fvar, X=X, Y=Y))
    )
    assert analytic.shape == (N,)
    np.testing.assert_allclose(analytic, quad, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize(
    "lik,y_gen", LIKELIHOOD_SETUPS, ids=lambda s: type(s).__name__ if not callable(s) else ""
)
def test_predict_log_density_vs_quadrature(lik, y_gen):
    Y = y_gen()
    analytic = np.asarray(lik.predict_log_density(X, Fmu, Fvar, Y))
    quad = np.asarray(
        lik._quadrature_reduction(
            lik.quadrature.logspace(lik._quadrature_log_prob, Fmu, Fvar, X=X, Y=Y)
        )
    )
    assert analytic.shape == (N,)
    np.testing.assert_allclose(analytic, quad, rtol=2e-4, atol=1e-6)


def test_gaussian_closed_forms():
    var = 0.3
    lik = likelihoods.Gaussian(var)
    Y = rng.randn(N, 1)
    mu, v = lik.predict_mean_and_var(X, Fmu, Fvar)
    np.testing.assert_allclose(mu, Fmu)
    np.testing.assert_allclose(v, Fvar + var, rtol=1e-10)
    # variational expectations closed form
    expected = (
        -0.5 * np.log(2 * np.pi)
        - 0.5 * np.log(var)
        - 0.5 * ((Y - Fmu) ** 2 + Fvar) / var
    ).sum(-1)
    np.testing.assert_allclose(lik.variational_expectations(X, Fmu, Fvar, Y), expected, rtol=1e-10)


def test_gaussian_variance_lower_bound():
    with pytest.raises(Exception):
        lik = likelihoods.Gaussian(1e-8)
        # constructing with variance below the 1e-6 bound must fail
        np.asarray(lik.variance_at(X))


def test_gaussian_variance_at_shape():
    lik = likelihoods.Gaussian(0.5)
    v = np.asarray(lik.variance_at(X))
    assert v.shape == (N, 1)
    np.testing.assert_allclose(v, 0.5)


def test_bernoulli_probit_closed_form():
    lik = likelihoods.Bernoulli()
    p_analytic, v_analytic = lik.predict_mean_and_var(X, Fmu, Fvar)
    quad = NDiagGHQuadrature(1, 50)
    p_quad = np.asarray(
        quad(lambda f: likelihoods.inv_probit(f), asarray(Fmu), asarray(Fvar))
    )
    np.testing.assert_allclose(np.asarray(p_analytic), p_quad, rtol=1e-6, atol=1e-8)


def test_switched_likelihood():
    liks = [likelihoods.Gaussian(0.1), likelihoods.Gaussian(1.0)]
    switched = likelihoods.SwitchedLikelihood(liks)
    Ydata = rng.randn(N, 1)
    ind = rng.randint(0, 2, (N, 1)).astype(float)
    Y = np.concatenate([Ydata, ind], axis=1)
    ve = np.asarray(switched.variational_expectations(X, Fmu, Fvar, Y))
    # oracle: per-row, use the likelihood selected by ind
    ve0 = np.asarray(liks[0].variational_expectations(X, Fmu, Fvar, Ydata))
    ve1 = np.asarray(liks[1].variational_expectations(X, Fmu, Fvar, Ydata))
    expected = np.where(ind[:, 0] == 0, ve0, ve1)
    np.testing.assert_allclose(ve, expected, rtol=1e-10)


def test_multiclass_robustmax():
    K = 3
    lik = likelihoods.MultiClass(K)
    FmuK = rng.randn(N, K)
    FvarK = rng.rand(N, K) + 0.1
    Y = rng.randint(0, K, (N, 1)).astype(float)
    ve = np.asarray(lik.variational_expectations(X, FmuK, FvarK, Y))
    assert ve.shape == (N,)
    assert np.all(np.isfinite(ve))
    p, v = lik.predict_mean_and_var(X, FmuK, FvarK)
    p = np.asarray(p)
    assert p.shape == (N, K)
    np.testing.assert_allclose(p.sum(-1), 1.0, atol=5e-3)
    # log_prob of certain labels
    F_certain = np.eye(K)[Y[:, 0].astype(int)] * 10.0
    lp = np.asarray(lik.log_prob(X, F_certain, Y))
    np.testing.assert_allclose(lp, np.log(1 - 1e-3), rtol=1e-6)


def test_softmax_mc():
    K = 4
    lik = likelihoods.Softmax(K)
    FmuK = rng.randn(N, K)
    FvarK = rng.rand(N, K) + 0.1
    Y = rng.randint(0, K, (N, 1)).astype(float)
    lp = np.asarray(lik.log_prob(X, FmuK, Y))
    assert lp.shape == (N,)
    expected = np.take_along_axis(
        np.asarray(torch.log_softmax(asarray(FmuK), dim=-1)), Y.astype(int), axis=-1
    )[:, 0]
    np.testing.assert_allclose(lp, expected, rtol=1e-8)
    ve = np.asarray(lik.variational_expectations(X, FmuK, FvarK, Y))
    assert np.all(np.isfinite(ve))


def test_heteroskedastic_conditional():
    lik = likelihoods.HeteroskedasticTFPConditional()
    F2 = np.concatenate([Fmu, -0.5 * np.ones((N, 1))], axis=1)
    Y = rng.randn(N, 1)
    lp = np.asarray(lik.log_prob(X, F2, Y))
    scale = np.exp(-0.5)
    from scipy import stats

    expected = stats.norm.logpdf(Y[:, 0], loc=Fmu[:, 0], scale=scale)
    np.testing.assert_allclose(lp, expected, rtol=1e-8)
    Fmu2 = np.concatenate([Fmu, -0.5 * np.ones((N, 1))], axis=1)
    Fvar2 = np.concatenate([Fvar, 0.01 * np.ones((N, 1))], axis=1)
    ve = np.asarray(lik.variational_expectations(X, Fmu2, Fvar2, Y))
    assert ve.shape == (N,) and np.all(np.isfinite(ve))


def test_gaussian_functional_variance():
    from gpflow_tpu_torch import functions

    noise_fn = functions.Linear(A=np.ones((2, 1)), b=np.array([1.5]))
    lik = likelihoods.Gaussian(variance=noise_fn)
    v = np.asarray(lik.variance_at(X))
    expected = np.maximum(X @ np.ones((2, 1)) + 1.5, lik.variance_lower_bound)
    np.testing.assert_allclose(v, expected, rtol=1e-10)


def test_mean_functions():
    from gpflow_tpu_torch import functions

    Xf = rng.randn(N, 2)
    lin = functions.Linear(A=rng.randn(2, 3), b=rng.randn(3))
    np.testing.assert_allclose(
        np.asarray(lin(Xf)), Xf @ np.asarray(lin.A.value) + np.asarray(lin.b.value), rtol=1e-10
    )
    zero = functions.Zero(output_dim=2)
    assert np.asarray(zero(Xf)).shape == (N, 2)
    const = functions.Constant(c=np.array([1.0, 2.0]))
    np.testing.assert_allclose(np.asarray(const(Xf)), np.tile([1.0, 2.0], (N, 1)))
    add = lin + lin
    np.testing.assert_allclose(np.asarray(add(Xf)), 2 * np.asarray(lin(Xf)), rtol=1e-10)
    poly = functions.Polynomial(degree=2, input_dim=2, output_dim=1)
    assert np.asarray(poly(Xf)).shape == (N, 1)
    # switched function
    sw = functions.SwitchedFunction([functions.Constant(np.array([1.0])), functions.Constant(np.array([5.0]))])
    Xsw = np.concatenate([Xf, rng.randint(0, 2, (N, 1)).astype(float)], axis=1)
    out = np.asarray(sw(Xsw))
    np.testing.assert_allclose(out[:, 0], np.where(Xsw[:, -1] == 0, 1.0, 5.0))


def test_no_missing_likelihoods():
    """Every concrete likelihood class must be exercised by some test module
    (coverage-by-construction, reference ``test_likelihoods.py:142-173``)."""
    from gpflow_tpu_torch.ci_utils import subclasses

    tested_here = {type(lik) for lik, _ in LIKELIHOOD_SETUPS}
    abstract = {
        likelihoods.Likelihood,
        likelihoods.QuadratureLikelihood,
        likelihoods.ScalarLikelihood,
        likelihoods.MonteCarloLikelihood,
        likelihoods.MultiLatentLikelihood,
    }
    tested_elsewhere = {
        likelihoods.SwitchedLikelihood,  # test_switched_likelihood.py
        likelihoods.MultiLatentTFPConditional,  # test_heteroskedastic.py
        likelihoods.HeteroskedasticTFPConditional,  # test_heteroskedastic.py
        likelihoods.GaussianMC,  # test_montecarlo below
        likelihoods.Softmax,  # test_softmax_mc / test_multiclass.py
        likelihoods.MultiClass,  # test_multiclass.py + test_multiclass_robustmax
    }
    for cls in set(subclasses(likelihoods.Likelihood)):
        if cls in abstract or cls in tested_elsewhere:
            continue
        assert cls in tested_here, f"no test for likelihood class {cls}"


@pytest.mark.parametrize(
    "lik,y_gen", LIKELIHOOD_SETUPS, ids=lambda s: type(s).__name__ if not callable(s) else ""
)
def test_conditional_mean_variance_consistent_at_zero_variance(lik, y_gen):
    """With Fvar=0, predict_mean_and_var must reduce to
    (conditional_mean, conditional_variance) (reference
    ``test_likelihoods.py:176-190``)."""
    zero = np.zeros_like(Fmu)
    mu1 = np.asarray(lik.conditional_mean(X, Fmu))
    var1 = np.asarray(lik.conditional_variance(X, Fmu))
    mu2, var2 = (np.asarray(a) for a in lik.predict_mean_and_var(X, Fmu, zero))
    np.testing.assert_allclose(mu1, mu2, rtol=5e-6, atol=1e-7)
    np.testing.assert_allclose(var1, var2, rtol=5e-6, atol=1e-7)


@pytest.mark.parametrize(
    "lik,y_gen", LIKELIHOOD_SETUPS, ids=lambda s: type(s).__name__ if not callable(s) else ""
)
def test_variational_expectations_zero_variance_equals_log_prob(lik, y_gen):
    """With Fvar=0 the variational expectation IS the log likelihood
    (reference ``test_likelihoods.py:193-207``)."""
    Y = y_gen()
    zero = np.zeros_like(F)
    ve = np.asarray(lik.variational_expectations(X, F, zero, Y))
    lp = np.asarray(lik.log_prob(X, F, Y))
    np.testing.assert_allclose(ve, lp, rtol=5e-6, atol=1e-7)
