"""The JAX package's ``tests/gpflow_tpu/likelihoods/test_multiclass.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Multiclass likelihood depth tests (pattern from reference
``tests/gpflow/likelihoods/test_multiclass.py``): RobustMax invlink values,
the GH ``prob_is_largest`` trick against a Monte Carlo oracle, and the
closed-form variational expectations identity.
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch import likelihoods
from .test_torch_translated_support import X64, translated_test_environment  # noqa: F401

rng = np.random.RandomState(3)
K = 4
N = 6
Fmu = rng.randn(N, K)
Fvar = np.exp(0.5 * rng.randn(N, K))
Y = rng.randint(0, K, (N, 1)).astype(float)
X = rng.randn(N, 2)


def test_robustmax_invlink_values():
    eps = 0.1
    rm = likelihoods.RobustMax(K, epsilon=eps)
    F = rng.randn(N, K)
    p = np.asarray(rm(F))
    argmax = F.argmax(axis=1)
    for n in range(N):
        for k in range(K):
            expected = 1 - eps if k == argmax[n] else eps / (K - 1)
            np.testing.assert_allclose(p[n, k], expected, rtol=1e-12)


def test_prob_is_largest_vs_monte_carlo():
    """The Gauss-Hermite P(f_y = max_k f_k) against brute-force sampling."""
    lik = likelihoods.MultiClass(K)
    # predict_mean_and_var's mean[n, k] = P(argmax f = k)*(1-eps) + ...;
    # recover P(is largest) from the conditional mean through the invlink
    eps = float(lik.invlink.epsilon.value)
    mean, _ = lik.predict_mean_and_var(X, Fmu, Fvar)
    mean = np.asarray(mean)

    S = 200_000
    r = np.random.RandomState(11)
    f = Fmu[None] + np.sqrt(Fvar)[None] * r.randn(S, N, K)
    p_largest_mc = np.stack(
        [(f.argmax(axis=2) == k).mean(axis=0) for k in range(K)], axis=1
    )
    mean_mc = p_largest_mc * (1 - eps) + (1 - p_largest_mc) * eps / (K - 1)
    np.testing.assert_allclose(mean, mean_mc, atol=5e-3)
    # rows are probability vectors up to GH-quadrature truncation error
    np.testing.assert_allclose(mean.sum(axis=1), 1.0, atol=1e-3)


def test_variational_expectations_closed_form_identity():
    """var_exp = log(1-eps) P(largest) + log(eps/(K-1)) (1 - P(largest));
    recover P from predict_mean_and_var and check the identity."""
    lik = likelihoods.MultiClass(K)
    eps = float(lik.invlink.epsilon.value)
    mean, _ = lik.predict_mean_and_var(X, Fmu, Fvar)
    mean = np.asarray(mean)
    p_largest = (mean - eps / (K - 1)) / (1 - eps - eps / (K - 1))
    p_y = np.take_along_axis(p_largest, Y.astype(int), axis=1)[:, 0]
    expected = np.log(1 - eps) * p_y + np.log(eps / (K - 1)) * (1 - p_y)
    ve = np.asarray(lik.variational_expectations(X, Fmu, Fvar, Y))
    np.testing.assert_allclose(ve, expected, atol=1e-8)


def test_predict_log_density_matches_mean():
    """log-density of the observed class = log E[p(y|f)] = log mean_y."""
    lik = likelihoods.MultiClass(K)
    mean, _ = lik.predict_mean_and_var(X, Fmu, Fvar)
    expected = np.log(np.take_along_axis(np.asarray(mean), Y.astype(int), axis=1))[:, 0]
    ld = np.asarray(lik.predict_log_density(X, Fmu, Fvar, Y))
    np.testing.assert_allclose(ld, expected, atol=1e-8)


def test_robustmax_epsilon_k1_limits():
    rm = likelihoods.RobustMax(K, epsilon=1e-3)
    F = rng.randn(N, K) * 10
    p = np.asarray(rm(F))
    np.testing.assert_allclose(p.sum(axis=1), 1.0, rtol=1e-12)
    assert (p > 0).all() and (p < 1).all()


def test_multiclass_rejects_bad_num_classes():
    lik = likelihoods.MultiClass(K)
    with pytest.raises(Exception):
        # wrong latent dimension
        lik.variational_expectations(X, Fmu[:, : K - 1], Fvar[:, : K - 1], Y)


def test_softmax_bernoulli_equivalence():
    """Two-class softmax with the second logit pinned to 0 IS a sigmoid
    Bernoulli (reference ``test_multiclass.py:53-96``): log_prob,
    conditional mean/variance exactly; MC predict/varexp statistically."""

    num, dimF = 8, 2
    r = np.random.RandomState(4)
    F2 = np.vstack((r.randn(num - 3, dimF), np.array([[-3.0, 0.0], [3.0, 0.0], [0.0, 0.0]])))
    Yb = (np.vstack((r.randn(num - 3, 1), np.ones((3, 1)))) > 0).astype(float)
    X = r.randn(num, 3)
    Fvar = np.exp(np.stack([F2[:, 1], -10.0 + np.zeros(num)], axis=1))
    F = np.stack([F2[:, 0], np.zeros(num)], axis=1)
    Ylabel = 1.0 - Yb

    sigmoid = lambda x: 1.0 / (1.0 + torch.exp(-x))
    softmax_lik = likelihoods.Softmax(dimF)
    bernoulli_lik = likelihoods.Bernoulli(invlink=sigmoid)

    np.testing.assert_allclose(
        np.asarray(softmax_lik.conditional_mean(X, F))[:, :1],
        np.asarray(bernoulli_lik.conditional_mean(X, F[:, :1])),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(softmax_lik.conditional_variance(X, F))[:, :1],
        np.asarray(bernoulli_lik.conditional_variance(X, F[:, :1])),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(softmax_lik.log_prob(X, F, Ylabel)),
        np.asarray(bernoulli_lik.log_prob(X, F[:, :1], Yb)),
        rtol=1e-10,
    )

    # Monte-Carlo vs Gauss-Hermite: statistical agreement
    softmax_lik.num_monte_carlo_points = 300_000
    mean1, var1 = (np.asarray(a) for a in softmax_lik.predict_mean_and_var(X, F, Fvar))
    mean2, var2 = (np.asarray(a) for a in bernoulli_lik.predict_mean_and_var(X, F[:, :1], Fvar[:, :1]))
    np.testing.assert_allclose(mean1[:, :1], mean2, rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(var1[:, :1], var2, rtol=5e-3, atol=5e-3)

    ve1 = np.asarray(softmax_lik.variational_expectations(X, F, Fvar, Ylabel))
    ve2 = np.asarray(bernoulli_lik.variational_expectations(X, F[:, :1], Fvar[:, :1], Yb))
    np.testing.assert_allclose(ve1, ve2, rtol=1e-2, atol=1e-2)


def test_robust_max_multiclass_symmetric():
    """Symmetric latents => uniform class probabilities with the robust-max
    smoothing (reference ``test_multiclass.py:100-138``)."""
    num_classes, num_points, epsilon, tol = 10, 3, 1e-3, 1e-4
    r = np.random.RandomState(1)
    p = 1.0 / num_classes
    X = np.ones((num_points, 1))
    F = np.ones((num_points, num_classes))
    Y = r.randint(num_classes, size=(num_points, 1)).astype(float)

    lik = likelihoods.MultiClass(num_classes)
    lik.invlink.epsilon.assign(epsilon)

    mu, _ = (np.asarray(a) for a in lik.predict_mean_and_var(X, F, F))
    pred = np.asarray(lik.predict_log_density(X, F, F, Y))
    ve = np.asarray(lik.variational_expectations(X, F, F, Y))

    expected_mu = (p * (1.0 - epsilon) + (1.0 - p) * epsilon / (num_classes - 1)) * np.ones(
        (num_points, 1)
    )
    assert np.allclose(mu, expected_mu, tol, tol)
    assert np.allclose(pred, np.log(expected_mu), 1e-3, 1e-3)
    expected_ve = p * np.log(1.0 - epsilon) + (1.0 - p) * np.log(epsilon / (num_classes - 1))
    np.testing.assert_allclose(ve, np.full(num_points, expected_ve), rtol=tol, atol=tol)


def test_robust_max_multiclass_predict_log_density_mocked():
    """With prob_is_largest mocked to a constant, predict_log_density has a
    closed form (reference ``test_multiclass.py:149-178``)."""
    num_classes, num_points, mock_prob, epsilon = 5, 100, 0.73, 0.231
    expected = -0.5499780059  # log((1-eps)*0.73 + 0.27*eps/(K-1))

    class MockRobustMax(likelihoods.RobustMax):
        def prob_is_largest(self, Y, mu, var, gh_x, gh_w):
            return torch.ones((num_points, 1), **X64) * mock_prob

    lik = likelihoods.MultiClass(num_classes, invlink=MockRobustMax(num_classes, epsilon))
    X = np.ones((num_points, 2))
    F = np.ones((num_points, num_classes))
    Y = np.random.RandomState(1).randint(num_classes, size=(num_points, 1)).astype(float)
    pred = np.asarray(lik.predict_log_density(X, F, F, Y))
    np.testing.assert_allclose(pred, expected, rtol=1e-4, atol=1e-4)


def test_robust_max_eps_k1_tracks_epsilon():
    """eps_k1 must recompute when epsilon changes (reference
    ``test_multiclass.py:181-198``)."""
    for num_classes in (5, 100):
        rm = likelihoods.RobustMax(num_classes, 1e-3)
        np.testing.assert_allclose(float(rm.eps_k1), 1e-3 / (num_classes - 1.0), rtol=1e-12)
        rm.epsilon.assign(0.412)
        np.testing.assert_allclose(float(rm.eps_k1), 0.412 / (num_classes - 1.0), rtol=1e-12)


def test_softmax_invalid_label_is_nan_not_wrapped():
    """JAX gathers wrap negative labels (and clamp over-range inside jit):
    a -1 sentinel must NOT silently score the last class."""

    from gpflow_tpu_torch import likelihoods

    lik = likelihoods.Softmax(3)
    F = rng.randn(4, 3)
    X = rng.randn(4, 2)
    Y = np.array([[0], [2], [-1], [3]], dtype=float)
    lp = np.asarray(lik.log_prob(X, F, Y))
    assert np.isfinite(lp[:2]).all()
    assert np.isnan(lp[2]) and np.isnan(lp[3])
    # same under jit (where TPU gather clamping would otherwise hide it)
    lp_j = np.asarray((lambda f, y: lik.log_prob(X, f, y))(F, Y))
    np.testing.assert_array_equal(np.isnan(lp_j), np.isnan(lp))


def test_ordinal_invalid_label_is_nan_not_wrapped():

    from gpflow_tpu_torch import likelihoods

    lik = likelihoods.Ordinal(np.array([-0.5, 0.5]))  # 3 bins: labels 0..2
    F = rng.randn(4, 1)
    X = rng.randn(4, 2)
    Y = np.array([[0], [2], [-1], [3]], dtype=float)
    lp = np.asarray(lik.log_prob(X, F, Y))
    assert np.isfinite(lp[:2]).all()
    assert np.isnan(lp[2]) and np.isnan(lp[3])
    lp_j = np.asarray((lambda f, y: lik.log_prob(X, f, y))(F, Y))
    np.testing.assert_array_equal(np.isnan(lp_j), np.isnan(lp))


def test_robustmax_call_broadcasts_leading_batch_dims():
    """__call__'s contract admits leading batch dims (quadrature/sample-
    expanded F); the argmax must reduce the LATENT axis, so a rank-3 input
    must equal the row-by-row rank-2 result (argmax over axis=1 would
    silently reduce a batch dim instead)."""
    K = 3
    rm = likelihoods.RobustMax(K, epsilon=1e-3)
    rng = np.random.RandomState(7)
    F = rng.randn(4, 5, K)
    batched = np.asarray(rm(F))
    assert batched.shape == (4, 5, K)
    for s in range(4):
        np.testing.assert_allclose(batched[s], np.asarray(rm(F[s])), rtol=1e-12)
    # probabilities: 1-eps at the argmax, eps/(K-1) elsewhere, rows sum to 1
    np.testing.assert_allclose(batched.sum(-1), 1.0, rtol=1e-9)
