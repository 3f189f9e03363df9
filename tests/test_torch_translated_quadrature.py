"""The JAX package's ``tests/gpflow_tpu/quadrature/test_quadrature.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Quadrature module tests (patterns from reference
``tests/gpflow/quadrature``).
"""
import numpy as np
import pytest
from scipy import stats
import torch

from gpflow_tpu_torch.quadrature import (
    NDiagGHQuadrature,
    gh_points_and_weights,
    mvnquad,
    ndiag_mc,
    ndiagquad,
)
from . import test_torch_translated_support as support
from .test_torch_translated_support import X64, asarray, deviation, polyval, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)


def test_gh_points_integrate_standard_normal_moments():
    z, dz = gh_points_and_weights(30)
    assert np.isclose(np.sum(dz), 1.0)
    assert np.isclose(np.sum(dz * z), 0.0, atol=1e-12)
    assert np.isclose(np.sum(dz * z ** 2), 1.0)
    assert np.isclose(np.sum(dz * z ** 4), 3.0)


def test_ndiag_gh_2d():
    q = NDiagGHQuadrature(2, 15)
    mean = asarray([[0.5, -1.0]])
    var = asarray([[0.3, 2.0]])
    # E[x0 * x1] = mu0 * mu1 for independent gaussians
    r = q(lambda X: (X[..., 0] * X[..., 1])[..., None], mean, var)
    np.testing.assert_allclose(np.asarray(r)[0, 0], 0.5 * -1.0, rtol=1e-8)
    # E[exp(x)] = exp(mu + var/2) per dim
    r = q(lambda X: torch.exp(X[..., :1]), mean, var)
    np.testing.assert_allclose(np.asarray(r)[0, 0], np.exp(0.5 + 0.15), rtol=1e-8)


def test_logspace_matches_linear():
    q = NDiagGHQuadrature(1, 25)
    mean = asarray([[0.2]])
    var = asarray([[0.7]])
    fun = lambda X: -0.5 * X ** 2
    linear = np.log(np.asarray(q(lambda X: torch.exp(fun(X)), mean, var)))
    logspace = np.asarray(q.logspace(fun, mean, var))
    np.testing.assert_allclose(linear, logspace, rtol=1e-10)


def test_ndiagquad_back_compat():
    Fmu = rng.randn(7, 1)
    Fvar = 0.1 + rng.rand(7, 1)
    Y = rng.randn(7, 1)
    r = ndiagquad(lambda F, Y: -0.5 * (F - Y) ** 2, 20, Fmu, Fvar, Y=Y)
    expected = -0.5 * ((Fmu - Y) ** 2 + Fvar)
    np.testing.assert_allclose(np.asarray(r), expected, rtol=1e-8)
    # list of functions
    r1, r2 = ndiagquad([lambda F, Y: F, lambda F, Y: F ** 2], 20, Fmu, Fvar, Y=Y)
    np.testing.assert_allclose(np.asarray(r1), Fmu, atol=1e-8)
    np.testing.assert_allclose(np.asarray(r2), Fmu ** 2 + Fvar, rtol=1e-8)


def test_mvnquad_full_covariance():
    N, D = 4, 2
    means = rng.randn(N, D)
    a = 0.3 * rng.randn(N, D, D)
    covs = np.einsum("nij,nkj->nik", a, a) + 0.2 * np.eye(D)
    # E[x x^T] = cov + mu mu^T; check E[x0*x1]
    r = np.asarray(mvnquad(lambda X: (X[:, 0] * X[:, 1])[:, None], asarray(means), asarray(covs), 20))
    expected = covs[:, 0, 1] + means[:, 0] * means[:, 1]
    np.testing.assert_allclose(r[:, 0], expected, rtol=1e-6)


def test_ndiag_mc_close_to_quadrature():
    Fmu = asarray(rng.randn(5, 1))
    Fvar = asarray(0.1 + rng.rand(5, 1))
    r_mc = np.asarray(ndiag_mc(lambda F: F ** 2, 50_000, Fmu, Fvar))
    expected = np.asarray(Fmu) ** 2 + np.asarray(Fvar)
    np.testing.assert_allclose(r_mc, expected, atol=0.05)


def test_grid_helpers_match_ndgh():
    """list_to_flat_grid / repeat_as_list / reshape_Z_dZ (reference
    gauss_hermite.py:49-90): weights sum to one and the grid integrates
    polynomials exactly regardless of point ordering."""
    from gpflow_tpu_torch.quadrature import (
        gh_points_and_weights,
        list_to_flat_grid,
        ndgh_points_and_weights,
        repeat_as_list,
        reshape_Z_dZ,
    )

    z, dz = gh_points_and_weights(6)
    zs, dzs = repeat_as_list(z, 3), repeat_as_list(dz, 3)
    assert len(zs) == 3 and zs[0] is z
    Z, dZ = reshape_Z_dZ(zs, dzs)
    assert Z.shape == (6 ** 3, 3) and dZ.shape == (6 ** 3, 1)
    np.testing.assert_allclose(dZ.sum(), 1.0, rtol=1e-12)
    # same moments as the itertools-product grid used by NDiagGHQuadrature
    Z2, dZ2 = ndgh_points_and_weights(3, 6)
    for power in (1, 2, 3, 4):
        np.testing.assert_allclose(
            (dZ * Z ** power).sum(axis=0),
            (dZ2 * Z2 ** power).sum(axis=0),
            atol=1e-10,
        )
    grid = list_to_flat_grid([np.array([0.0, 1.0]), np.array([2.0, 3.0, 4.0])])
    assert grid.shape == (6, 2)
    assert {tuple(r) for r in grid} == {(a, b) for a in (0.0, 1.0) for b in (2.0, 3.0, 4.0)}


@pytest.mark.parametrize("seed", range(8))
def test_ndiag_gh_random_polynomial_moments_exact(seed):
    """Fuzz: an n-point GH rule integrates polynomials up to degree 2n-1
    EXACTLY under any diagonal Gaussian — random means/vars/coefficients."""
    r = np.random.RandomState(8000 + seed)
    n_gh = r.randint(3, 12)
    deg = 2 * n_gh - 1
    # random polynomial of degree <= 2n-1 (keep coefficients small)
    coeffs = 0.5 * r.randn(deg + 1) / (np.arange(deg + 1) + 1.0) ** 2
    mu = r.randn(4, 1)
    var = 0.2 + r.rand(4, 1)

    quad = NDiagGHQuadrature(1, n_gh)
    got = np.asarray(
        quad(lambda X: polyval(asarray(coeffs), X[..., 0:1]), mu, var)
    )

    # oracle: E[p(X)] via central moments of N(mu, var): E[(x)^k] closed form
    from math import comb

    def gaussian_raw_moment(m, v, k):
        # sum_{j even} C(k, j) m^{k-j} v^{j/2} (j-1)!!
        total = 0.0
        for j in range(0, k + 1, 2):
            dfact = np.prod(np.arange(j - 1, 0, -2)) if j > 1 else 1.0
            total += comb(k, j) * m ** (k - j) * v ** (j / 2) * dfact
        return total

    expected = np.zeros((4, 1))
    for i in range(4):
        for k, c in enumerate(coeffs[::-1]):  # coeffs is highest-first
            expected[i, 0] += c * gaussian_raw_moment(mu[i, 0], var[i, 0], k)
    np.testing.assert_allclose(got, expected, rtol=1e-8, atol=1e-10)


def test_quadrature_gradient_finite_at_clamped_variance():
    """sqrt(maximum(var, 0)) has a NaN gradient exactly where the clamp
    engages; the double-where form must give finite (zero)
    gradients at var <= 0 for both the GH and MC paths."""

    quad = NDiagGHQuadrature(1, 5)

    def gh_loss(var):
        mu = torch.zeros((3, 1), **X64)
        return torch.sum(quad(lambda X: X ** 2, mu, var))

    g = support.grad(gh_loss)(asarray([[0.5], [0.0], [-1e-8]]))
    assert np.isfinite(np.asarray(g)).all()
    np.testing.assert_allclose(np.asarray(g)[1:], 0.0)  # clamped branch

    def mc_loss(var):
        mu = torch.zeros((3, 1), **X64)
        eps = torch.ones((10, 3, 1), **X64)
        return torch.sum(ndiag_mc(lambda F: F ** 2, 10, mu, var, epsilon=eps))

    gm = support.grad(mc_loss)(asarray([[0.5], [0.0], [-1e-8]]))
    assert np.isfinite(np.asarray(gm)).all()
    np.testing.assert_allclose(np.asarray(gm)[1:], 0.0)


@deviation("the draws")
def test_ndiag_mc_default_noise_varies():
    """Default epsilon must NOT be one frozen realization:
    eager calls draw fresh noise; under jit the draws change whenever the
    predictive moments change (every optimization step)."""

    Fmu = asarray(rng.randn(4, 1))
    Fvar = asarray(0.5 + rng.rand(4, 1))
    f = lambda F: F ** 3  # odd power: MC value moves with the draws
    a = np.asarray(ndiag_mc(f, 50, Fmu, Fvar))
    b = np.asarray(ndiag_mc(f, 50, Fmu, Fvar))
    assert not np.allclose(a, b), "eager default epsilon must be fresh per call"

    jf = (lambda mu, var: ndiag_mc(f, 50, mu, var))
    c1 = np.asarray(jf(Fmu, Fvar))
    c2 = np.asarray(jf(Fmu, Fvar))
    np.testing.assert_allclose(c1, c2)  # same inputs -> deterministic
    c3 = np.asarray(jf(Fmu + 0.01, Fvar))
    exact_shift = np.asarray(jf(Fmu, Fvar))  # same draws would shift exactly
    assert not np.allclose(c3 - c1, 0.0)
    # the draws actually changed: c3 is not just c1 evaluated at shifted mu
    # with identical epsilon (which for F^3 would differ from c1 smoothly by
    # ~3 mu^2 * 0.01); instead a different realization moves it by O(mc err)
    assert not np.allclose(c3, c1, atol=1e-6)


def test_ndgh_ordering_matches_grid_helpers():
    """ndgh_points_and_weights must share the exported helpers' point
    ordering (a private itertools grid ordered points
    differently, silently permuting user-side comparisons)."""
    from gpflow_tpu_torch.quadrature import (
        gh_points_and_weights,
        ndgh_points_and_weights,
        repeat_as_list,
        reshape_Z_dZ,
    )

    z, dz = gh_points_and_weights(4)
    Z_h, dZ_h = reshape_Z_dZ(repeat_as_list(z, 2), repeat_as_list(dz, 2))
    Z, dZ = ndgh_points_and_weights(2, 4)
    np.testing.assert_allclose(Z, Z_h)
    np.testing.assert_allclose(dZ, dZ_h)


def test_ndiagquad_scalar_input():
    """0-d Fmu/Fvar must work (reference handles it via one tf.reshape)."""
    out = ndiagquad(lambda F: F ** 2, 20, asarray(1.5), asarray(0.25))
    assert np.shape(np.asarray(out)) == ()
    np.testing.assert_allclose(float(out), 1.5 ** 2 + 0.25, rtol=1e-10)
