"""The older quadrature helpers of gpflow_tpu_torch (``quadrature/deprecated.py``)
against gpflow_tpu's on the CPU, in float64: ``hermgauss``, ``mvhermgauss``,
``ndiagquad`` (one and two dimensions, lists of functions, log space),
``ndiag_mc`` (a shared ``epsilon``, log space, the zero gradient where the
variance is clamped, the draws from a generator) and ``mvnquad``. Both
sides sum the same terms in the same formulas: 1e-10 relative, with 1e-10
of the largest entry as an absolute floor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflow_tpu import quadrature as jax_quadrature
from gpflow_tpu_torch import config, quadrature

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
N = 9
_rng = np.random.RandomState(5)
FMU, FVAR, YS = _rng.randn(N, 1), 0.05 + _rng.rand(N, 1), _rng.randn(N, 1)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("n", [1, 5, 20])
def test_hermgauss_matches_jax(n):
    for got, want in zip(quadrature.hermgauss(n), jax_quadrature.hermgauss(n)):
        assert got.dtype == np.float64
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("H,D", [(3, 1), (4, 2), (3, 3)])
def test_mvhermgauss_matches_jax(H, D):
    for got, want in zip(quadrature.mvhermgauss(H, D), jax_quadrature.mvhermgauss(H, D)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("logspace", [False, True])
def test_ndiagquad_one_dimension_matches_jax(logspace):
    def f_port(F, Y):
        return -0.5 * (F - Y) ** 2

    def f_jax(F, Y):
        return -0.5 * (F - Y) ** 2

    _close(quadrature.ndiagquad(f_port, 20, _t(FMU), _t(FVAR), logspace=logspace, Y=_t(YS)),
           jax_quadrature.ndiagquad(f_jax, 20, FMU, FVAR, logspace=logspace, Y=YS))


def test_ndiagquad_list_and_two_dimensions_match_jax():
    got = quadrature.ndiagquad([lambda F, Y: F, lambda F, Y: F ** 2 * Y], 20, _t(FMU), _t(FVAR), Y=_t(YS))
    want = jax_quadrature.ndiagquad([lambda F, Y: F, lambda F, Y: F ** 2 * Y], 20, FMU, FVAR, Y=YS)
    assert isinstance(got, list) and len(got) == 2
    for g, w in zip(got, want):
        _close(g, w)
    mu2, var2 = _rng.randn(N, 1), 0.1 + _rng.rand(N, 1)
    got = quadrature.ndiagquad(lambda a, b: a * b + a ** 2, 8, (_t(FMU), _t(mu2)), (_t(FVAR), _t(var2)))
    want = jax_quadrature.ndiagquad(lambda a, b: a * b + a ** 2, 8, (FMU, mu2), (FVAR, var2))
    _close(got, want)


@pytest.mark.parametrize("logspace", [False, True])
def test_ndiag_mc_matches_jax_with_shared_epsilon(logspace):
    Fmu, Fvar = _rng.randn(N, 2), 0.1 + _rng.rand(N, 2)
    eps = np.random.RandomState(6).randn(40, N, 2)
    fs = [lambda F, Y: F * Y, lambda F, Y: -(F ** 2)]
    got = quadrature.ndiag_mc(fs, 40, _t(Fmu), _t(Fvar), logspace, _t(eps), Y=_t(YS))
    want = jax_quadrature.ndiag_mc(fs, 40, Fmu, Fvar, logspace, eps, Y=YS)
    for g, w in zip(got, want):
        _close(g, w)


def test_ndiag_mc_gradient_is_zero_where_the_variance_is_clamped():
    # as tests/gpflow_tpu/quadrature/test_quadrature.py checks the JAX package
    var = torch.tensor([[0.5], [0.0], [-1e-8]], dtype=torch.float64, requires_grad=True)
    torch.sum(quadrature.ndiag_mc(lambda F: F ** 2, 10, torch.zeros(3, 1, dtype=torch.float64), var,
                                  epsilon=torch.ones(10, 3, 1, dtype=torch.float64))).backward()
    want = jax.grad(lambda v: jnp.sum(jax_quadrature.ndiag_mc(lambda F: F ** 2, 10, jnp.zeros((3, 1)), v,
                                                              epsilon=jnp.ones((10, 3, 1)))))(
        jnp.asarray([[0.5], [0.0], [-1e-8]]))
    assert bool(torch.isfinite(var.grad).all())
    np.testing.assert_allclose(var.grad[1:].numpy(), 0.0)
    _close(var.grad, want)


def test_ndiag_mc_draws_from_the_generator():
    def f(F):
        return F ** 3

    mu, var = _t(FMU), _t(FVAR)
    a = quadrature.ndiag_mc(f, 50, mu, var, generator=torch.Generator().manual_seed(3))
    b = quadrature.ndiag_mc(f, 50, mu, var, generator=torch.Generator().manual_seed(3))
    c = quadrature.ndiag_mc(f, 50, mu, var)
    d = quadrature.ndiag_mc(f, 50, mu, var)
    _close(a, b, 0.0)
    assert not np.allclose(_np(c), _np(d)), "draws without a generator must be fresh per call"
    eps = torch.randn(50, N, 1, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    _close(quadrature.ndiag_mc(f, 50, mu, var, epsilon=eps), a, 0.0)


@pytest.mark.parametrize("Din", [1, 2])
def test_mvnquad_matches_jax(Din):
    rng = np.random.RandomState(7 + Din)
    means = rng.randn(4, Din)
    A = rng.randn(4, Din, Din)
    covs = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(Din)

    def f_port(X):
        return torch.stack([X.sum(-1), (X ** 2).prod(-1)], -1)

    def f_jax(X):
        return jnp.stack([X.sum(-1), (X ** 2).prod(-1)], -1)

    got = quadrature.mvnquad(f_port, _t(means), _t(covs), 10)
    want = jax_quadrature.mvnquad(f_jax, jnp.asarray(means), jnp.asarray(covs), 10)
    assert got.shape == (4, 2)
    _close(got, want)
