"""Gauss-Hermite quadrature of gpflow_tpu_torch against gpflow_tpu on the CPU:
the points and weights, the grid helpers, ``NDiagGHQuadrature.__call__`` and
``logspace`` in one and two dimensions, and the clamped variance. The points
come from the same numpy call in both packages, so they must be equal; the
quadratures are the same float64 sums in another order, held to 1e-12."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflow_tpu import quadrature as jax_quadrature
from gpflow_tpu_torch import config, quadrature

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-12


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


@pytest.mark.parametrize("n_gh", [1, 5, 20, 31])
def test_gh_points_and_weights_equal_jax(n_gh):
    for got, want in zip(quadrature.gh_points_and_weights(n_gh), jax_quadrature.gh_points_and_weights(n_gh)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dim,n_gh", [(1, 20), (2, 4), (3, 3)])
def test_grid_helpers_equal_jax(dim, n_gh):
    for got, want in zip(quadrature.ndgh_points_and_weights(dim, n_gh),
                         jax_quadrature.ndgh_points_and_weights(dim, n_gh)):
        np.testing.assert_array_equal(got, want)
    xs = [np.arange(2.0), np.arange(3.0) + 5, np.arange(4.0) - 2][:dim]
    np.testing.assert_array_equal(quadrature.list_to_flat_grid(xs), jax_quadrature.list_to_flat_grid(xs))
    z, dz = quadrature.gh_points_and_weights(n_gh)
    zs = quadrature.repeat_as_list(z, dim)
    assert len(zs) == dim and all(a is z for a in zs)
    for got, want in zip(quadrature.reshape_Z_dZ(zs, quadrature.repeat_as_list(dz, dim)),
                         jax_quadrature.reshape_Z_dZ(zs, jax_quadrature.repeat_as_list(dz, dim))):
        np.testing.assert_array_equal(got, want)
    q = quadrature.NDiagGHQuadrature(dim, n_gh)
    assert q.n_gh_total == n_gh ** dim
    np.testing.assert_array_equal(q.Z, jax_quadrature.NDiagGHQuadrature(dim, n_gh).Z)


def _integrands(dim):
    """Pairs of (port, JAX) integrands of X [N_quad, batch..., dim] and a
    keyword argument Y [batch..., 1]."""
    return [
        (lambda X, Y: torch.exp(-0.5 * torch.square(X[..., :1] - Y)) * torch.sum(X, -1, keepdim=True),
         lambda X, Y: jnp.exp(-0.5 * jnp.square(X[..., :1] - Y)) * jnp.sum(X, -1, keepdims=True)),
        (lambda X, Y: torch.sin(X) + Y, lambda X, Y: jnp.sin(X) + Y),
    ][: 2 if dim == 1 else 1]


@pytest.mark.parametrize("method", ["__call__", "logspace"])
@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("batch", [(7,), (3, 5)])
def test_ndiag_quadrature_matches_jax_f64(method, dim, batch):
    rng = np.random.RandomState(dim + len(batch))
    mean, var = rng.randn(*batch, dim), 0.1 + rng.rand(*batch, dim)
    Y = rng.randn(*batch, 1)
    n_gh = 20 if dim == 1 else 8
    pq, jq = quadrature.NDiagGHQuadrature(dim, n_gh), jax_quadrature.NDiagGHQuadrature(dim, n_gh)
    funs = _integrands(dim)
    pt = [torch.from_numpy(a) for a in (mean, var, Y)]
    for pf, jf in funs:
        if method == "logspace":
            pf_, jf_ = (lambda X, Y, f=pf: torch.log(f(X, Y) ** 2 + 1.0)), (lambda X, Y, f=jf: jnp.log(f(X, Y) ** 2 + 1.0))
        else:
            pf_, jf_ = pf, jf
        _close(getattr(pq, method)(pf_, pt[0], pt[1], Y=pt[2]), getattr(jq, method)(jf_, mean, var, Y=Y))
    # a list of integrands gives a list of results
    got = getattr(pq, method)([f for f, _ in funs], pt[0], pt[1], Y=pt[2])
    want = getattr(jq, method)([f for _, f in funs], mean, var, Y=Y)
    assert isinstance(got, list) and len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)


def test_quadrature_gradient_matches_jax_f64():
    rng = np.random.RandomState(3)
    mean, var = rng.randn(6, 1), 0.2 + rng.rand(6, 1)

    def jax_fn(m, v):
        return jnp.sum(jax_quadrature.NDiagGHQuadrature(1, 20)(lambda X: jnp.cos(X) * X, m, v))

    want = jax.grad(jax_fn, argnums=(0, 1))(jnp.asarray(mean), jnp.asarray(var))
    m, v = (torch.tensor(a, requires_grad=True) for a in (mean, var))
    torch.sum(quadrature.NDiagGHQuadrature(1, 20)(lambda X: torch.cos(X) * X, m, v)).backward()
    _close(m.grad, want[0])
    _close(v.grad, want[1])


def test_clamped_variance_gives_the_mean_and_a_finite_gradient():
    # a variance that rounding left at or below zero evaluates the integrand
    # at the mean, and the double where keeps its gradient finite (zero)
    q = quadrature.NDiagGHQuadrature(1, 5)
    X, _ = q._build_X_W(torch.tensor([[0.7]], dtype=torch.float64), torch.tensor([[-1e-3]], dtype=torch.float64))
    assert torch.isfinite(X).all()
    np.testing.assert_allclose(X.numpy(), 0.7)
    var = torch.tensor([[0.5], [0.0], [-1e-8]], dtype=torch.float64, requires_grad=True)
    torch.sum(q(lambda X: X ** 2, torch.zeros(3, 1, dtype=torch.float64), var)).backward()
    assert torch.isfinite(var.grad).all()
    np.testing.assert_allclose(var.grad[1:].numpy(), 0.0)
    want = jax.grad(lambda v: jnp.sum(jax_quadrature.NDiagGHQuadrature(1, 5)(lambda X: X ** 2, jnp.zeros((3, 1)), v)))(
        jnp.asarray([[0.5], [0.0], [-1e-8]]))
    _close(var.grad, want)


def test_grid_is_cached_per_device_and_dtype():
    q = quadrature.NDiagGHQuadrature(1, 20)
    mean, var = torch.zeros(4, 1), torch.ones(4, 1)
    X1, W1 = q._build_X_W(mean, var)
    X2, W2 = q._build_X_W(mean + 1, var)
    assert X1.dtype == W1.dtype == torch.float32
    assert W1.data_ptr() == W2.data_ptr()  # one float32 grid, made once
    keys = set(q._grids)
    assert keys == {(torch.device("cpu"), torch.float64), (torch.device("cpu"), torch.float32)}
    np.testing.assert_array_equal(W1.numpy().ravel(), q.dZ.ravel().astype(np.float32))
