"""The JAX package's ``tests/gpflow_tpu/test_natgrad_guard.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Natural-gradient step rejection: a step that leaves the negative-definite
cone must keep (q_mu, q_sqrt) unchanged instead of propagating NaN.
"""
import numpy as np
import torch

from gpflow_tpu_torch.bijectors import Identity, triangular
from gpflow_tpu_torch.optimizers.natgrad import NaturalGradient
from gpflow_tpu_torch.quadrature import NDiagGHQuadrature
from .test_torch_translated_support import X64, asarray, translated_test_environment  # noqa: F401


def _values(gamma, q_sqrt_grad_scale):
    M = 4
    q_mu = torch.zeros((M, 1), **X64)
    q_sqrt = torch.eye(M, **X64)[None]
    # a large positive gradient on q_sqrt drives nat2_new indefinite
    g_mu = torch.ones((M, 1), **X64)
    g_sqrt = q_sqrt_grad_scale * torch.tile(torch.eye(M, **X64)[None], (1, 1, 1))
    ng = NaturalGradient(gamma=gamma)
    mu_t, sq_t = Identity(), triangular()
    return q_mu, q_sqrt, ng._natgrad_values_with_ok(
        g_mu, g_sqrt, q_mu, q_sqrt, mu_t, sq_t, ng.xi_transform
    )[:2]


def test_sane_step_accepted():
    q_mu, q_sqrt, (mean_new, varsqrt_new) = _values(0.1, 0.1)
    assert np.isfinite(mean_new).all() and np.isfinite(varsqrt_new).all()
    assert np.abs(np.asarray(mean_new)).max() > 1e-3  # actually moved


def test_cone_exit_rejected():
    # a large negative q_sqrt gradient turns nat2 - gamma * dL/deta2
    # indefinite: the conversion Cholesky is NaN, and the guard must return
    # the inputs unchanged.
    q_mu, q_sqrt, (mean_new, varsqrt_new) = _values(1.0, -100.0)
    assert np.isfinite(mean_new).all() and np.isfinite(varsqrt_new).all()
    np.testing.assert_array_equal(np.asarray(mean_new), np.asarray(q_mu))
    np.testing.assert_array_equal(np.asarray(varsqrt_new), np.asarray(q_sqrt))


def test_quadrature_clamps_negative_variance():
    # reduced-precision matmul modes can round predictive variance slightly
    # negative; the quadrature grid must degrade to the mean, not NaN
    quad = NDiagGHQuadrature(dim=1, n_gh=5)
    mean = asarray([[0.7]])
    var = asarray([[-1e-3]])
    X, W = quad._build_X_W(mean, var)
    assert np.isfinite(np.asarray(X)).all()
    np.testing.assert_allclose(np.asarray(X), 0.7)
