"""The JAX package's ``tests/gpflow_tpu/models/test_fuzz_gradients.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Gradient fuzzing: jax.grad of model objectives vs central finite
differences, with and without the ``GPFLOW_TPU_INV_SOLVE`` fast path.

Verifies the END-TO-END differentiation chain (bijector chain rule +
conditional pipeline + the ``chol_and_inverse`` custom VJP the bench relies
on) against a derivative-free oracle at random hyperparameter points — a
custom-VJP bug anywhere in the chain shows up as a systematic FD mismatch.
"""
import os
import numpy as np
import pytest

from gpflow_tpu_torch import kernels, likelihoods
from gpflow_tpu_torch.models import GPR, SGPR, SVGP
from . import test_torch_translated_support as support
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

N_SEEDS = 6
FD_EPS = 1e-6


def _fd_check(model, loss_fn, params, rtol=3e-5, atol=1e-7):
    """Compare grad wrt each scalar Parameter's unconstrained value to FD."""
    for p in params:
        u0 = np.asarray(p.unconstrained_variable, dtype=np.float64)
        if u0.size != 1:
            continue

        def loss_at(u):
            old = p.unconstrained
            try:
                p._parameters["unconstrained"] = asarray(u).reshape(u0.shape)
                return loss_fn()
            finally:
                p._parameters["unconstrained"] = old

        g = float(np.asarray(support.grad(loss_at)(asarray(u0))).ravel()[0])
        fd = (float(loss_at(u0 + FD_EPS)) - float(loss_at(u0 - FD_EPS))) / (2 * FD_EPS)
        np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol), p.name


def _data(seed, M=5):
    r = np.random.RandomState(3000 + seed)
    N, D = r.randint(8, 20), r.randint(1, 3)
    X = r.randn(N, D)
    Y = np.sin(X[:, :1]) + 0.2 * r.randn(N, 1)
    Z = r.randn(M, D)
    var, ls, noise = 0.5 + r.rand(), 0.5 + r.rand(), 0.05 + 0.2 * r.rand()
    return r, X, Y, Z, var, ls, noise


@pytest.fixture(params=["solve", "inv_solve"])
def inv_solve_mode(request, monkeypatch):
    if request.param == "inv_solve":
        monkeypatch.setenv("GPFLOW_TPU_INV_SOLVE", "1")
    else:
        monkeypatch.delenv("GPFLOW_TPU_INV_SOLVE", raising=False)
    return request.param


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_gpr_gradients_vs_fd(seed, inv_solve_mode):
    r, X, Y, Z, var, ls, noise = _data(seed)
    model = GPR(
        (X, Y), kernel=kernels.SquaredExponential(variance=var, lengthscales=ls),
        noise_variance=noise,
    )
    _fd_check(model, model.training_loss, model.trainable_parameters)


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_sgpr_gradients_vs_fd(seed, inv_solve_mode):
    r, X, Y, Z, var, ls, noise = _data(seed)
    model = SGPR(
        (X, Y), kernel=kernels.SquaredExponential(variance=var, lengthscales=ls),
        inducing_variable=Z, noise_variance=noise,
    )
    scalars = [p for p in model.trainable_parameters if np.asarray(p.value).size == 1]
    _fd_check(model, model.training_loss, scalars)


@pytest.mark.parametrize("seed", range(N_SEEDS))
def test_svgp_gradients_vs_fd(seed, inv_solve_mode):
    r, X, Y, Z, var, ls, noise = _data(seed)
    whiten = bool(r.randint(2))
    model = SVGP(
        kernel=kernels.SquaredExponential(variance=var, lengthscales=ls),
        likelihood=likelihoods.Gaussian(noise),
        inducing_variable=Z.copy(), whiten=whiten,
    )
    loss = lambda: model.training_loss((X, Y))
    scalars = [p for p in model.trainable_parameters if np.asarray(p.value).size == 1]
    _fd_check(model, loss, scalars)

    # one vector check: gradient wrt q_mu against per-coordinate FD
    q = model.q_mu
    u0 = np.asarray(q.unconstrained_variable, dtype=np.float64)

    def loss_at(u):
        old = q.unconstrained
        try:
            q._parameters["unconstrained"] = asarray(u)
            return loss()
        finally:
            q._parameters["unconstrained"] = old

    g = np.asarray(support.grad(loss_at)(asarray(u0)))
    for idx in [(0, 0), (u0.shape[0] - 1, 0)]:
        e = np.zeros_like(u0)
        e[idx] = FD_EPS
        fd = (float(loss_at(u0 + e)) - float(loss_at(u0 - e))) / (2 * FD_EPS)
        np.testing.assert_allclose(g[idx], fd, rtol=3e-5, atol=1e-7)
