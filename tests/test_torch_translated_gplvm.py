"""The JAX package's ``tests/gpflow_tpu/models/test_gplvm.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

GPLVM / BayesianGPLVM depth tests (pattern from reference
``tests/gpflow/models/test_gplvm.py``), float64.

Key identity: with q(X) collapsed to a point (X_data_var -> 0) the
BayesianGPLVM psi statistics reduce to the plain kernel matrices, so its
ELBO equals the SGPR collapsed ELBO on X = X_data_mean minus the exact
KL[q(X) || p(X)] — an oracle-grade cross-model check of the psi-statistics
pipeline (reference ``gplvm.py:159-216`` vs ``sgpr.py:181-289``).
"""
import numpy as np
import pytest

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch import kernels
from gpflow_tpu_torch.models import GPLVM, GPR, SGPR, BayesianGPLVM
from .test_torch_translated_support import translated_test_environment  # noqa: F401

rng = np.random.RandomState(13)
N, Q, D_OUT, M = 20, 2, 4, 7
Y = rng.randn(N, D_OUT)
X0 = rng.randn(N, Q)
Z0 = rng.randn(M, Q)


def test_gplvm_objective_equals_gpr_at_init():
    kernel = kernels.SquaredExponential(variance=1.2, lengthscales=np.full(Q, 0.8))
    gplvm = GPLVM(Y, latent_dim=Q, X_data_mean=X0.copy(), kernel=kernel)
    gplvm.likelihood.variance.assign(0.2)
    gpr = GPR(
        (X0, Y),
        kernel=kernels.SquaredExponential(variance=1.2, lengthscales=np.full(Q, 0.8)),
        noise_variance=0.2,
    )
    np.testing.assert_allclose(
        float(gplvm.log_marginal_likelihood()),
        float(gpr.log_marginal_likelihood()),
        rtol=1e-12,
    )


def test_gplvm_latent_x_is_trainable():
    gplvm = GPLVM(Y, latent_dim=Q)
    names = [p.name for p in gplvm.trainable_parameters]
    assert "X_data_mean" in names
    # one Scipy step must move the latent positions
    before = np.asarray(gplvm.data[0].value).copy()
    gpf.optimizers.Scipy().minimize(
        gplvm.training_loss, gplvm.trainable_variables, options={"maxiter": 3}
    )
    after = np.asarray(gplvm.data[0].value)
    assert not np.allclose(before, after)


def test_gplvm_rejects_mismatched_latent_dim():
    with pytest.raises(ValueError, match="does not match"):
        GPLVM(Y, latent_dim=1, X_data_mean=X0)  # X0 has Q=2 columns


def test_bayesian_gplvm_collapses_to_sgpr_minus_kl():
    var, ls, noise = 1.3, 0.9, 0.15
    S = np.full((N, Q), 1e-10)
    m = BayesianGPLVM(
        Y,
        X_data_mean=X0.copy(),
        X_data_var=S.copy(),
        kernel=kernels.SquaredExponential(variance=var, lengthscales=ls),
        inducing_variable=Z0.copy(),
    )
    m.likelihood.variance.assign(noise)
    sgpr = SGPR(
        (X0, Y),
        kernel=kernels.SquaredExponential(variance=var, lengthscales=ls),
        inducing_variable=Z0.copy(),
        noise_variance=noise,
    )
    kl = 0.5 * np.sum(S + X0**2) - 0.5 * N * Q - 0.5 * np.sum(np.log(S))
    np.testing.assert_allclose(
        float(m.elbo()), float(sgpr.elbo()) - kl, rtol=1e-6
    )


def test_bayesian_gplvm_training_improves_elbo():
    m = BayesianGPLVM(
        Y,
        X_data_mean=X0.copy(),
        X_data_var=np.full((N, Q), 0.5),
        kernel=kernels.SquaredExponential(lengthscales=np.ones(Q)),
        num_inducing_variables=M,
    )
    before = float(m.elbo())
    gpf.optimizers.Scipy().minimize(
        m.training_loss, m.trainable_variables, options={"maxiter": 30}
    )
    after = float(m.elbo())
    assert after > before + 1.0


def test_bayesian_gplvm_predict_f_shapes_and_finite():
    m = BayesianGPLVM(
        Y,
        X_data_mean=X0.copy(),
        X_data_var=np.full((N, Q), 0.3),
        kernel=kernels.SquaredExponential(lengthscales=np.ones(Q)),
        inducing_variable=Z0.copy(),
    )
    Xnew = rng.randn(5, Q)
    mu, v = m.predict_f(Xnew)
    assert np.asarray(mu).shape == (5, D_OUT)
    assert np.asarray(v).shape == (5, D_OUT)
    assert np.isfinite(np.asarray(mu)).all() and (np.asarray(v) > 0).all()


def test_bayesian_gplvm_requires_exactly_one_inducing_spec():
    with pytest.raises(ValueError, match="exactly one"):
        BayesianGPLVM(
            Y, X_data_mean=X0, X_data_var=np.ones((N, Q)),
            kernel=kernels.SquaredExponential(),
        )
    with pytest.raises(ValueError, match="exactly one"):
        BayesianGPLVM(
            Y, X_data_mean=X0, X_data_var=np.ones((N, Q)),
            kernel=kernels.SquaredExponential(),
            num_inducing_variables=M, inducing_variable=Z0,
        )


def test_bayesian_gplvm_prior_shape_validation():
    """[Q]-shaped priors would silently lose a factor of N in the KL's
    log-prior-variance term (the reference rejects them via
    check_shapes)."""
    import pytest as _pytest

    import gpflow_tpu_torch
    from gpflow_tpu_torch.models import BayesianGPLVM

    rngp = np.random.RandomState(0)
    Y = rngp.randn(15, 4)
    mean0 = rngp.randn(15, 2)
    var0 = np.ones((15, 2))
    with _pytest.raises(ValueError, match="X_prior_var"):
        BayesianGPLVM(Y, mean0, var0, gpflow_tpu_torch.kernels.SquaredExponential(),
                      num_inducing_variables=5, X_prior_var=np.array([0.5, 0.5]))
    with _pytest.raises(ValueError, match="X_prior_mean"):
        BayesianGPLVM(Y, mean0, var0, gpflow_tpu_torch.kernels.SquaredExponential(),
                      num_inducing_variables=5, X_prior_mean=np.zeros(2))
    # correct shapes still work
    m = BayesianGPLVM(Y, mean0, var0, gpflow_tpu_torch.kernels.SquaredExponential(),
                      num_inducing_variables=5,
                      X_prior_mean=np.zeros((15, 2)), X_prior_var=0.5 * np.ones((15, 2)))
    assert np.isfinite(float(m.elbo()))


def test_training_loss_closure_accepts_list_data():
    """A list (X, Y) pair is fixed data, not a minibatch iterator
    (next() on it raised TypeError)."""
    import gpflow_tpu_torch

    rngl = np.random.RandomState(1)
    X = rngl.randn(20, 2)
    Yl = rngl.randn(20, 1)
    m = gpflow_tpu_torch.models.SVGP(
        kernel=gpflow_tpu_torch.kernels.SquaredExponential(),
        likelihood=gpflow_tpu_torch.likelihoods.Gaussian(0.1),
        inducing_variable=X[:4].copy(), num_data=20,
    )
    closure = m.training_loss_closure([X, Yl])
    v = float(closure())
    np.testing.assert_allclose(v, float(m.training_loss((X, Yl))), rtol=1e-12)
    # iterators still stream
    it = iter([(X, Yl), (X[:8], Yl[:8])])
    closure_it = m.training_loss_closure(it, compile=False)
    closure_it(); closure_it()
