"""The JAX package's ``tests/gpflow_tpu/models/test_svgp.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

SVGP behavior tests (reference ``tests/gpflow/models/test_svgp.py``):
fixing q_sqrt, diag-vs-full equivalence in both whitenings with a
non-conjugate likelihood, minibatch num_data scaling semantics, and
stochastic-update order invariance.
"""
import numpy as np
import pytest
from numpy.testing import assert_allclose

import gpflow_tpu_torch
from gpflow_tpu_torch import set_trainable
from gpflow_tpu_torch.models import SVGP
from . import test_torch_translated_support as support
from .test_torch_translated_support import translated_test_environment  # noqa: F401


class Datum:
    rng = np.random.RandomState(0)
    X = rng.randn(20, 1)
    Y = rng.randn(20, 2) ** 2
    Z = rng.randn(3, 1)
    qsqrt = (rng.randn(3, 2) ** 2) * 0.01
    qmean = rng.randn(3, 2)
    data = (X, Y)


def _model(q_diag: bool, whiten: bool) -> SVGP:
    return SVGP(
        kernel=gpflow_tpu_torch.kernels.SquaredExponential(),
        likelihood=gpflow_tpu_torch.likelihoods.Exponential(),
        q_diag=q_diag,
        num_latent_gps=Datum.Y.shape[1],
        inducing_variable=Datum.Z,
        whiten=whiten,
    )


def test_svgp_fixing_q_sqrt():
    """set_trainable(q_sqrt, False) must drop exactly one trainable leaf
    (reference bug #46 regression)."""
    model = _model(q_diag=True, whiten=False)
    n_default = len(model.trainable_variables)
    set_trainable(model.q_sqrt, False)
    assert len(model.trainable_variables) == n_default - 1


@pytest.mark.parametrize("whiten", [True, False])
def test_svgp_diag_full_equivalence(whiten):
    """ELBO with diagonal q_sqrt equals ELBO with an equivalent diagonal
    full q_sqrt, whitened and unwhitened, under a non-conjugate
    (Exponential) likelihood driving the quadrature path."""
    model_1 = _model(q_diag=True, whiten=whiten)
    model_2 = _model(q_diag=False, whiten=whiten)
    model_1.q_sqrt.assign(Datum.qsqrt)
    model_1.q_mu.assign(Datum.qmean)
    model_2.q_sqrt.assign(
        np.array([np.diag(Datum.qsqrt[:, 0]), np.diag(Datum.qsqrt[:, 1])])
    )
    model_2.q_mu.assign(Datum.qmean)
    assert_allclose(
        np.asarray(model_1.elbo(Datum.data)),
        np.asarray(model_2.elbo(Datum.data)),
        rtol=1e-12,
    )


def test_svgp_minibatch_scaling_semantics():
    """The data term scales by num_data/batch_size: for a fixed batch,
    (elbo + KL) must be proportional to num_data, and with num_data equal
    to the full dataset size the full-batch ELBO is recovered exactly."""
    X, Y = np.atleast_2d([0.0, 1.0, 2.0]).T, np.atleast_2d([-1.0, 3.0, 0.5]).T
    Z = np.atleast_2d([0.5])

    def get_model(num_data):
        m = SVGP(
            kernel=gpflow_tpu_torch.kernels.SquaredExponential(),
            likelihood=gpflow_tpu_torch.likelihoods.Gaussian(),
            inducing_variable=Z,
            num_data=num_data,
        )
        m.q_mu.assign(np.array([[0.3]]))
        m.q_sqrt.assign(np.array([[[0.8]]]))
        return m

    batch = (X[:2], Y[:2])
    m3 = get_model(num_data=3)
    m2 = get_model(num_data=2)
    kl = float(np.asarray(m3.prior_kl()))
    e3 = float(np.asarray(m3.elbo(batch)))
    e2 = float(np.asarray(m2.elbo(batch)))
    assert_allclose(e3 + kl, (3 / 2) * (e2 + kl), rtol=1e-12)

    # num_data=None defaults to the batch size (full-batch semantics)
    m_none = get_model(num_data=None)
    assert_allclose(np.asarray(m_none.elbo(batch)), e2, rtol=1e-12)


@pytest.mark.parametrize(
    "indices_1, indices_2",
    [([0, 1], [1, 0]), ([1, 0, 1], [1, 1, 0])],
)
def test_stochastic_gradients_order_invariance(indices_1, indices_2):
    """Reordering a minibatch must produce the identical SGD update
    (reference bug #281 regression, made exact)."""
    X, Y = np.atleast_2d([0.0, 1.0]).T, np.atleast_2d([-1.0, 3.0]).T
    Z = np.atleast_2d([0.5])

    def train(indices, max_iter=3):
        model = SVGP(
            kernel=gpflow_tpu_torch.kernels.SquaredExponential(),
            num_data=2,
            likelihood=gpflow_tpu_torch.likelihoods.Gaussian(),
            inducing_variable=Z,
        )
        params = list(model.trainable_parameters)
        opt = support.sgd(1e-3)
        unc = tuple(p.unconstrained for p in params)
        state = opt.init(unc)
        data = (X[indices], Y[indices])

        def loss_fn(unc):
            old = [p.unconstrained for p in params]
            try:
                for p, u in zip(params, unc):
                    p._parameters["unconstrained"] = u
                return model.training_loss(data)
            finally:
                for p, o in zip(params, old):
                    p._parameters["unconstrained"] = o

        for _ in range(max_iter):
            g = support.grad(loss_fn)(unc)
            upd, state = opt.update(g, state, unc)
            unc = tuple(u + du for u, du in zip(unc, upd))
        for p, u in zip(params, unc):
            p.assign_unconstrained(u)
        return model

    m1 = train(indices_1)
    m2 = train(indices_2)
    for p1, p2 in zip(m1.trainable_parameters, m2.trainable_parameters):
        assert_allclose(np.asarray(p1.value), np.asarray(p2.value), rtol=1e-12)
