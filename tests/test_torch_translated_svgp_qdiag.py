"""The JAX package's ``tests/gpflow_tpu/models/test_svgp_qdiag.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

SVGP q_diag=True: diagonal q_sqrt parametrization (reference svgp.py:85-148).
"""
import numpy as np

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch.models import SVGP
from . import test_torch_translated_support as support
from .test_torch_translated_support import translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)
N, D, M = 96, 2, 12
X = rng.randn(N, D)
Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, 1)
Z = X[:M].copy()


def _svgp(q_diag, whiten=True):
    return SVGP(
        kernel=gpf.kernels.SquaredExponential(),
        likelihood=gpf.likelihoods.Gaussian(0.1),
        inducing_variable=Z.copy(),
        q_diag=q_diag,
        whiten=whiten,
        num_data=N,
    )


def test_qdiag_shapes_and_elbo_matches_diagonal_full():
    md = _svgp(q_diag=True)
    assert md.q_sqrt.value.shape == (M, 1)

    mf = _svgp(q_diag=False)
    # set the full parametrization to the same diagonal covariance
    diag = 0.4 + rng.rand(M, 1)
    md.q_sqrt.assign(diag)
    mf.q_sqrt.assign(np.eye(M)[None] * diag.T[:, None, :].transpose(0, 2, 1))
    mu = rng.randn(M, 1)
    md.q_mu.assign(mu)
    mf.q_mu.assign(mu)

    np.testing.assert_allclose(
        float(md.elbo((X, Y))), float(mf.elbo((X, Y))), rtol=1e-10
    )
    fmd, fvd = md.predict_f(X[:7])
    fmf, fvf = mf.predict_f(X[:7])
    np.testing.assert_allclose(np.asarray(fmd), np.asarray(fmf), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(fvd), np.asarray(fvf), rtol=1e-9)


def test_qdiag_trains_and_stays_positive():

    m = _svgp(q_diag=True, whiten=False)
    params = list(m.trainable_parameters)

    def loss_fn(unc):
        old = [p.unconstrained for p in params]
        try:
            for p, u in zip(params, unc):
                p._parameters["unconstrained"] = u
            return m.training_loss((X, Y))
        finally:
            for p, o in zip(params, old):
                p._parameters["unconstrained"] = o

    opt = support.adam(0.05)
    unc = tuple(p.unconstrained for p in params)
    state = opt.init(unc)
    def step(unc, state):
        loss, g = support.value_and_grad(loss_fn)(unc)
        upd, state = opt.update(g, state, unc)
        return tuple(u + du for u, du in zip(unc, upd)), state, loss

    first = None
    for _ in range(60):
        unc, state, loss = step(unc, state)
        first = float(loss) if first is None else first
    assert np.isfinite(float(loss)) and float(loss) < first
    for p, u in zip(params, unc):
        p.assign_unconstrained(u)
    assert (m.q_sqrt.numpy() > 0).all()  # positive() transform keeps diag positive
