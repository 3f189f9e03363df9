"""The JAX package's ``tests/gpflow_tpu/models/test_cglb.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

CGLB matrix-free mode (TPU extension: chunked K matvecs, no [N, N]).
"""
import numpy as np

import gpflow_tpu_torch
from . import test_torch_translated_support as support
from .test_torch_translated_support import translated_test_environment  # noqa: F401


def test_matrix_free_cglb_matches_dense():
    """matrix_free_chunk must give the same objective, gradients, and
    predictions as the dense path (chunk not dividing N exercises padding)."""
    from gpflow_tpu_torch.models import CGLB

    rngc = np.random.RandomState(3)
    N, D, M = 90, 2, 10
    X = rngc.randn(N, D)
    Y = np.sin(X[:, :1]) + 0.1 * rngc.randn(N, 1)
    Z = X[:M].copy()

    def build(**kw):
        return CGLB(
            (X, Y),
            kernel=gpflow_tpu_torch.kernels.SquaredExponential(),
            inducing_variable=Z,
            cg_tolerance=1e-8,
            **kw,
        )

    dense, mf = build(), build(matrix_free_chunk=32)
    np.testing.assert_allclose(
        float(mf.training_loss()), float(dense.training_loss()), rtol=1e-10
    )

    def grads(model):
        params = list(model.trainable_parameters)

        def f(unc):
            old = [p.unconstrained for p in params]
            try:
                for p, u in zip(params, unc):
                    p._parameters["unconstrained"] = u
                return model.training_loss()
            finally:
                for p, o in zip(params, old):
                    p._parameters["unconstrained"] = o

        return support.grad(f)(tuple(p.unconstrained for p in params))

    for gd, gm in zip(grads(dense), grads(mf)):
        np.testing.assert_allclose(np.asarray(gd), np.asarray(gm), rtol=1e-8, atol=1e-10)

    Xnew = rngc.randn(7, D)
    md, vd = dense.predict_f(Xnew)
    mm, vm = mf.predict_f(Xnew)
    np.testing.assert_allclose(np.asarray(mm), np.asarray(md), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(vm), np.asarray(vd), rtol=1e-8)


def test_cglb_multioutput_elbo_and_predict():
    """Multi-output CGLB: per-column CG step sizes (the reference's shared
    scalar gamma is shape-wrong for P > 1). The multi-output
    ELBO must equal the sum of per-column single-output ELBOs up to the
    shared-constant structure: elbo([y1 y2]) == elbo(y1) + elbo(y2) for
    identical hyperparameters."""
    import gpflow_tpu_torch
    from gpflow_tpu_torch.models import CGLB

    rngm = np.random.RandomState(7)
    N, M = 60, 10
    X = rngm.rand(N, 2) * 3
    Y1 = np.sin(X[:, :1]) + 0.05 * rngm.randn(N, 1)
    Y2 = np.cos(X[:, :1]) + 0.05 * rngm.randn(N, 1)
    Z = X[:M].copy()

    def build(Y):
        m = CGLB(
            (X, Y),
            kernel=gpflow_tpu_torch.kernels.SquaredExponential(),
            inducing_variable=Z.copy(),
            cg_tolerance=1e-10,
        )
        gpflow_tpu_torch.set_trainable(m.aux_vec, False)
        return m

    m12 = build(np.concatenate([Y1, Y2], axis=1))
    m1, m2 = build(Y1), build(Y2)
    e12 = float(m12.elbo())
    e1, e2 = float(m1.elbo()), float(m2.elbo())
    np.testing.assert_allclose(e12, e1 + e2, rtol=1e-6)

    mu, var = m12.predict_f(X[:5])
    assert np.asarray(mu).shape == (5, 2)
    assert np.isfinite(np.asarray(mu)).all() and (np.asarray(var) > 0).all()


def test_bound_stays_valid_under_adversarial_aux_vector():
    """The quadratic-term bound must hold for ANY auxiliary vector v — that
    is the CGLB construction's defining property. In float32 a huge-norm v
    (which CG can return near sigma^2 -> 0) used to round the PSD form
    v^T K_hat v negative, INFLATING the "lower bound" above the evidence;
    the PSD clamps in quad_term pin the one-sided guarantee instead. Checked
    against the Titsias upper bound, which dominates the exact evidence."""
    from gpflow_tpu_torch.models import CGLB

    rngc = np.random.RandomState(4)
    N, D, M = 256, 2, 12
    X = rngc.randn(N, D)
    Y = np.sin(X[:, :1]) + 0.1 * rngc.randn(N, 1)

    model = CGLB(
        (X, Y),
        kernel=gpflow_tpu_torch.kernels.SquaredExponential(),
        inducing_variable=X[:M].copy(),
        noise_variance=1e-4,
        v_grad_optimization=True,  # v is a plain parameter: we control it
    )
    upper = float(model.upper_bound())

    for scale in (0.0, 1.0, 1e4, -1e4):
        model.aux_vec.assign(scale * np.ones((1, N)))
        bound = float(model.elbo())
        assert np.isfinite(bound)
        assert bound <= upper + 1e-6 * abs(upper), (scale, bound, upper)
    # huge v must make the bound very loose (the exact s2||v||^2 term
    # dominates), not inflate it
    model.aux_vec.assign(1e4 * np.ones((1, N)))
    assert float(model.elbo()) < -1e3
