"""The JAX package's ``tests/gpflow_tpu/kernels/test_coregion.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Coregionalization end-to-end equivalence (reference
``tests/gpflow/kernels/test_coregion.py``): a coregionalized VGP with a
diagonal Coregion kernel (W = 0), SwitchedLikelihood, and
SwitchedMeanFunction must match two independently-trained VGPs — learned
variances/means and every prediction endpoint.
"""
from typing import Tuple

import numpy as np
import pytest
from numpy.testing import assert_allclose

import gpflow_tpu_torch
from gpflow_tpu_torch import set_trainable
from gpflow_tpu_torch.functions import Constant, SwitchedMeanFunction
from gpflow_tpu_torch.models import VGP
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)


class Datum:
    N1, N2 = 6, 16
    X = [rng.rand(N1, 2), rng.rand(N2, 2)]
    Y = [
        np.sin(x[:, :1]) + 0.9 * np.cos(x[:, 1:2] * 1.6) + rng.randn(x.shape[0], 1) * 0.8
        for x in X
    ]
    label = [np.zeros((N1, 1)), np.ones((N2, 1))]
    X_augmented0 = np.hstack([X[0], label[0]])
    X_augmented1 = np.hstack([X[1], label[1]])
    X_augmented = np.vstack([X_augmented0, X_augmented1])
    Y_augmented = np.vstack([np.hstack([Y[0], label[0]]), np.hstack([Y[1], label[1]])])

    N = 10
    Xtest = rng.rand(N, 2) * N
    Xtest_augmented0 = np.hstack([Xtest, np.zeros((N, 1))])
    Xtest_augmented1 = np.hstack([Xtest, np.ones((N, 1))])
    Ytest = np.sin(Xtest[:, :1]) + 0.9 * np.cos(Xtest[:, 1:2] * 1.6)
    Ytest_augmented0 = np.hstack([Ytest, np.zeros((N, 1))])
    Ytest_augmented1 = np.hstack([Ytest, np.ones((N, 1))])


@pytest.fixture(scope="module")
def models() -> Tuple[VGP, VGP, VGP]:
    """Two independent VGPs vs one coregionalized VGP with zero output
    correlation and fixed lengthscales — trained once for the module."""
    k0 = gpflow_tpu_torch.kernels.SquaredExponential()
    set_trainable(k0.lengthscales, False)
    k1 = gpflow_tpu_torch.kernels.SquaredExponential()
    set_trainable(k1.lengthscales, False)
    vgp0 = VGP(
        (Datum.X[0], Datum.Y[0]),
        kernel=k0,
        mean_function=Constant(),
        likelihood=gpflow_tpu_torch.likelihoods.Gaussian(),
        num_latent_gps=1,
    )
    vgp1 = VGP(
        (Datum.X[1], Datum.Y[1]),
        kernel=k1,
        mean_function=Constant(),
        likelihood=gpflow_tpu_torch.likelihoods.Gaussian(),
        num_latent_gps=1,
    )

    kc = gpflow_tpu_torch.kernels.SquaredExponential(active_dims=[0, 1])
    set_trainable(kc.lengthscales, False)
    set_trainable(kc.variance, False)  # variance is carried by Coregion kappa
    coreg = gpflow_tpu_torch.kernels.Coregion(output_dim=2, rank=1, active_dims=[2])
    coreg.W.assign(np.zeros((2, 1)))
    set_trainable(coreg.W, False)
    lik = gpflow_tpu_torch.likelihoods.SwitchedLikelihood(
        [gpflow_tpu_torch.likelihoods.Gaussian(), gpflow_tpu_torch.likelihoods.Gaussian()]
    )
    mean_c = SwitchedMeanFunction([Constant(), Constant()])
    cvgp = VGP(
        (Datum.X_augmented, Datum.Y_augmented),
        kernel=kc * coreg,
        mean_function=mean_c,
        likelihood=lik,
        num_latent_gps=1,
    )

    opt = gpflow_tpu_torch.optimizers.Scipy()
    for m in (vgp0, vgp1, cvgp):
        opt.minimize(
            m.training_loss,
            m.trainable_variables,
            options=dict(maxiter=1000),
            method="BFGS",
        )
    return vgp0, vgp1, cvgp


def test_likelihood_variance(models):
    vgp0, vgp1, cvgp = models
    assert_allclose(
        np.asarray(vgp0.likelihood.variance.value),
        np.asarray(cvgp.likelihood.likelihoods[0].variance.value),
        atol=1e-2,
    )
    assert_allclose(
        np.asarray(vgp1.likelihood.variance.value),
        np.asarray(cvgp.likelihood.likelihoods[1].variance.value),
        atol=1e-2,
    )


def test_kernel_variance(models):
    vgp0, vgp1, cvgp = models
    assert_allclose(
        np.asarray(vgp0.kernel.variance.value),
        np.asarray(cvgp.kernel.kernels[1].kappa.value)[0],
        atol=1e-4,
    )
    assert_allclose(
        np.asarray(vgp1.kernel.variance.value),
        np.asarray(cvgp.kernel.kernels[1].kappa.value)[1],
        atol=1e-4,
    )


def test_mean_values(models):
    vgp0, vgp1, cvgp = models
    assert_allclose(
        np.asarray(vgp0.mean_function.c.value),
        np.asarray(cvgp.mean_function.meanfunctions[0].c.value),
        atol=1e-4,
    )
    assert_allclose(
        np.asarray(vgp1.mean_function.c.value),
        np.asarray(cvgp.mean_function.meanfunctions[1].c.value),
        atol=1e-4,
    )


def test_predict_f(models):
    vgp0, vgp1, cvgp = models
    for vgp, Xaug in ((vgp0, Datum.Xtest_augmented0), (vgp1, Datum.Xtest_augmented1)):
        mu, var = vgp.predict_f(Datum.Xtest)
        c_mu, c_var = cvgp.predict_f(Xaug)
        assert_allclose(np.asarray(mu), np.asarray(c_mu), atol=1e-4)
        assert_allclose(np.asarray(var), np.asarray(c_var), atol=1e-4)
        # full_cov path must run and agree on the diagonal
        _, fc = cvgp.predict_f(Xaug, full_cov=True)
        assert_allclose(
            np.diagonal(np.asarray(fc), axis1=-2, axis2=-1).T, np.asarray(c_var), atol=1e-8
        )


def test_predict_y(models):
    vgp0, vgp1, cvgp = models
    mu1, var1 = vgp0.predict_y(Datum.Xtest)
    c_mu1, c_var1 = cvgp.predict_y(Datum.Xtest_augmented0)
    assert_allclose(np.asarray(mu1), np.asarray(c_mu1)[:, :1], atol=1e-4)
    assert_allclose(np.asarray(var1), np.asarray(c_var1)[:, :1], atol=1e-4)

    mu2, var2 = vgp1.predict_y(Datum.Xtest)
    c_mu2, c_var2 = cvgp.predict_y(Datum.Xtest_augmented1)
    assert_allclose(np.asarray(mu2), np.asarray(c_mu2)[:, 1:2], atol=1e-4)
    assert_allclose(np.asarray(var2), np.asarray(c_var2)[:, 1:2], atol=1e-4)


def test_predict_log_density(models):
    vgp0, vgp1, cvgp = models
    d0 = vgp0.predict_log_density((Datum.Xtest, Datum.Ytest))
    c_d0 = cvgp.predict_log_density((Datum.Xtest_augmented0, Datum.Ytest_augmented0))
    assert_allclose(np.asarray(d0), np.asarray(c_d0), atol=1e-2)
    d1 = vgp1.predict_log_density((Datum.Xtest, Datum.Ytest))
    c_d1 = cvgp.predict_log_density((Datum.Xtest_augmented1, Datum.Ytest_augmented1))
    assert_allclose(np.asarray(d1), np.asarray(c_d1), atol=1e-2)


def test_predict_f_samples(models):
    _, _, cvgp = models
    s0 = cvgp.predict_f_samples(Datum.X_augmented0, 1)
    s1 = cvgp.predict_f_samples(Datum.X_augmented1, 1)
    assert np.asarray(s0).shape == (1, Datum.N1, 1)
    assert np.asarray(s1).shape == (1, Datum.N2, 1)
    assert np.all(np.isfinite(np.asarray(s0)))
    assert np.all(np.isfinite(np.asarray(s1)))


def test_coregion_invalid_label_is_nan():
    """Out-of-range output indices must NaN-poison (JAX gathers silently
    clamp; tf.gather raises) — same fail-loud policy as the likelihoods."""
    k = gpflow_tpu_torch.kernels.Coregion(output_dim=3, rank=1)
    Xok = np.array([[0.0], [2.0]])
    Xbad = np.array([[0.0], [3.0], [-1.0]])
    assert np.isfinite(np.asarray(k(Xok))).all()
    Kb = np.asarray(k(Xbad))
    assert np.isfinite(Kb[0, 0])
    assert np.isnan(Kb[1, 1]) and np.isnan(Kb[2, 2]) and np.isnan(Kb[0, 1])
    Kd = np.asarray(k(Xbad, full_cov=False))
    assert np.isfinite(Kd[0]) and np.isnan(Kd[1]) and np.isnan(Kd[2])
    # cross-kernel path
    Kx = np.asarray(k(Xok, Xbad))
    assert np.isfinite(Kx[:, 0]).all() and np.isnan(Kx[:, 1]).all()


def test_categorical_invalid_label_is_nan():

    from gpflow_tpu_torch.kernels.categorical import latent_from_labels

    Z = np.arange(6.0).reshape(3, 2)
    vals = np.asarray(latent_from_labels(asarray(Z), asarray([0.0, 2.0, 3.0, -1.0])))
    assert np.isfinite(vals[:2]).all()
    assert np.isnan(vals[2]).all() and np.isnan(vals[3]).all()
