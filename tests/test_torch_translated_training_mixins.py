"""The JAX package's ``tests/gpflow_tpu/models/test_training_mixins.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Training mixins (pattern from reference
``tests/gpflow/models/test_training_mixins.py``): loss closures for
internal- and external-data models, compiled/uncompiled agreement, the
prior term, and minibatch iterators.
"""
import numpy as np
import pytest

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch import kernels, likelihoods, priors
from gpflow_tpu_torch.models import GPR, SVGP
from gpflow_tpu_torch.models.util import training_loss, training_loss_closure
from .test_torch_translated_support import translated_test_environment  # noqa: F401

rng = np.random.RandomState(31)
N, D = 24, 2
X = rng.randn(N, D)
Y = np.sin(X[:, :1]) + 0.1 * rng.randn(N, 1)


def test_internal_data_training_loss_is_negative_objective():
    m = GPR((X, Y), kernel=kernels.SquaredExponential(), noise_variance=0.1)
    np.testing.assert_allclose(
        float(m.training_loss()), -float(m.log_marginal_likelihood()), rtol=1e-12
    )


def test_training_loss_includes_log_prior():
    m = GPR((X, Y), kernel=kernels.SquaredExponential(), noise_variance=0.1)
    base = float(m.training_loss())
    m.kernel.variance.prior = priors.LogNormal(0.0, 1.0)
    with_prior = float(m.training_loss())
    lp = float(m.log_prior_density())
    assert lp != 0.0
    np.testing.assert_allclose(with_prior, base - lp, rtol=1e-10)


def test_internal_closure_compiled_matches_uncompiled():
    m = GPR((X, Y), kernel=kernels.SquaredExponential(), noise_variance=0.1)
    eager = m.training_loss_closure(compile=False)
    compiled = m.training_loss_closure(compile=True)
    np.testing.assert_allclose(float(eager()), float(compiled()), rtol=1e-12)
    # the closure must track parameter updates
    m.likelihood.variance.assign(0.5)
    np.testing.assert_allclose(float(eager()), float(compiled()), rtol=1e-12)
    np.testing.assert_allclose(float(compiled()), float(m.training_loss()), rtol=1e-12)


def test_external_closure_over_minibatch_iterator():
    m = SVGP(
        kernel=kernels.SquaredExponential(),
        likelihood=likelihoods.Gaussian(0.1),
        inducing_variable=X[:6].copy(),
        num_data=N,
    )

    def batches():
        for lo in (0, 8, 16):
            yield X[lo : lo + 8], Y[lo : lo + 8]

    closure = m.training_loss_closure(iter(batches()), compile=True)
    losses = [float(closure()) for _ in range(3)]
    expected = [float(m.training_loss(b)) for b in batches()]
    np.testing.assert_allclose(losses, expected, rtol=1e-10)


def test_module_level_helpers_dispatch_on_mixin():
    gpr = GPR((X, Y), kernel=kernels.SquaredExponential(), noise_variance=0.1)
    svgp = SVGP(
        kernel=kernels.SquaredExponential(),
        likelihood=likelihoods.Gaussian(0.1),
        inducing_variable=X[:6].copy(),
    )
    data = (X, Y)
    np.testing.assert_allclose(
        float(training_loss(gpr, data)), float(gpr.training_loss()), rtol=1e-12
    )
    np.testing.assert_allclose(
        float(training_loss(svgp, data)), float(svgp.training_loss(data)), rtol=1e-12
    )
    closure = training_loss_closure(svgp, data, compile=True)
    np.testing.assert_allclose(
        float(closure()), float(svgp.training_loss(data)), rtol=1e-10
    )
