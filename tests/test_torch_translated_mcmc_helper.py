"""The JAX package's ``tests/gpflow_tpu/optimizers/test_mcmc_helper.py``, translated
onto the port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; ``jax.grad`` over the helper's target is autograd
over its state (``grad``), and the ``PRNGKey`` a seeded generator.

SamplingHelper target-density math (strategy from reference
``tests/gpflow/optimizers/test_mcmc.py``): state/parameter correspondence,
the unconstrained target = log posterior + forward log-det-Jacobian identity
for constrained/unconstrained priors with and without transforms, rejection
of non-Parameter state, and end-to-end integration with ``run_hmc``.
"""
import numpy as np
import pytest

import gpflow_tpu_torch
from gpflow_tpu_torch import Parameter, PriorOn, kernels, priors
from gpflow_tpu_torch.bijectors import Identity
from gpflow_tpu_torch.functions import Linear
from gpflow_tpu_torch.models import GPR
from gpflow_tpu_torch.optimizers import SamplingHelper
from gpflow_tpu_torch.optimizers.mcmc import run_hmc
from .test_torch_translated_support import DEVICE, grad, seeded_generator, translated_test_environment  # noqa: F401

rng = np.random.RandomState(1)
N = 30
X = rng.rand(N, 1)
Y = np.sin(12 * X) + 0.66 * np.cos(25 * X) + rng.randn(N, 1) * 0.1 + 3

PRIOR_WIDTH = 200.0
LOW = -100.0


def build_model() -> GPR:
    kernel = kernels.Matern52(lengthscales=0.3)
    meanf = Linear(np.ones((1, 1)), np.zeros(1))
    model = GPR((X, Y), kernel=kernel, mean_function=meanf, noise_variance=0.01)
    for p in model.all_parameters:
        p.prior = priors.Gamma(1.0, 1.0)
    return model


def build_model_uniform_prior_no_transforms(prior_on: PriorOn) -> GPR:
    def parameter(value) -> Parameter:
        return Parameter(
            value,
            transform=Identity(),
            prior=priors.Uniform(LOW, LOW + PRIOR_WIDTH),
            prior_on=prior_on,
        )

    k = kernels.Matern52(lengthscales=0.3)
    k.variance = parameter(k.variance.value)
    k.lengthscales = parameter(k.lengthscales.value)
    mf = Linear(np.ones((1, 1)), np.zeros(1))
    mf.A = parameter(mf.A.value)
    mf.b = parameter(mf.b.value)
    m = GPR((X, Y), kernel=k, mean_function=mf, noise_variance=0.01)
    m.likelihood.variance = parameter(m.likelihood.variance.value)
    return m


def test_mcmc_helper_parameters_state_correspondence():
    model = build_model()
    helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
    for p, state in zip(model.trainable_parameters, helper.current_state):
        assert p.shape == state.shape
        np.testing.assert_array_equal(np.asarray(p.unconstrained_variable), np.asarray(state))
    assert tuple(model.trainable_parameters) == helper._parameters


def test_mcmc_helper_target_function_constrained():
    """Uniform priors on the CONSTRAINED space with an Exp transform: the
    unconstrained target density picks up a log|dc/du| = log(value) Jacobian
    per parameter (reference ``test_mcmc.py:84-120``)."""
    with gpflow_tpu_torch.config.as_context(gpflow_tpu_torch.config.Config(positive_bijector="exp", device=DEVICE.type)):
        model = build_model()

    expected_log_prior = 0.0
    for param in model.trainable_parameters:
        if np.asarray(param.value).min() < 1e-3:
            # avoid pathological Exp-transform values
            param.assign(np.ones(np.asarray(param.value).shape))
        param.prior = priors.Uniform(LOW, LOW + PRIOR_WIDTH)
        param.prior_on = PriorOn.CONSTRAINED
        value = np.asarray(param.value)
        # per element: log density 1/width, plus log|dc/du| from the
        # transform — measured by FINITE DIFFERENCES of transform.forward so
        # the expectation is independent of forward_log_det_jacobian's code
        expected_log_prior += value.size * np.log(1 / PRIOR_WIDTH)
        u = np.asarray(param.unconstrained_variable, dtype=np.float64)
        eps = 1e-6
        dcdu = (
            np.asarray(param.transform.forward(u + eps))
            - np.asarray(param.transform.forward(u - eps))
        ) / (2 * eps)
        expected_log_prior += np.sum(np.log(np.abs(dcdu)))

    helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
    lml = float(model.log_marginal_likelihood())
    np.testing.assert_allclose(
        float(helper.target_log_prob_fn(*helper.current_state)),
        lml + expected_log_prior,
        rtol=1e-6,
    )


@pytest.mark.parametrize("prior_on", [PriorOn.CONSTRAINED, PriorOn.UNCONSTRAINED])
def test_mcmc_helper_target_function_no_transforms(prior_on):
    """With Identity transforms the Jacobian vanishes and both prior
    placements give target = lml + sum log(1/width) per scalar entry
    (reference ``test_mcmc.py:123-169``)."""
    model = build_model_uniform_prior_no_transforms(prior_on)
    helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
    expected_log_prior = sum(
        np.asarray(p.value).size * np.log(1 / PRIOR_WIDTH)
        for p in model.trainable_parameters
    )
    lml = float(model.log_marginal_likelihood())
    np.testing.assert_allclose(
        float(helper.target_log_prob_fn(*helper.current_state)),
        lml + expected_log_prior,
        rtol=1e-10,
    )


def test_mcmc_helper_target_function_is_pure():
    """Calling the target fn at a perturbed state must not mutate the model."""
    model = build_model()
    helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
    before = [np.asarray(p.value).copy() for p in model.trainable_parameters]
    perturbed = tuple(s + 0.1 for s in helper.current_state)
    helper.target_log_prob_fn(*perturbed)
    for p, b in zip(model.trainable_parameters, before):
        np.testing.assert_array_equal(np.asarray(p.value), b)


def test_mcmc_helper_gradient_matches_finite_difference():
    model = build_model_uniform_prior_no_transforms(PriorOn.UNCONSTRAINED)
    helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
    fn = helper.target_log_prob_fn
    grads = grad(lambda *s: fn(*s), argnums=tuple(range(len(helper.current_state))))(
        *helper.current_state
    )
    assert len(grads) == len(helper.current_state)
    # finite-difference check on the first (scalar) state leaf
    state = list(helper.current_state)
    eps = 1e-6
    i = next(idx for idx, s in enumerate(state) if np.asarray(s).size == 1)
    sp = list(state)
    sp[i] = state[i] + eps
    sm = list(state)
    sm[i] = state[i] - eps
    fd = (float(fn(*sp)) - float(fn(*sm))) / (2 * eps)
    np.testing.assert_allclose(float(np.asarray(grads[i]).ravel()[0]), fd, rtol=1e-4)


def test_helper_rejects_non_parameters_and_missing_priors():
    v = gpflow_tpu_torch.Parameter(0.1)  # no prior
    with pytest.raises(ValueError, match="Parameter objects with priors"):
        SamplingHelper(lambda: v.value**2, (v,))
    with pytest.raises(ValueError, match="Parameter objects with priors"):
        SamplingHelper(lambda: 0.0, (np.zeros(2),))


def test_mcmc_sampler_integration_and_constrained_conversion():
    """End-to-end chain on the GPR posterior: shapes, final-state consistency,
    and transform-consistency of the constrained samples (reference
    ``test_mcmc.py:178-220``)."""
    model = build_model()
    helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
    num_samples = 5
    samples, log_probs = run_hmc(
        helper.target_log_prob_fn,
        helper.current_state,
        num_samples=num_samples,
        num_burnin_steps=2,
        step_size=0.01,
        num_leapfrog_steps=2,
        generator=seeded_generator(0),
    )
    assert len(samples) == len(model.trainable_parameters)
    parameter_samples = helper.convert_to_constrained_values(samples)
    assert len(parameter_samples) == len(samples)
    for s, c, p in zip(samples, parameter_samples, helper._parameters):
        assert np.asarray(s).shape[0] == num_samples
        np.testing.assert_allclose(
            np.asarray(c[-1]), np.asarray(p.transform.forward(s[-1])), rtol=1e-12
        )
    # writing the last state back moves the parameters to the chain end
    helper.assign_values([s[-1] for s in samples])
    for s, p in zip(samples, helper._parameters):
        np.testing.assert_allclose(
            np.asarray(p.unconstrained_variable), np.asarray(s[-1]), rtol=1e-12
        )
