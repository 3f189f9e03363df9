"""The JAX package's ``tests/gpflow_tpu/models/test_cglb_mcmc.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; ``jax.grad`` through a swapped unconstrained value is autograd through
``base.functionalize``, and each ``PRNGKey`` a seeded generator.

Tests for CGLB (bounds ordering vs SGPR/GPR) and the MCMC stack
(GPMC/SGPMC + SamplingHelper + built-in HMC).
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch import kernels, likelihoods, priors
from gpflow_tpu_torch.base import functionalize
from gpflow_tpu_torch.models import CGLB, GPMC, GPR, SGPMC, SGPR
from gpflow_tpu_torch.optimizers import SamplingHelper
from gpflow_tpu_torch.optimizers.mcmc import run_hmc
from .test_torch_translated_support import X64, grad, seeded_generator, translated_test_environment  # noqa: F401

rng = np.random.RandomState(11)
N, D = 30, 2
X = rng.rand(N, D)
Y = np.sin(4 * X[:, :1]) + 0.1 * rng.randn(N, 1)
Xtest = rng.rand(5, D)
NOISE = 0.05


def _kernel():
    return kernels.SquaredExponential(variance=1.1, lengthscales=0.5)


def test_cglb_bound_between_sgpr_and_gpr():
    Z = X[::3].copy()
    gpr = GPR((X, Y), kernel=_kernel(), noise_variance=NOISE)
    sgpr = SGPR((X, Y), kernel=_kernel(), inducing_variable=Z.copy(), noise_variance=NOISE)
    cglb = CGLB(
        (X, Y), kernel=_kernel(), inducing_variable=Z.copy(), noise_variance=NOISE,
        cg_tolerance=1e-8,
    )
    lml = float(gpr.log_marginal_likelihood())
    sgpr_elbo = float(sgpr.elbo())
    cglb_bound = float(cglb.elbo())
    # CGLB tightens SGPR and lower-bounds the exact marginal likelihood
    assert sgpr_elbo <= cglb_bound + 1e-6
    assert cglb_bound <= lml + 1e-5


def test_cglb_predict_close_to_gpr_with_tight_cg():
    gpr = GPR((X, Y), kernel=_kernel(), noise_variance=NOISE)
    cglb = CGLB(
        (X, Y), kernel=_kernel(), inducing_variable=X[::2].copy(), noise_variance=NOISE,
        cg_tolerance=1e-10, max_cg_iters=200,
    )
    m1, _ = gpr.predict_f(Xtest)
    m2, _ = cglb.predict_f(Xtest, cg_tolerance=1e-10)
    # CG mean interpolates between SGPR and exact GP mean; with v ~= K^-1 y it
    # recovers the exact mean
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), atol=1e-4)


def test_cglb_aux_vector_warm_start():
    cglb = CGLB(
        (X, Y), kernel=_kernel(), inducing_variable=X[::3].copy(), noise_variance=NOISE,
        cg_tolerance=1e-6,
    )
    assert np.allclose(cglb.aux_vec.numpy(), 0.0)
    float(cglb.elbo())  # runs CG and caches v
    assert not np.allclose(cglb.aux_vec.numpy(), 0.0)


def test_cglb_v_grad_optimization_mode():
    cglb = CGLB(
        (X, Y), kernel=_kernel(), inducing_variable=X[::3].copy(), noise_variance=NOISE,
        v_grad_optimization=True,
    )
    assert cglb.aux_vec.trainable
    loss = float(cglb.training_loss())
    assert np.isfinite(loss)
    # gradient flows to v
    g = grad(
        lambda u: _loss_with_v(cglb, u)
    )(cglb.aux_vec.unconstrained_variable)
    assert np.any(np.abs(np.asarray(g)) > 0)


def _loss_with_v(model, u):
    return functionalize(model.training_loss, [model._v])([u])


def test_gpmc_log_posterior_and_predict():
    Yb = (Y > 0).astype(float)
    m = GPMC((X, Yb), kernel=_kernel(), likelihood=likelihoods.Bernoulli())
    lp = float(m.log_posterior_density())
    assert np.isfinite(lp)
    # with V=0 the whitened f equals the mean function
    mu, var = m.predict_f(Xtest)
    np.testing.assert_allclose(np.asarray(mu), 0.0, atol=1e-10)
    assert np.all(np.asarray(var) > 0)


def test_sgpmc_log_posterior():
    Yb = (Y > 0).astype(float)
    m = SGPMC(
        (X, Yb), kernel=_kernel(), likelihood=likelihoods.Bernoulli(),
        inducing_variable=X[::3].copy(),
    )
    assert np.isfinite(float(m.log_posterior_density()))


def test_sampling_helper_requires_priors():
    m = GPR((X, Y), kernel=_kernel(), noise_variance=0.1)
    with pytest.raises(ValueError):
        SamplingHelper(m.log_posterior_density, m.trainable_parameters)


def test_hmc_on_gpmc_recovers_signal():
    Yb = (Y > 0).astype(float)
    m = GPMC((X, Yb), kernel=_kernel(), likelihood=likelihoods.Bernoulli())
    # add priors so all trainable parameters are valid chain state
    m.kernel.variance.prior = priors.LogNormal(0.0, 1.0)
    m.kernel.lengthscales.prior = priors.LogNormal(-1.0, 1.0)
    helper = SamplingHelper(m.log_posterior_density, m.trainable_parameters)

    lp0 = helper.target_log_prob_fn(*helper.current_state)
    assert np.isfinite(float(lp0))

    samples, logps = run_hmc(
        helper.target_log_prob_fn,
        helper.current_state,
        num_samples=30,
        num_burnin_steps=30,
        step_size=0.03,
        num_leapfrog_steps=8,
        generator=seeded_generator(0),
    )
    assert logps.shape == (30,)
    assert np.all(np.isfinite(np.asarray(logps)))
    # chain must have moved away from the all-zeros initial state (note
    # typical-set samples have *lower* density than the V=0 near-mode start)
    assert not np.allclose(np.asarray(samples[0][-1]), np.asarray(helper.current_state[0]))
    constrained = helper.convert_to_constrained_values(samples)
    # variance samples must be positive after the transform
    var_idx = [i for i, p in enumerate(helper._parameters) if p is m.kernel.variance][0]
    assert np.all(np.asarray(constrained[var_idx]) > 0)


def test_hmc_samples_standard_normal():
    """Sanity: HMC targeting N(0, 1) produces ~unit-variance samples."""
    logp = lambda x: -0.5 * torch.sum(x ** 2)
    samples, _ = run_hmc(
        logp, (torch.zeros((2,), **X64),), num_samples=1500, num_burnin_steps=200,
        step_size=0.3, num_leapfrog_steps=5, generator=seeded_generator(1),
    )
    s = np.asarray(samples[0])
    assert abs(s.mean()) < 0.15
    assert abs(s.std() - 1.0) < 0.15
