"""The JAX package's ``tests/gpflow_tpu/models/test_hmc_conjugate_oracle.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; each ``PRNGKey`` is a seeded generator (ROADMAP Queue 3, "the draws"),
and the file is ``slow`` as the JAX file is.

Conjugate-case HMC oracles.

With a GAUSSIAN likelihood and fixed hyperparameters the MCMC targets have
closed forms, so a long chain's sample moments can be asserted against
analytic posteriors within Monte-Carlo error — the standard way to catch a
subtly wrong leapfrog/Jacobian that still "recovers signal":

* GPMC: p(f | y) is the exact GPR posterior at the training inputs
  (f = L v, v ~ N(0, I), y = f + eps; ref models/gpmc.py:34-128).
* SGPMC: the target over u = L_z v is exactly SGPR's optimal q(u)
  (Hensman 2015; ref models/sgpmc.py:33-135, sgpr.py:342-377
  ``compute_qu``) — the SVGP-optimum equivalence route.

Both chains run jit-scanned on CPU (conftest pins the platform); marked
slow (~2000 kept samples each).
"""
import numpy as np
import pytest

from gpflow_tpu_torch import kernels, likelihoods, set_trainable
from gpflow_tpu_torch.config import default_jitter
from gpflow_tpu_torch.models import GPMC, SGPMC, SGPR
from gpflow_tpu_torch.optimizers import SamplingHelper, run_hmc
from .test_torch_translated_support import seeded_generator, translated_test_environment  # noqa: F401

pytestmark = pytest.mark.slow

rng = np.random.RandomState(11)
N, D = 40, 1
X = np.sort(rng.rand(N, D) * 4.0, axis=0)
F_TRUE = np.sin(2.0 * X[:, :1])
NOISE = 0.05
Y = F_TRUE + np.sqrt(NOISE) * rng.randn(N, 1)
KERNEL_VAR, KERNEL_LS = 1.2, 0.7


def _kernel():
    return kernels.SquaredExponential(variance=KERNEL_VAR, lengthscales=KERNEL_LS)


def _run_chain(model, num_samples=2000, step_size=0.08, leapfrog=12, seed=3):
    # fixed hyperparameters: the chain state is ONLY the whitened V
    set_trainable(model.kernel, False)
    set_trainable(model.likelihood, False)
    if hasattr(model, "inducing_variable"):
        set_trainable(model.inducing_variable, False)
    helper = SamplingHelper(model.log_posterior_density, model.trainable_parameters)
    assert len(helper.current_state) == 1  # V only
    samples, logps = run_hmc(
        helper.target_log_prob_fn,
        helper.current_state,
        num_samples=num_samples,
        num_burnin_steps=500,
        step_size=step_size,
        num_leapfrog_steps=leapfrog,
        adapt_step_size=True,
        generator=seeded_generator(seed),
    )
    assert np.all(np.isfinite(np.asarray(logps)))
    return np.asarray(samples[0])[..., 0]  # [S, dim] (single latent GP)


def _moment_check(sample_f, mean_true, var_true, label):
    """Sample mean within ~5 MC standard errors (conservative ESS estimate
    via lag-1 autocorrelation), sample variance within 25% on average."""
    S = sample_f.shape[0]
    a = sample_f - sample_f.mean(0)
    lag1 = np.abs(np.sum(a[1:] * a[:-1], 0)) / (np.sum(a * a, 0) + 1e-12)
    ess = S * (1 - lag1) / (1 + lag1)
    mc_se = np.sqrt(var_true / np.maximum(ess, 10.0))
    err = np.abs(sample_f.mean(0) - mean_true)
    assert np.all(err < 5.0 * mc_se + 1e-3), (
        f"{label}: posterior-mean error {err.max():.4f} exceeds 5 MC SE "
        f"(max allowed {float((5 * mc_se + 1e-3).max()):.4f}; min ESS {ess.min():.0f})"
    )
    ratio = sample_f.var(0) / var_true
    assert 0.75 < float(np.mean(ratio)) < 1.25, (
        f"{label}: mean posterior-variance ratio {float(np.mean(ratio)):.3f}"
    )


def test_gpmc_gaussian_chain_matches_gpr_analytic_posterior():
    m = GPMC((X, Y), kernel=_kernel(), likelihood=likelihoods.Gaussian(NOISE))
    V_s = _run_chain(m)  # [S, N]

    # f samples: f = L v at the training inputs (model's own whitening)
    K = np.asarray(_kernel()(X)) + default_jitter() * np.eye(N)
    L = np.linalg.cholesky(K)
    F_s = V_s @ L.T  # [S, N]

    # analytic GPR posterior at the training inputs, dense route
    Kn_inv = np.linalg.inv(K + NOISE * np.eye(N))
    mean = (K @ Kn_inv @ Y)[:, 0]
    cov = K - K @ Kn_inv @ K
    _moment_check(F_s, mean, np.diag(cov), "GPMC vs GPR")


def test_sgpmc_gaussian_chain_matches_sgpr_optimal_qu():
    M = 8
    Z = np.linspace(X.min(), X.max(), M)[:, None]
    m = SGPMC(
        (X, Y), kernel=_kernel(), likelihood=likelihoods.Gaussian(NOISE),
        inducing_variable=Z.copy(),
    )
    V_s = _run_chain(m)  # [S, M]

    Kzz = np.asarray(_kernel()(Z)) + default_jitter() * np.eye(M)
    Lz = np.linalg.cholesky(Kzz)
    U_s = V_s @ Lz.T  # [S, M] samples of u = L_z v

    sgpr = SGPR((X, Y), kernel=_kernel(), inducing_variable=Z.copy(), noise_variance=NOISE)
    qu_mean, qu_cov = sgpr.compute_qu()
    _moment_check(U_s, np.asarray(qu_mean)[:, 0], np.diag(np.asarray(qu_cov)),
                  "SGPMC vs SGPR q(u)")
