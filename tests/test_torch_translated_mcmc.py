"""The JAX package's ``tests/gpflow_tpu/optimizers/test_mcmc.py``, translated onto
the port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; each ``PRNGKey`` is a seeded generator (ROADMAP
Queue 3, "the draws").

HMC sampler behavior (counterpart of reference
``tests/gpflow/optimizers/test_mcmc.py`` + the SimpleStepSizeAdaptation
usage in the mcmc notebook).
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch.optimizers.mcmc import run_hmc
from .test_torch_translated_support import X64, asarray, seeded_generator, translated_test_environment  # noqa: F401

MU = np.array([1.5, -0.7])
SIG = np.array([0.8, 2.0])
_MU, _SIG = asarray(MU), asarray(SIG)  # the constants that a trace holds, uploaded once


def _logp(x):
    return -0.5 * torch.sum(((x - _MU) / _SIG) ** 2)


def test_hmc_recovers_gaussian_moments():
    samples, logps = run_hmc(
        _logp, (torch.zeros(2, **X64),), num_samples=3000, num_burnin_steps=500,
        step_size=0.5, num_leapfrog_steps=8, generator=seeded_generator(0),
    )
    s = np.asarray(samples[0])
    np.testing.assert_allclose(s.mean(0), MU, atol=0.2)
    np.testing.assert_allclose(s.std(0), SIG, rtol=0.25)
    assert np.isfinite(np.asarray(logps)).all()


def test_step_size_adaptation_rescues_bad_initial_step():
    """Dual averaging must tune a hopeless step size (5.0: every proposal
    rejected) into a working sampler during burn-in."""
    samples, _ = run_hmc(
        _logp, (torch.zeros(2, **X64),), num_samples=3000, num_burnin_steps=800,
        step_size=5.0, num_leapfrog_steps=8, adapt_step_size=True,
        generator=seeded_generator(3),
    )
    s = np.asarray(samples[0])
    moved = np.mean(np.any(np.diff(s, axis=0) != 0, axis=1))
    assert moved > 0.4  # near target_accept; an unadapted chain moves ~0
    np.testing.assert_allclose(s.mean(0), MU, atol=0.2)
    np.testing.assert_allclose(s.std(0), SIG, rtol=0.25)

    # contrast: same bad step WITHOUT adaptation never moves
    samples2, _ = run_hmc(
        _logp, (torch.zeros(2, **X64),), num_samples=300, num_burnin_steps=100,
        step_size=5.0, num_leapfrog_steps=8, generator=seeded_generator(3),
    )
    s2 = np.asarray(samples2[0])
    assert np.mean(np.any(np.diff(s2, axis=0) != 0, axis=1)) < 0.1


def test_thinning_and_burnin_shapes():
    samples, logps = run_hmc(
        _logp, (torch.zeros(2, **X64),), num_samples=50, num_burnin_steps=20,
        step_size=0.5, thin=3, generator=seeded_generator(1),
    )
    assert np.asarray(samples[0]).shape == (50, 2)
    assert np.asarray(logps).shape == (50,)


def test_tuple_state_multiple_leaves():
    def logp2(a, b):
        return -0.5 * torch.sum(a**2) - 0.5 * torch.sum((b - 2.0) ** 2)

    samples, _ = run_hmc(
        logp2, (torch.zeros(3, **X64), torch.zeros((), **X64)), num_samples=2000,
        num_burnin_steps=300, step_size=0.4, generator=seeded_generator(2),
    )
    np.testing.assert_allclose(np.asarray(samples[0]).mean(0), 0.0, atol=0.2)
    np.testing.assert_allclose(np.asarray(samples[1]).mean(), 2.0, atol=0.2)
