"""GPMC, SGPMC, ``SamplingHelper``, ``run_hmc``, ``sample_mvn``, both
``sample_conditional`` implementations and ``GPModel.predict_f_samples`` in
gpflow_tpu_torch against gpflow_tpu, on the CPU, on the same seeded numpy
inputs and values. In float64: the models' densities, their gradients with
respect to every trainable parameter, ``target_log_prob_fn`` and its
gradient (``jax.grad`` of the JAX one) and the predictions agree to 1e-10
relative to the largest entry; one leapfrog trajectory from the same
momentum agrees with the recurrence of ``gpflow_tpu/optimizers/mcmc.py``
evaluated with ``jax.grad`` to 1e-9; samples from the same standard normal
draws (JAX's, from its key) agree to 1e-12. The chains themselves draw from
a ``torch.Generator``, which has no bit-for-bit counterpart of JAX's keys:
short chains are checked for their contract, and a small Gaussian target
for its moments."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, models, set_trainable
from gpflow_tpu_torch.conditionals import multioutput, sample_conditionals, util
from gpflow_tpu_torch.optimizers import SamplingHelper, run_hmc
from gpflow_tpu_torch.optimizers import mcmc
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
LEAPFROG_RTOL = 1e-9
SAMPLE_RTOL = 1e-12
N, D, M, NEW = 20, 2, 5, 6


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _data(likelihood, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, D) * 3.0
    F = np.sin(2.0 * X[:, :1]) + 0.3 * np.cos(X[:, 1:])
    Y = (F + 0.3 * rng.randn(N, 1) > 0).astype(float) if likelihood == "Bernoulli" else F + 0.1 * rng.randn(N, 1)
    return X, Y, rng.rand(NEW, D) * 3.0, rng.rand(M, D) * 3.0


def _build(pkg, cls, likelihood, X, Y, Z, freeze_z=False):
    k = pkg.kernels.Matern32(variance=1.2, lengthscales=[0.8, 1.3])
    k.variance.prior = pkg.priors.LogNormal(0.0, 1.0)
    k.lengthscales.prior = pkg.priors.LogNormal(0.0, 1.0)
    lik = getattr(pkg.likelihoods, likelihood)()
    if likelihood == "Gaussian":
        lik.variance.prior = pkg.priors.Gamma(2.0, 4.0)
    if cls == "GPMC":
        return pkg.models.GPMC((X, Y), kernel=k, likelihood=lik)
    m = pkg.models.SGPMC((X, Y), kernel=k, likelihood=lik, inducing_variable=Z.copy())
    if freeze_z:
        pkg.set_trainable(m.inducing_variable, False)
    return m


def _models(cls, likelihood, seed=0, freeze_z=False):
    X, Y, Xnew, Z = _data(likelihood, seed)
    jm = _build(gpflow_tpu, cls, likelihood, X, Y, Z, freeze_z)
    pm = _build(gpflow_tpu_torch, cls, likelihood, X, Y, Z, freeze_z)
    jm.V.assign(0.7 * np.random.RandomState(seed + 100).randn(*jm.V.shape))
    load_jax_values(pm, read_values(jm))
    return jm, pm, Xnew


CASES = [(cls, lik) for cls in ("GPMC", "SGPMC") for lik in ("Bernoulli", "Gaussian")]


def _value_and_grads(jm, pm, jfn, pfn):
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    jv, jg = jax.jit(jax.value_and_grad(functionalize(jfn, [jparams[p] for p in paths])))(
        tuple(jparams[p].unconstrained_variable for p in paths)
    )
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    assert sorted(params) == paths
    pv = pfn()
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths])
    return (jv, dict(zip(paths, jg))), (pv.detach(), dict(zip(paths, pg)))


@pytest.mark.parametrize("objective", ["log_posterior_density", "training_loss", "maximum_log_likelihood_objective"])
@pytest.mark.parametrize("cls, likelihood", CASES)
def test_density_and_gradients_match_jax(cls, likelihood, objective):
    jm, pm, _ = _models(cls, likelihood)
    (jv, jg), (pv, pg) = _value_and_grads(jm, pm, getattr(jm, objective), getattr(pm, objective))
    _close(pv, jv)
    for path in jg:
        _close(pg[path], jg[path])


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("cls, likelihood", CASES)
def test_predictions_match_jax(cls, likelihood, full_cov):
    jm, pm, Xnew = _models(cls, likelihood, seed=1)
    with torch.no_grad():
        mu, var = pm.predict_f(_t(Xnew), full_cov=full_cov)
        ymu, yvar = pm.predict_y(_t(Xnew))
    (jmu, jvar), (jymu, jyvar) = jax.jit(lambda: (jm.predict_f(Xnew, full_cov=full_cov), jm.predict_y(Xnew)))()
    for got, want in ((mu, jmu), (var, jvar), (ymu, jymu), (yvar, jyvar)):
        _close(got, want)


def test_model_defaults():
    jm, pm, _ = _models("SGPMC", "Bernoulli")
    assert pm.V.prior == gpflow_tpu_torch.priors.Normal(0.0, 1.0) and pm.V.shape == (M, 1)
    assert pm.V.device == torch.device("cpu") and pm.data[0].dtype == torch.float64
    gm = models.GPMC((np.zeros((3, 1)), np.zeros((3, 2))), gpflow_tpu_torch.kernels.Matern32(),
                     gpflow_tpu_torch.likelihoods.Gaussian())
    assert gm.V.shape == (3, 2) and gm.num_latent_gps == 2
    with pytest.raises(NotImplementedError):
        gm.predict_f(torch.zeros(2, 1, dtype=torch.float64), full_output_cov=True)


def _helpers(cls, likelihood, seed=2):
    """The JAX and the port's SamplingHelper over the same parameters, in
    the order of their paths, with Z frozen."""
    jm, pm, _ = _models(cls, likelihood, seed=seed, freeze_z=True)
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    pparams = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    paths = sorted(jparams)
    assert sorted(pparams) == paths
    jh = gpflow_tpu.optimizers.SamplingHelper(jm.log_posterior_density, [jparams[p] for p in paths])
    ph = SamplingHelper(pm.log_posterior_density, [pparams[p] for p in paths])
    return jm, pm, jh, ph, paths


def _state(jh, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    return [np.asarray(s) + scale * rng.randn(*np.shape(s)) for s in jh.current_state]


@pytest.mark.parametrize("cls, likelihood", CASES)
def test_target_log_prob_fn_and_gradient_match_jax(cls, likelihood):
    jm, pm, jh, ph, paths = _helpers(cls, likelihood)
    for s_now, s in zip(ph.current_state, jh.current_state):
        _close(s_now, s, 0.0)
    before = read_values(pm)
    state = _state(jh, 7)
    jv, jg = jax.jit(jax.value_and_grad(lambda *s: jh.target_log_prob_fn(*s), argnums=tuple(range(len(state)))))(
        *[jnp.asarray(s) for s in state])
    q = [_t(s).requires_grad_() for s in state]
    pv = ph.target_log_prob_fn(*q)
    pg = torch.autograd.grad(pv, q)
    _close(pv, jv)
    for got, want in zip(pg, jg):
        _close(got, want)
    # pure: the parameters keep their values, and the value at the current
    # state is the model's own log posterior plus the Jacobians
    for path, value in read_values(pm).items():
        np.testing.assert_array_equal(value, before[path])
    with torch.no_grad():
        at_current = ph.target_log_prob_fn(*ph.current_state)
    _close(at_current, jax.jit(jh.target_log_prob_fn)(*jh.current_state))


def test_convert_and_assign_values_match_jax():
    jm, pm, jh, ph, paths = _helpers("GPMC", "Gaussian")
    rng = np.random.RandomState(5)
    stacked = [np.asarray(s)[None] + 0.2 * rng.randn(3, *np.shape(s)) for s in jh.current_state]
    for got, want in zip(ph.convert_to_constrained_values([_t(s) for s in stacked]),
                         jh.convert_to_constrained_values([jnp.asarray(s) for s in stacked])):
        _close(got, want, SAMPLE_RTOL)
    state = _state(jh, 8)
    jh.assign_values([jnp.asarray(s) for s in state])
    ph.assign_values([_t(s) for s in state])
    want = read_values(jm)
    for path, value in read_values(pm).items():
        _close(value, want[path], SAMPLE_RTOL)


def test_parameters_without_priors_are_refused():
    _, pm, _ = _models("SGPMC", "Bernoulli")  # Z is trainable and has no prior
    with pytest.raises(ValueError, match="with priors"):
        SamplingHelper(pm.log_posterior_density, pm.trainable_parameters)


@pytest.mark.parametrize("cls, likelihood", CASES)
def test_one_leapfrog_trajectory_matches_jax(cls, likelihood):
    """``mcmc.py:121-133``'s recurrence with ``jax.grad`` of the JAX target,
    against the port's leapfrog from the same position and momentum."""
    jm, pm, jh, ph, paths = _helpers(cls, likelihood, seed=3)
    q0 = _state(jh, 9, scale=0.1)
    p0 = [np.random.RandomState(10 + i).randn(*np.shape(s)) for i, s in enumerate(q0)]
    step, L = 0.05, 6
    grad_fn = jax.jit(jax.grad(lambda st: jh.target_log_prob_fn(*st)))
    q, p = tuple(jnp.asarray(s) for s in q0), tuple(jnp.asarray(s) for s in p0)
    g = grad_fn(q)
    p = tuple(pi + 0.5 * step * gi for pi, gi in zip(p, g))
    for _ in range(L - 1):
        q = tuple(qi + step * pi for qi, pi in zip(q, p))
        g = grad_fn(q)
        p = tuple(pi + step * gi for pi, gi in zip(p, g))
    q = tuple(qi + step * pi for qi, pi in zip(q, p))
    g = grad_fn(q)
    p = tuple(pi + 0.5 * step * gi for pi, gi in zip(p, g))
    logp = jax.jit(jh.target_log_prob_fn)(*q)

    def value_and_grad(state):
        return mcmc._value_and_grad(ph.target_log_prob_fn, state)

    _, g0 = value_and_grad(tuple(_t(s) for s in q0))
    pq, pp, plogp, pg = mcmc._leapfrog(value_and_grad, tuple(_t(s) for s in q0), tuple(_t(s) for s in p0), g0,
                                       torch.tensor(step, dtype=torch.float64), L)
    _close(plogp, logp, LEAPFROG_RTOL)
    for got, want in zip(pq + pp + pg, q + p + g):
        _close(got, want, LEAPFROG_RTOL)


def test_run_hmc_contract():
    """Kept samples only, thinning, finite log probabilities, the state's
    device and dtype, the same chain from the same generator, and the
    parameters left as they were."""
    jm, pm, jh, ph, paths = _helpers("GPMC", "Bernoulli", seed=4)
    before = read_values(pm)

    def chain(seed):
        return run_hmc(ph.target_log_prob_fn, ph.current_state, num_samples=4, num_burnin_steps=3, step_size=0.05,
                       num_leapfrog_steps=3, generator=torch.Generator().manual_seed(seed), thin=2,
                       adapt_step_size=True)

    samples, log_probs = chain(0)
    assert len(samples) == len(paths) and log_probs.shape == (4,) and log_probs.dtype == torch.float64
    for s, c in zip(samples, ph.current_state):
        assert s.shape == (4,) + c.shape and s.dtype == c.dtype and bool(torch.all(torch.isfinite(s)))
    assert bool(torch.all(torch.isfinite(log_probs)))
    again, again_lp = chain(0)
    for a, b in zip(samples + (log_probs,), again + (again_lp,)):
        assert torch.equal(a, b)
    other, _ = chain(1)
    assert not torch.equal(other[-1], samples[-1])
    with torch.no_grad():  # each kept log probability is the target at its sample
        for j in range(4):
            _close(log_probs[j], ph.target_log_prob_fn(*[s[j] for s in samples]), 1e-12)
    for path, value in read_values(pm).items():
        np.testing.assert_array_equal(value, before[path])
    # without a generator the chain draws from one seeded 0
    a = run_hmc(ph.target_log_prob_fn, ph.current_state, num_samples=2, num_leapfrog_steps=2)
    b = run_hmc(ph.target_log_prob_fn, ph.current_state, num_samples=2, num_leapfrog_steps=2,
                generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(x, y) for x, y in zip(a[0] + (a[1],), b[0] + (b[1],)))


def test_run_hmc_gaussian_moments():
    """A correlated 2-D Gaussian target: with dual-averaging adaptation the
    kept samples' mean lies within 5 Monte-Carlo standard errors (effective
    sample size from the lag-1 autocorrelation) and their variances within
    25%."""
    cov = np.array([[1.0, 0.6], [0.6, 2.0]])
    prec, mean = _t(np.linalg.inv(cov)), _t(np.array([0.5, -1.0]))

    def target(x, y):
        d = torch.stack([x, y]) - mean
        return -0.5 * d @ prec @ d

    samples, log_probs = run_hmc(target, (torch.zeros((), dtype=torch.float64),) * 2, num_samples=600,
                                 num_burnin_steps=200, step_size=0.5, num_leapfrog_steps=5,
                                 generator=torch.Generator().manual_seed(3), adapt_step_size=True)
    s = torch.stack(samples, dim=-1).numpy()
    a = s - s.mean(0)
    lag1 = np.abs(np.sum(a[1:] * a[:-1], 0)) / np.sum(a * a, 0)
    ess = len(s) * (1 - lag1) / (1 + lag1)
    np.testing.assert_array_less(np.abs(s.mean(0) - mean.numpy()), 5.0 * np.sqrt(np.diag(cov) / ess))
    assert np.all(np.abs(s.var(0) / np.diag(cov) - 1.0) < 0.25), s.var(0)
    accepted = np.mean(np.any(s[1:] != s[:-1], axis=1))
    assert 0.5 < accepted < 0.98, accepted


def test_run_hmc_rejects_diverged_trajectories():
    """Where the target is NaN (a failed Cholesky gives NaN) the energy is
    not finite: the step is rejected, and the chain never leaves the region
    where the target is finite."""
    def target(x):
        return torch.where(x < 1.0, -0.5 * x * x, torch.nan)

    samples, log_probs = run_hmc(target, (torch.zeros((), dtype=torch.float64),), num_samples=200,
                                 step_size=0.3, num_leapfrog_steps=4, generator=torch.Generator().manual_seed(5))
    assert bool(torch.all(samples[0] < 1.0)) and bool(torch.all(torch.isfinite(log_probs)))
    assert float(samples[0].min()) < -0.5  # it moved


_normal = jax.jit(lambda key, shape: jax.random.normal(key, shape, dtype=jnp.float64), static_argnums=1)


def _jax_draws(key):
    """A stand-in for the port's ``sample_mvn`` that takes the standard
    normal draws the JAX package's ``sample_mvn`` takes from ``key``."""
    def draw(mean, cov, full_cov, num_samples=None, generator=None):
        S = 1 if num_samples is None else num_samples
        shape = tuple(mean.shape) + (S,) if full_cov else tuple(mean.shape[:-2]) + (S,) + tuple(mean.shape[-2:])
        eps = _t(np.asarray(_normal(key, shape)))
        return util._sample_mvn_with_eps(mean, cov, full_cov, eps, num_samples)

    return draw


@pytest.mark.parametrize("num_samples", [None, 3])
@pytest.mark.parametrize("full_cov", [False, True])
def test_sample_mvn_matches_jax(full_cov, num_samples):
    rng = np.random.RandomState(11)
    mean = rng.randn(2, 4, 3)
    if full_cov:
        A = rng.randn(2, 4, 3, 3)
        cov = A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)
    else:
        cov = rng.rand(2, 4, 3) + 0.1
    key = jax.random.PRNGKey(4)
    want = jax.jit(lambda k: gpflow_tpu.conditionals.util.sample_mvn(mean, cov, full_cov, num_samples=num_samples,
                                                                     key=k))(key)
    got = _jax_draws(key)(_t(mean), _t(cov), full_cov, num_samples)
    _close(got, want, SAMPLE_RTOL)
    # the public function: a shape of draws from the device's default
    # generator, which a generator in the same state reproduces
    same = torch.Generator()
    same.set_state(util.default_generator("cpu").get_state())
    out = util.sample_mvn(_t(mean), _t(cov), full_cov, num_samples=num_samples)
    assert out.shape == want.shape
    assert torch.equal(out, util.sample_mvn(_t(mean), _t(cov), full_cov, num_samples=num_samples, generator=same))


@pytest.mark.parametrize("full_cov, num_samples", [(False, None), (True, 4)])
@pytest.mark.parametrize("dense", [False, True])
def test_sample_conditional_matches_jax(dense, full_cov, num_samples, monkeypatch):
    rng = np.random.RandomState(12)
    X, Xnew = rng.rand(M, D) * 3.0, rng.rand(NEW, D) * 3.0
    f, q_sqrt = rng.randn(M, 2), np.tril(0.3 * rng.randn(2, M, M), -1) + 0.5 * np.eye(M)
    jk = gpflow_tpu.kernels.Matern32(lengthscales=[0.8, 1.3])
    pk = gpflow_tpu_torch.kernels.Matern32(lengthscales=[0.8, 1.3])
    jz = X if dense else gpflow_tpu.inducing_variables.InducingPoints(X)
    pz = _t(X) if dense else gpflow_tpu_torch.inducing_variables.InducingPoints(X)
    key = jax.random.PRNGKey(5)
    kwargs = dict(full_cov=full_cov, white=True, num_samples=num_samples)
    want = jax.jit(lambda k: gpflow_tpu.conditionals.sample_conditional(Xnew, jz, jk, f, q_sqrt=q_sqrt, key=k,
                                                                        **kwargs))(key)
    monkeypatch.setattr(sample_conditionals, "sample_mvn", _jax_draws(key))
    with torch.no_grad():
        got = gpflow_tpu_torch.conditionals.sample_conditional(_t(Xnew), pz, pk, _t(f), q_sqrt=_t(q_sqrt), **kwargs)
    for g, w in zip(got, want):
        _close(g, w, SAMPLE_RTOL)


@pytest.mark.parametrize("full_output_cov", [False, True])
@pytest.mark.parametrize("full_cov", [False, True])
def test_sample_conditional_coregionalization_matches_jax(full_cov, full_output_cov, monkeypatch):
    rng = np.random.RandomState(13)
    L, P = 2, 3
    Zs, Xnew = [rng.rand(M, D) * 3.0 for _ in range(L)], rng.rand(NEW, D) * 3.0
    W, f = rng.randn(P, L), rng.randn(M, L)
    q_sqrt = np.tril(0.3 * rng.randn(L, M, M), -1) + 0.5 * np.eye(M)

    def parts(pkg):
        k = pkg.kernels.LinearCoregionalization(
            [pkg.kernels.Matern32(lengthscales=[0.8, 1.3]), pkg.kernels.SquaredExponential(variance=0.7)], W=W)
        iv = pkg.inducing_variables.SeparateIndependentInducingVariables(
            [pkg.inducing_variables.InducingPoints(Z) for Z in Zs])
        return k, iv

    (jk, jiv), (pk, piv) = parts(gpflow_tpu), parts(gpflow_tpu_torch)
    key = jax.random.PRNGKey(6)
    kwargs = dict(full_cov=full_cov, full_output_cov=full_output_cov, white=True, num_samples=5)
    want = jax.jit(lambda k: gpflow_tpu.conditionals.sample_conditional(Xnew, jiv, jk, f, q_sqrt=q_sqrt, key=k,
                                                                        **kwargs))(key)
    monkeypatch.setattr(multioutput.sample_conditionals, "sample_mvn", _jax_draws(key))
    with torch.no_grad():
        got = gpflow_tpu_torch.conditionals.sample_conditional(_t(Xnew), piv, pk, _t(f), q_sqrt=_t(q_sqrt), **kwargs)
    for g, w in zip(got, want):
        _close(g, w, SAMPLE_RTOL)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("cls", ["GPMC", "SGPMC"])
def test_predict_f_samples_matches_jax(cls, full_cov, monkeypatch):
    jm, pm, Xnew = _models(cls, "Gaussian", seed=6)
    key = jax.random.PRNGKey(7)
    want = jax.jit(lambda k: jm.predict_f_samples(Xnew, num_samples=4, full_cov=full_cov, key=k))(key)
    monkeypatch.setattr(models.model, "sample_mvn", _jax_draws(key))
    with torch.no_grad():
        got = pm.predict_f_samples(_t(Xnew), num_samples=4, full_cov=full_cov)
    _close(got, want, SAMPLE_RTOL)
    with pytest.raises(NotImplementedError):
        pm.predict_f_samples(_t(Xnew), full_cov=True, full_output_cov=True)


def test_sgpmc_chain_moves_with_frozen_z():
    """``set_trainable`` freezes Z, so the chain's state is the kernel's
    parameters and V; a short adapted chain on the Bernoulli SGPMC moves
    every part of it and leaves Z where it was."""
    _, pm, _, ph, paths = _helpers("SGPMC", "Bernoulli", seed=5)
    assert paths == [".V", ".kernel.lengthscales", ".kernel.variance"]
    Z = pm.inducing_variable.Z.numpy()
    set_trainable(pm.inducing_variable, False)
    samples, log_probs = run_hmc(ph.target_log_prob_fn, ph.current_state, num_samples=10, num_burnin_steps=10,
                                 step_size=0.1, num_leapfrog_steps=4, generator=torch.Generator().manual_seed(2),
                                 adapt_step_size=True)
    for s, c in zip(samples, ph.current_state):
        assert not torch.equal(s[-1], c)
    constrained = ph.convert_to_constrained_values(samples)
    assert bool(torch.all(constrained[1] > 0)) and bool(torch.all(constrained[2] > 0))
    np.testing.assert_array_equal(pm.inducing_variable.Z.numpy(), Z)
