"""The non-conjugate likelihoods of gpflow_tpu_torch against gpflow_tpu on the
CPU: ``inv_probit``, the Bernoulli and Poisson log densities, and every
statistic of Bernoulli, Poisson (the exp closed form and a softplus link
through the quadrature) and Ordinal, values and gradients, on the same numpy
inputs. Both sides evaluate the same float64 formulas, and the quadrature the
same 20-point sums in another order: 1e-10 relative, with 1e-10 of the
largest entry as an absolute floor."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu import logdensities as jax_logdensities
from gpflow_tpu.likelihoods import utils as jax_utils
from gpflow_tpu.models import SVGP as JaxSVGP
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, likelihoods, logdensities
from gpflow_tpu_torch.likelihoods import utils
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.utilities import load_jax_values
from gpflow_tpu_torch.utilities import read_values as port_read_values
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
N, P = 13, 2
BIN_EDGES = np.array([-1.0, 0.0, 1.5])


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def test_inv_probit_matches_jax():
    x = np.linspace(-9.0, 9.0, 101)
    _close(utils.inv_probit(torch.from_numpy(x)), jax_utils.inv_probit(jnp.asarray(x)))
    got = utils.inv_probit(torch.from_numpy(x).float())
    assert got.dtype == torch.float32 and bool(((got > 0) & (got < 1)).all())


def test_logdensities_match_jax():
    rng = np.random.RandomState(0)
    x01, p = (rng.rand(5, 3) > 0.5).astype(float), 0.05 + 0.9 * rng.rand(5, 3)
    _close(logdensities.bernoulli(torch.from_numpy(x01), torch.from_numpy(p)), jax_logdensities.bernoulli(x01, p))
    counts, lam = rng.poisson(3.0, (5, 3)).astype(float), 0.1 + 4 * rng.rand(5, 3)
    _close(logdensities.poisson(torch.from_numpy(counts), torch.from_numpy(lam)),
           jax_logdensities.poisson(counts, lam))


def _pair(name):
    """(JAX likelihood, port likelihood, Y) for ``name``."""
    rng = np.random.RandomState(len(name))
    if name == "Bernoulli":
        return gpflow_tpu.likelihoods.Bernoulli(), likelihoods.Bernoulli(), (rng.rand(N, P) > 0.4).astype(float)
    if name == "Bernoulli-sigmoid":
        return (gpflow_tpu.likelihoods.Bernoulli(invlink=jax.nn.sigmoid),
                likelihoods.Bernoulli(invlink=torch.sigmoid), (rng.rand(N, P) > 0.4).astype(float))
    counts = rng.poisson(2.0, (N, P)).astype(float)
    if name == "Poisson":
        return gpflow_tpu.likelihoods.Poisson(binsize=0.7), likelihoods.Poisson(binsize=0.7), counts
    if name == "Poisson-softplus":
        return (gpflow_tpu.likelihoods.Poisson(invlink=jax.nn.softplus, binsize=0.7),
                likelihoods.Poisson(invlink=torch.nn.functional.softplus, binsize=0.7), counts)
    jl, pl = gpflow_tpu.likelihoods.Ordinal(BIN_EDGES), likelihoods.Ordinal(BIN_EDGES)
    jl.sigma.assign(0.7)
    pl.sigma.assign(0.7)
    return jl, pl, rng.randint(0, len(BIN_EDGES) + 1, (N, P)).astype(float)


LIKELIHOODS = ["Bernoulli", "Bernoulli-sigmoid", "Poisson", "Poisson-softplus", "Ordinal"]
METHODS = ["variational_expectations", "predict_log_density", "predict_mean_and_var",
           "conditional_mean", "conditional_variance", "log_prob"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", LIKELIHOODS)
def test_likelihood_statistics_and_gradients_match_jax_f64(name, method):
    jl, pl, Y = _pair(name)
    rng = np.random.RandomState(7)
    X, Fmu, Fvar = rng.randn(N, 3), 0.8 * rng.randn(N, P), 0.05 + rng.rand(N, P)
    if method in ("conditional_mean", "conditional_variance"):
        args = (Fmu,)
    elif method == "log_prob":
        args = (Fmu, Y)
    elif method == "predict_mean_and_var":
        args = (Fmu, Fvar)
    else:
        args = (Fmu, Fvar, Y)
    n_diff = 2 if method in ("variational_expectations", "predict_log_density", "predict_mean_and_var") else 1

    def jax_fn(*a):
        out = getattr(jl, method)(X, *a)
        return out if method != "predict_mean_and_var" else jnp.stack(out)

    want = jax_fn(*args)
    leaves = [torch.tensor(a, requires_grad=i < n_diff) for i, a in enumerate(args)]
    got = getattr(pl, method)(torch.from_numpy(X), *leaves)
    got = got if method != "predict_mean_and_var" else torch.stack(got)
    _close(got, want)
    # the gradient of a weighted sum, with respect to Fmu (and Fvar)
    weights = rng.randn(*np.shape(want))
    want_grads = reference_jit(jax.grad(lambda *a: jnp.sum(jax_fn(*a) * weights), argnums=tuple(range(n_diff))))(
        *map(jnp.asarray, args))
    torch.sum(got * torch.from_numpy(weights)).backward()
    for t, w in zip(leaves, want_grads):
        _close(t.grad, w)


def test_ordinal_sigma_gradient_matches_jax():
    jl, pl, Y = _pair("Ordinal")
    rng = np.random.RandomState(8)
    X, Fmu, Fvar = rng.randn(N, 3), rng.randn(N, P), 0.05 + rng.rand(N, P)

    def jax_fn(sigma):
        jl.sigma._unconstrained = jl.sigma.transform.inverse(sigma)
        return jnp.sum(jl.variational_expectations(X, Fmu, Fvar, Y))

    want, want_grad = jax.value_and_grad(jax_fn)(jnp.asarray(0.7))
    got = torch.sum(pl.variational_expectations(*map(torch.from_numpy, (X, Fmu, Fvar, Y))))
    got.backward()
    _close(got, want)
    u = pl.sigma.unconstrained  # the gradient with respect to the constrained sigma
    _close(u.grad / torch.sigmoid(u.detach()), want_grad)


@pytest.mark.parametrize("label", [-1.0, 4.0])
def test_ordinal_label_out_of_range_gives_nan(label):
    jl, pl, Y = _pair("Ordinal")
    Y[3, 0] = label
    rng = np.random.RandomState(9)
    X, F = rng.randn(N, 3), rng.randn(N, P)
    got = pl.log_prob(torch.from_numpy(X), torch.from_numpy(F), torch.from_numpy(Y))
    want = np.asarray(jl.log_prob(X, F, Y))
    assert np.isnan(want[3]) and torch.isnan(got[3])
    assert torch.isfinite(torch.cat([got[:3], got[4:]])).all()
    _close(torch.cat([got[:3], got[4:]]), np.concatenate([want[:3], want[4:]]))


def test_gaussian_conditional_moments_match_jax():
    rng = np.random.RandomState(10)
    X, F = rng.randn(N, 3), rng.randn(N, P)
    jl, pl = gpflow_tpu.likelihoods.Gaussian(0.3), likelihoods.Gaussian(0.3)
    for method in ("conditional_mean", "conditional_variance"):
        _close(getattr(pl, method)(torch.from_numpy(X), torch.from_numpy(F)), getattr(jl, method)(X, F))


def test_quadrature_defaults_and_dimensions_match_jax():
    assert likelihoods.DEFAULT_NUM_GAUSS_HERMITE_POINTS == gpflow_tpu.likelihoods.DEFAULT_NUM_GAUSS_HERMITE_POINTS
    for name in LIKELIHOODS:
        jl, pl, _ = _pair(name)
        assert (pl.input_dim, pl.latent_dim, pl.observation_dim) == (None, None, None)
        assert pl._quadrature_dim == jl._quadrature_dim == 1
        assert pl.quadrature.n_gh == jl.quadrature.n_gh == 20
        assert pl.safe_observation == jl.safe_observation


def test_bernoulli_probit_float32_probabilities_in_range():
    # the squashed probit keeps the predictive probability within
    # (1e-3, 1 - 1e-3) in float32, even for a latent mean far from zero
    pl = likelihoods.Bernoulli()
    Fmu = torch.tensor([[-40.0], [0.0], [40.0]])
    p, v = pl.predict_mean_and_var(torch.zeros(3, 1), Fmu, torch.full((3, 1), 0.1))
    assert p.dtype == torch.float32
    assert bool(((p >= 1e-3) & (p <= 1 - 1e-3)).all()) and bool((v > 0).all())


@pytest.mark.parametrize("name", ["Bernoulli", "Ordinal"])
def test_load_jax_values_carries_a_classifier(name):
    # q_mu, q_sqrt, the kernel, Z and Ordinal's sigma of a JAX SVGP classifier
    # reach the port through read_values / load_jax_values
    jl, pl, _ = _pair(name)
    rng = np.random.RandomState(11)
    Mz, Dx = 6, 3
    X = rng.rand(20, Dx) * 2
    Y = (rng.rand(20, 1) > 0.5).astype(float) if name == "Bernoulli" else rng.randint(0, 4, (20, 1)).astype(float)
    jm = JaxSVGP(kernel=gpflow_tpu.kernels.Matern52(lengthscales=np.ones(Dx)), likelihood=jl,
                 inducing_variable=rng.rand(Mz, Dx), num_data=100)
    q_sqrt = np.tril(0.2 * rng.randn(1, Mz, Mz)) + np.eye(Mz)[None]
    gpflow_tpu.utilities.multiple_assign(jm, {".q_mu": rng.randn(Mz, 1), ".q_sqrt": q_sqrt,
                                              ".kernel.variance": 1.7, ".kernel.lengthscales": 0.5 + rng.rand(Dx)})
    pm = SVGP(kernel=kernels.Matern52(lengthscales=np.ones(Dx)), likelihood=pl,
              inducing_variable=np.zeros((Mz, Dx)), num_data=100)
    load_jax_values(pm, read_values(jm))
    want, got = read_values(jm), port_read_values(pm)
    assert sorted(want) == sorted(got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with torch.no_grad():
        _close(pm.elbo((torch.from_numpy(X), torch.from_numpy(Y))), jm.elbo((X, Y)))
