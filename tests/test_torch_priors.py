"""Priors, the bijectors' log-det-Jacobians, the prior parts of ``Parameter``
and ``BayesianModel.log_prior_density`` in gpflow_tpu_torch against
gpflow_tpu, on the CPU, on the same seeded numpy inputs. In float64 every
log density, Jacobian and prior density agrees to 1e-12 relative to the
largest entry (NaN and -inf where the JAX package gives them); an SVGP's
training loss with priors and its gradients agree to 1e-10."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import PriorOn, bijectors, config, priors, set_trainable
from gpflow_tpu_torch.base import Parameter
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict, select_dict_parameters_with_prior

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-12
MODEL_RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    finite = np.isfinite(want)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~finite & ~np.isnan(want)], want[~finite & ~np.isnan(want)])
    scale = max(np.max(np.abs(want[finite]), initial=0.0), 1e-300)
    np.testing.assert_allclose(got[finite], want[finite], rtol=0.0, atol=rtol * scale)


# (name, hyperparameters, inputs inside the support, inputs outside it)
_RNG = np.random.RandomState(0)
_POSITIVE = np.concatenate([_RNG.rand(6) * 3.0 + 1e-3, [1e-8, 50.0]])
_REAL = np.concatenate([_RNG.randn(6) * 2.0, [0.0, -30.0]])
_UNIT = np.concatenate([_RNG.rand(6), [1e-9, 1.0 - 1e-9]])
PRIOR_CASES = [
    ("Normal", (0.3, 1.7), _REAL, np.array([])),
    ("LogNormal", (-0.2, 0.8), _POSITIVE, -_POSITIVE[:3]),
    ("Gamma", (2.0, 1.5), _POSITIVE, -_POSITIVE[:3]),
    ("Exponential", (0.7,), _POSITIVE, -_POSITIVE[:3]),
    ("Beta", (0.2, 5.0), _UNIT, np.array([-0.5, 1.5])),
    ("Beta", (2.5, 3.5), _UNIT, np.array([-0.5, 1.5])),
    ("Laplace", (0.5, 2.0), _REAL, np.array([])),
    ("StudentT", (3.0, 0.1, 1.3), _REAL, np.array([])),
    ("HalfNormal", (1.4,), _POSITIVE, -_POSITIVE[:3]),
    ("Uniform", (-1.0, 2.5), np.array([-1.0, 0.0, 1.3, 2.5]), np.array([-1.0 - 1e-9, 2.6, 30.0])),
]


@pytest.mark.parametrize("name, args, inside, outside", PRIOR_CASES, ids=[f"{c[0]}{c[1]}" for c in PRIOR_CASES])
def test_prior_log_prob_matches_jax(name, args, inside, outside):
    x = np.concatenate([inside, outside])
    want = getattr(gpflow_tpu.priors, name)(*args).log_prob(x)
    got = getattr(priors, name)(*args).log_prob(torch.from_numpy(x))
    assert got.dtype == torch.float64
    _close(got, want)
    if name in ("HalfNormal", "Uniform"):  # -inf outside the support, as in the JAX package
        assert torch.all(got[len(inside):] == -np.inf)


def test_prior_hyperparameters_are_python_floats():
    p = priors.Gamma(np.float32(2.0), 3)
    assert type(p.concentration) is float and type(p.rate) is float and p.name == "Gamma"
    with pytest.raises(TypeError, match="Python scalar"):
        priors.Normal(np.ones(2), 1.0)
    assert priors.Normal(0.0, 1.0) == priors.Normal(0, 1)  # frozen dataclasses compare by value


BIJECTOR_CASES = [
    ("Identity", {}, _REAL),
    ("Exp", {}, _REAL),
    ("Softplus", {}, np.concatenate([_REAL, [40.0, -40.0]])),
    ("Shift", {"shift": 0.3}, _REAL),
    ("Sigmoid", {}, _REAL),
    ("Sigmoid", {"low": -2.0, "high": 5.0}, _REAL),
    ("positive", {}, _REAL),
    ("positive", {"lower": 1e-3, "base": "exp"}, _REAL),
]


@pytest.mark.parametrize("name, kwargs, x", BIJECTOR_CASES, ids=[f"{c[0]}{c[1]}" for c in BIJECTOR_CASES])
def test_forward_log_det_jacobian_matches_jax(name, kwargs, x):
    want = getattr(gpflow_tpu.bijectors, name)(**kwargs).forward_log_det_jacobian(x)
    got = getattr(bijectors, name)(**kwargs).forward_log_det_jacobian(torch.from_numpy(x))
    _close(got, want)


def test_triangular_mask_log_det_jacobian_matches_jax():
    x = _RNG.randn(3, 4, 4)
    want = gpflow_tpu.bijectors.TriangularMask().forward_log_det_jacobian(x)
    _close(bijectors.triangular().forward_log_det_jacobian(torch.from_numpy(x)), want)


def test_forward_log_det_jacobian_is_the_log_slope():
    """The Jacobian of each elementwise bijector is its forward's slope (autograd)."""
    x = torch.from_numpy(_REAL).requires_grad_()
    for b in (bijectors.Exp(), bijectors.Softplus(), bijectors.Sigmoid(-2.0, 5.0), bijectors.positive()):
        (slope,) = torch.autograd.grad(b.forward(x).sum(), x)
        _close(b.forward_log_det_jacobian(x), torch.log(slope).detach().numpy(), rtol=1e-12)


PARAMETER_CASES = [
    ("positive", "Gamma", (2.0, 1.5), [0.4, 1.7, 3.0]),
    ("positive", "LogNormal", (0.0, 1.0), [0.4, 1.7]),
    ("Sigmoid", "Beta", (0.2, 5.0), [1e-3, 0.3]),
    ("Identity", "Normal", (0.5, 2.0), [-1.0, 0.3, 2.0]),
    ("Exp", "Uniform", (-1.0, 4.0), [0.4, 1.7]),
]


@pytest.mark.parametrize("prior_on", ["constrained", "unconstrained"])
@pytest.mark.parametrize("transform, prior, args, value", PARAMETER_CASES, ids=[c[1] for c in PARAMETER_CASES])
def test_parameter_log_prior_density_matches_jax(transform, prior, args, value, prior_on):
    def build(pkg):
        t = getattr(pkg.bijectors, transform)()
        return pkg.Parameter(np.asarray(value), transform=t, prior=getattr(pkg.priors, prior)(*args),
                             prior_on=prior_on)

    jp, pp = build(gpflow_tpu), build(gpflow_tpu_torch)
    assert pp.prior_on is PriorOn(prior_on)
    _close(pp.log_prior_density(), jp.log_prior_density())


def test_parameter_prior_metadata():
    p = Parameter(1.5, transform=bijectors.positive(), prior=priors.Gamma(2.0, 1.0), prior_on="unconstrained",
                  trainable=False)
    q = Parameter(p)  # copy-construction inherits the prior, where it applies and trainability
    assert q.prior == p.prior and q.prior_on is PriorOn.UNCONSTRAINED and not q.trainable
    r = Parameter(p, prior=priors.Normal(0.0, 1.0), prior_on=PriorOn.CONSTRAINED, trainable=True)
    assert r.prior == priors.Normal(0.0, 1.0) and r.prior_on is PriorOn.CONSTRAINED and r.trainable
    assert Parameter(1.0).prior is None and Parameter(1.0).prior_on is PriorOn.CONSTRAINED
    assert float(Parameter(1.0).log_prior_density()) == 0.0
    with pytest.raises(ValueError):
        p.prior_on = "nowhere"
    p.assign_unconstrained(np.asarray(-0.25))
    assert float(p.unconstrained) == -0.25
    assert p.numpy() == float(bijectors.positive().forward(torch.tensor(-0.25, dtype=torch.float64)))


def test_trainable_is_the_parameters_own_flag():
    """``trainable`` stays with the Parameter while another tensor stands in
    for its value (``SamplingHelper``'s state), and follows ``set_trainable``."""
    k = gpflow_tpu_torch.kernels.Matern32(variance=1.3)
    set_trainable(k, False)
    assert not k.variance.trainable and not k.variance.unconstrained.requires_grad
    set_trainable(k.variance, True)
    assert k.variance.trainable and k.variance.unconstrained.requires_grad
    assert gpflow_tpu_torch.PriorOn is PriorOn and gpflow_tpu_torch.priors is priors


def _svgp_pair(seed=0):
    rng = np.random.RandomState(seed)
    X, Z = rng.rand(40, 2) * 3.0, rng.rand(6, 2) * 3.0
    Y = np.sin(2.0 * X[:, :1]) + 0.1 * rng.randn(40, 1)
    q_sqrt = np.tril(0.1 * rng.randn(1, 6, 6), -1) + np.eye(6) * (0.5 + 0.5 * rng.rand(6))

    def build(pkg):
        k = pkg.kernels.Matern32(variance=1.2, lengthscales=[0.7, 1.4])
        k.variance.prior = pkg.priors.LogNormal(0.0, 1.0)
        k.lengthscales.prior = pkg.priors.Gamma(2.0, 2.0)
        lik = pkg.likelihoods.Gaussian(0.3)
        lik.variance.prior = pkg.priors.HalfNormal(1.0)
        lik.variance.prior_on = "unconstrained"
        m = pkg.models.SVGP(k, lik, Z.copy(), num_data=40)
        m.inducing_variable.Z.prior = pkg.priors.Normal(1.0, 2.0)
        return m

    jm, pm = build(gpflow_tpu), build(gpflow_tpu_torch)
    jm.q_mu.assign(0.5 * rng.randn(6, 1))
    jm.q_sqrt.assign(q_sqrt)
    load_jax_values(pm, read_values(jm))
    return jm, pm, (X, Y)


def test_model_log_prior_density_and_training_loss_match_jax():
    jm, pm, (X, Y) = _svgp_pair()
    assert sorted(select_dict_parameters_with_prior(pm)) == sorted(
        gpflow_tpu.utilities.select_dict_parameters_with_prior(jm))
    _close(pm.log_prior_density(), jm.log_prior_density(), MODEL_RTOL)

    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    data = (X, Y)
    jv, jg = jax.jit(jax.value_and_grad(functionalize(lambda: jm.training_loss(data), [jparams[p] for p in paths])))(
        tuple(jparams[p].unconstrained_variable for p in paths))
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    assert sorted(params) == paths
    pv = pm.training_loss((torch.from_numpy(X), torch.from_numpy(Y)))
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths])
    _close(pv, jv, MODEL_RTOL)
    for path, g, want in zip(paths, pg, jg):
        _close(g, want, MODEL_RTOL)

    # a frozen parameter's prior is left out, as in the JAX package
    set_trainable(pm.kernel, False)
    gpflow_tpu.set_trainable(jm.kernel, False)
    _close(pm.log_prior_density(), jm.log_prior_density(), MODEL_RTOL)


def test_model_without_priors_has_zero_log_prior_density():
    _, pm, _ = _svgp_pair()
    for p in pm.modules():
        if isinstance(p, Parameter):
            p.prior = None
    out = pm.log_prior_density()
    assert out.shape == () and out.dtype == torch.float64 and float(out) == 0.0


def test_robustmax_epsilon_prior_matches_jax():
    jr = gpflow_tpu.likelihoods.RobustMax(4, epsilon=0.02)
    pr = gpflow_tpu_torch.likelihoods.RobustMax(4, epsilon=0.02)
    assert pr.epsilon.prior == priors.Beta(0.2, 5.0) and not pr.epsilon.trainable
    _close(pr.epsilon.log_prior_density(), jr.epsilon.log_prior_density())
    # not trainable, so a model's log prior density leaves it out in both packages
    jl = gpflow_tpu.likelihoods.MultiClass(4, invlink=jr)
    pl = gpflow_tpu_torch.likelihoods.MultiClass(4, invlink=pr)
    Z = np.random.RandomState(3).rand(5, 2)
    jm = gpflow_tpu.models.SVGP(gpflow_tpu.kernels.SquaredExponential(), jl, Z.copy(), num_latent_gps=4)
    pm = gpflow_tpu_torch.models.SVGP(gpflow_tpu_torch.kernels.SquaredExponential(), pl, Z.copy(), num_latent_gps=4)
    _close(pm.log_prior_density(), jm.log_prior_density())
    assert ".likelihood.invlink.epsilon" in select_dict_parameters_with_prior(pm)
