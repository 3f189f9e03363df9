"""The rest of the likelihoods of gpflow_tpu_torch against gpflow_tpu on the
CPU, in float64: Exponential, StudentT, Gamma and Beta (their closed forms and
their quadrature fallbacks), ``SwitchedLikelihood`` (with its NaN row for an
index out of range), ``GaussianMC`` (with a shared ``epsilon``), the
heteroskedastic two-latent likelihoods, the six new log densities, the
``Exp`` and ``Sigmoid`` bijectors and ``positive(base="exp")``; and SVGPs with
the switched and heteroskedastic likelihoods, their values carried over by
``load_jax_values`` through the new parameter paths. Both sides evaluate the
same formulas: 1e-10 relative with 1e-10 of the largest entry as an absolute
floor, 1e-8 for gradients, which autodiff sums in another order."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu import bijectors as jax_bijectors
from gpflow_tpu import logdensities as jax_logdensities
from gpflow_tpu.models import SVGP as JaxSVGP
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import bijectors, config, kernels, likelihoods, logdensities
from gpflow_tpu_torch.models import SVGP, GPModel
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL, GRAD_RTOL = 1e-10, 1e-8
N, P = 11, 2
_rng = np.random.RandomState(3)
X = _rng.randn(N, 2)
FMU = _rng.randn(N, P)
FVAR = 0.05 + _rng.rand(N, P)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


# --- the log densities -------------------------------------------------------------


def _density_inputs(name, rng):
    x, mu, pos = rng.randn(5, 3), rng.randn(5, 3), 0.2 + 2 * rng.rand(5, 3)
    return {
        "lognormal": (np.exp(x), mu, pos),
        "exponential": (pos, 0.5 + rng.rand(5, 3)),
        "gamma": (pos, 0.5 + 3 * rng.rand(5, 3), 0.3 + rng.rand(5, 3)),
        "student_t": (x, mu, pos, 3.5),
        # exact 0 and 1 take the clip; alpha and beta straddle betaln's switch at 8
        "beta": (np.concatenate([[[0.0, 1.0, 0.5]], rng.rand(4, 3)]), 0.3 + 12 * rng.rand(5, 3),
                 0.3 + 12 * rng.rand(5, 3)),
        "laplace": (x, mu, pos),
    }[name]


@pytest.mark.parametrize("name", ["lognormal", "exponential", "gamma", "student_t", "beta", "laplace"])
def test_logdensity_matches_jax(name):
    args = _density_inputs(name, np.random.RandomState(len(name)))
    _close(getattr(logdensities, name)(*[a if np.isscalar(a) else _t(a) for a in args]),
           getattr(jax_logdensities, name)(*args))
    # and the gradient in every tensor argument
    tensors = [_t(a).requires_grad_() if not np.isscalar(a) else a for a in args]
    getattr(logdensities, name)(*tensors).sum().backward()
    argnums = tuple(i for i, a in enumerate(args) if not np.isscalar(a))
    want = jax.grad(lambda *a: jnp.sum(getattr(jax_logdensities, name)(*a)), argnums=argnums)(*args)
    for i, w in zip(argnums, want):
        _close(tensors[i].grad, w, GRAD_RTOL)


def test_betaln_keeps_its_accuracy_for_large_arguments():
    a, b = np.array([0.5, 3.0, 1e3, 2e6]), np.array([9.0, 40.0, 5e3, 3e6])
    _close(logdensities._betaln(_t(a), _t(b)), jax.scipy.special.betaln(a, b))


# --- the bijectors -------------------------------------------------------------------

BIJECTORS = {
    "Exp": (bijectors.Exp(), jax_bijectors.Exp()),
    "Sigmoid": (bijectors.Sigmoid(), jax_bijectors.Sigmoid()),
    "Sigmoid(-2, 3)": (bijectors.Sigmoid(-2.0, 3.0), jax_bijectors.Sigmoid(-2.0, 3.0)),
    "positive(base=exp)": (bijectors.positive(base="exp"), jax_bijectors.positive(base="exp")),
    "positive(1e-3, exp)": (bijectors.positive(1e-3, base="exp"), jax_bijectors.positive(1e-3, base="exp")),
}


@pytest.mark.parametrize("name", sorted(BIJECTORS))
def test_bijector_forward_and_inverse_match_jax(name):
    port, ref = BIJECTORS[name]
    x = np.linspace(-4.0, 4.0, 17)
    y = np.asarray(ref.forward(x))
    _close(port.forward(_t(x)), y)
    _close(port.inverse(_t(y)), ref.inverse(y))
    _close(port.inverse(port.forward(_t(x))), x, 1e-9)


def test_positive_keeps_softplus_without_base():
    assert bijectors.positive() == bijectors.Softplus()
    assert bijectors.positive(0.1) == bijectors.Chain((bijectors.Shift(0.1), bijectors.Softplus()))
    assert bijectors.positive(base="exp") == bijectors.Exp()
    with pytest.raises(ValueError):
        bijectors.positive(base="square")


# --- the scalar likelihoods ----------------------------------------------------------


def _scalar_pair(name):
    """(JAX likelihood, port likelihood, Y in its support)."""
    rng = np.random.RandomState(len(name) + 40)
    J, T = gpflow_tpu.likelihoods, likelihoods
    positive_y = 0.1 + 2 * rng.rand(N, P)
    return {
        "Exponential": (J.Exponential(), T.Exponential(), positive_y),
        "Exponential-softplus": (J.Exponential(invlink=jax.nn.softplus),
                                 T.Exponential(invlink=torch.nn.functional.softplus), positive_y),
        "StudentT": (J.StudentT(scale=0.7, df=4.0), T.StudentT(scale=0.7, df=4.0), rng.randn(N, P)),
        "Gamma": (J.Gamma(shape=1.7), T.Gamma(shape=1.7), positive_y),
        "Gamma-softplus": (J.Gamma(invlink=jax.nn.softplus, shape=1.7),
                           T.Gamma(invlink=torch.nn.functional.softplus, shape=1.7), positive_y),
        "Beta": (J.Beta(scale=2.5), T.Beta(scale=2.5), 0.02 + 0.96 * rng.rand(N, P)),
    }[name]


SCALARS = ["Exponential", "Exponential-softplus", "StudentT", "Gamma", "Gamma-softplus", "Beta"]
METHODS = ["variational_expectations", "predict_log_density", "predict_mean_and_var", "log_prob",
           "conditional_mean", "conditional_variance"]


def _apply(lik, method, Xv, Fmu, Fvar, Yv, **kw):
    if method in ("conditional_mean", "conditional_variance"):
        return getattr(lik, method)(Xv, Fmu)
    if method == "log_prob":
        return lik.log_prob(Xv, Fmu, Yv)
    if method in ("predict_mean_and_var", "_predict_mean_and_var"):
        return getattr(lik, method)(Xv, Fmu, Fvar, **kw)
    return getattr(lik, method)(Xv, Fmu, Fvar, Yv, **kw)


def _compare(got, want, rtol=RTOL):
    for g, w in zip(got, want) if isinstance(want, tuple) else [(got, want)]:
        _close(g, w, rtol)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("name", SCALARS)
def test_scalar_likelihood_matches_jax(name, method):
    jl, pl, Y = _scalar_pair(name)
    _compare(_apply(pl, method, _t(X), _t(FMU), _t(FVAR), _t(Y)), _apply(jl, method, X, FMU, FVAR, Y))


@pytest.mark.parametrize("name", SCALARS)
def test_scalar_variational_expectations_gradient_matches_jax(name):
    jl, pl, Y = _scalar_pair(name)
    want = jax.grad(lambda m, v: jnp.sum(jl.variational_expectations(X, m, v, Y)), argnums=(0, 1))(FMU, FVAR)
    m, v = _t(FMU).requires_grad_(), _t(FVAR).requires_grad_()
    pl.variational_expectations(_t(X), m, v, _t(Y)).sum().backward()
    _close(m.grad, want[0], GRAD_RTOL)
    _close(v.grad, want[1], GRAD_RTOL)


def test_scalar_hyperparameters_are_bounded_parameters():
    for lik, attr, bound in ((likelihoods.StudentT(), "scale", "scale_lower_bound"),
                             (likelihoods.Gamma(), "shape", "shape_lower_bound"),
                             (likelihoods.Beta(), "scale", "scale_lower_bound")):
        assert getattr(lik, bound) == config.default_likelihood_positive_minimum() == 1e-6
        p = getattr(lik, attr)
        assert p.trainable and float(p.value.detach()) == pytest.approx(1.0)
        with pytest.raises(ValueError):
            p.assign(0.0)  # at the bound: no finite unconstrained value
    assert likelihoods.StudentT(scale_lower_bound=0.1).scale.transform == bijectors.positive(0.1)


# --- SwitchedLikelihood -----------------------------------------------------------------

_srng = np.random.RandomState(9)
IDX = _srng.randint(0, 3, (N, 1)).astype(float)
SW_Y = np.where(IDX == 2, 0.2 + _srng.rand(N, 1), _srng.randn(N, 1))  # Exponential rows positive
SW_FMU, SW_FVAR = _srng.randn(N, 1), 0.05 + _srng.rand(N, 1)


def _switched():
    J, T = gpflow_tpu.likelihoods, likelihoods
    return (J.SwitchedLikelihood([J.Gaussian(0.3), J.StudentT(scale=0.7), J.Exponential()]),
            T.SwitchedLikelihood([T.Gaussian(0.3), T.StudentT(scale=0.7), T.Exponential()]))


@pytest.mark.parametrize("method", ["variational_expectations", "predict_log_density", "predict_mean_and_var",
                                    "log_prob"])
def test_switched_likelihood_matches_jax(method):
    jl, pl = _switched()
    Y = np.concatenate([SW_Y, IDX], axis=1)
    _compare(_apply(pl, method, _t(X), _t(SW_FMU), _t(SW_FVAR), _t(Y)),
             _apply(jl, method, X, SW_FMU, SW_FVAR, Y))


def test_switched_likelihood_index_out_of_range_is_nan():
    jl, pl = _switched()
    Y = np.concatenate([SW_Y, IDX], axis=1)
    Y[0, -1], Y[1, -1] = 3.0, -1.0
    for method in ("log_prob", "variational_expectations", "predict_log_density"):
        got = _np(_apply(pl, method, _t(X), _t(SW_FMU), _t(SW_FVAR), _t(Y)))
        want = np.asarray(_apply(jl, method, X, SW_FMU, SW_FVAR, Y))
        assert np.isnan(got[:2]).all() and np.isnan(want[:2]).all() and np.isfinite(got[2:]).all()
        _close(got[2:], want[2:])


def test_switched_likelihood_gradient_ignores_other_rows():
    # an observation outside a non-selected likelihood's support (negative y
    # under Exponential) reaches neither the value nor the gradient
    _, pl = _switched()
    Y = np.concatenate([SW_Y, IDX], axis=1)
    m, v = _t(SW_FMU).requires_grad_(), _t(SW_FVAR).requires_grad_()
    pl.variational_expectations(_t(X), m, v, _t(Y)).sum().backward()
    assert bool(torch.isfinite(m.grad).all() and torch.isfinite(v.grad).all())
    assert [n for n, _ in pl.named_modules()][:3] == ["", "likelihoods", "likelihoods.0"]
    assert GPModel.calc_num_latent_gps(None, pl, 2) == 1
    with pytest.raises(ValueError):
        GPModel.calc_num_latent_gps(None, pl, 1)


# --- GaussianMC and the heteroskedastic likelihoods --------------------------------------


@pytest.mark.parametrize("method", ["_variational_expectations", "_predict_log_density", "_predict_mean_and_var",
                                    "log_prob", "conditional_mean", "conditional_variance"])
def test_gaussian_mc_matches_jax_with_shared_epsilon(method):
    jl, pl = gpflow_tpu.likelihoods.GaussianMC(0.4), likelihoods.GaussianMC(0.4)
    assert isinstance(pl, likelihoods.MonteCarloLikelihood) and isinstance(pl, likelihoods.Gaussian)
    eps = np.random.RandomState(11).randn(100, N, P)
    Y = np.random.RandomState(12).randn(N, P)
    kw = {"epsilon": eps} if method.startswith("_") else {}
    _compare(_apply(pl, method, _t(X), _t(FMU), _t(FVAR), _t(Y), **{k: _t(v) for k, v in kw.items()}),
             _apply(jl, method, X, FMU, FVAR, Y, **kw))


def _heteroskedastic(dist):
    J, T = gpflow_tpu.likelihoods, likelihoods
    if dist == "Normal":
        return J.HeteroskedasticTFPConditional(), T.HeteroskedasticTFPConditional()
    return (J.HeteroskedasticTFPConditional(distribution_class=J.multilatent.StudentTDistribution),
            T.HeteroskedasticTFPConditional(distribution_class=T.multilatent.StudentTDistribution))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("dist", ["Normal", "StudentT"])
def test_heteroskedastic_matches_jax(dist, method):
    jl, pl = _heteroskedastic(dist)
    rng = np.random.RandomState(13)
    Fmu, Fvar, Y = rng.randn(N, 2), 0.05 + 0.5 * rng.rand(N, 2), rng.randn(N, 1)
    _compare(_apply(pl, method, _t(X), _t(Fmu), _t(Fvar), _t(Y)), _apply(jl, method, X, Fmu, Fvar, Y))
    assert pl.scale_transform == bijectors.positive(base="exp") and pl.quadrature.n_gh_total == 400


# --- SVGPs with the new likelihoods, values through the new paths ---------------------------


def _svgp_pair(name):
    """(JAX SVGP, port SVGP, Y) with M = 6 inducing points in D = 2."""
    rng = np.random.RandomState(20)
    J, T = gpflow_tpu.likelihoods, likelihoods
    if name == "Switched":
        jl = J.SwitchedLikelihood([J.Gaussian(0.3), J.StudentT(scale=0.7, df=5.0)])
        pl = T.SwitchedLikelihood([T.Gaussian(0.3), T.StudentT(scale=0.7, df=5.0)])
        Y, L = np.concatenate([rng.randn(N, 1), rng.randint(0, 2, (N, 1))], axis=1), 1
    else:  # the heteroskedastic likelihood: two latent GPs, one kernel
        jl, pl = J.HeteroskedasticTFPConditional(), T.HeteroskedasticTFPConditional()
        Y, L = rng.randn(N, 1), 2
    Z = rng.randn(6, 2)
    jm = JaxSVGP(gpflow_tpu.kernels.SquaredExponential(), jl, Z, num_latent_gps=L, num_data=40)
    values = read_values(jm)
    q_sqrt = np.tril(0.05 * rng.randn(L, 6, 6))
    q_sqrt[:, np.arange(6), np.arange(6)] = 0.5 + rng.rand(L, 6)
    values.update({".q_mu": rng.randn(6, L), ".q_sqrt": q_sqrt})
    gpflow_tpu.utilities.multiple_assign(jm, values)
    pm = SVGP(kernels.SquaredExponential(), pl, Z, num_latent_gps=L, num_data=40)
    load_jax_values(pm, read_values(jm))
    return jm, pm, Y


@pytest.mark.parametrize("name", ["Switched", "Heteroskedastic"])
def test_svgp_with_new_likelihood_matches_jax(name):
    jm, pm, Y = _svgp_pair(name)
    paths = sorted(parameter_dict(pm))
    if name == "Switched":
        assert ".likelihood.likelihoods[0].variance" in paths and ".likelihood.likelihoods[1].scale" in paths
    assert paths == sorted(read_values(jm))
    got = pm.elbo((_t(X), _t(Y)))
    grads = torch.autograd.grad(got, [p.unconstrained for p in pm.trainable_parameters])
    _close(got, jm.elbo((X, Y)), GRAD_RTOL)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    with torch.no_grad():
        _compare(pm.predict_y(_t(X)), jm.predict_y(X), GRAD_RTOL)
        _close(pm.predict_log_density((_t(X), _t(Y))), jm.predict_log_density((X, Y)), GRAD_RTOL)


def test_load_jax_values_reads_the_new_parameter_paths():
    J, T = gpflow_tpu.likelihoods, likelihoods
    pairs = [(J.MultiClass(3), T.MultiClass(3), ".invlink.epsilon", 0.07),
             (J.StudentT(), T.StudentT(), ".scale", 0.4), (J.Gamma(), T.Gamma(), ".shape", 2.2),
             (J.Beta(), T.Beta(), ".scale", 3.1),
             (J.SwitchedLikelihood([J.Gaussian(), J.StudentT()]), T.SwitchedLikelihood([T.Gaussian(), T.StudentT()]),
              ".likelihoods[1].scale", 0.9)]
    for jl, pl, path, value in pairs:
        values = read_values(jl)
        values[path] = np.asarray(value)
        gpflow_tpu.utilities.multiple_assign(jl, values)
        load_jax_values(pl, read_values(jl))
        assert float(parameter_dict(pl)[path].value.detach()) == pytest.approx(value, rel=1e-12)
