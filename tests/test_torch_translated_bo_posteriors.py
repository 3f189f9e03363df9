"""The JAX package's ``tests/integration/test_bo_posteriors.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; ``jax.jit`` over a posterior traces it once and replays it (``jit``).

BO-loop posterior integration (strategy from reference
``tests/gpflow/posteriors/test_bo_integration.py``): for every model family
a BO library would drive, grow the dataset incrementally and check that the
JIT-compiled cached posterior agrees with a freshly built eager model — in a
pure predict flow and in an optimize-then-predict flow.

JAX-native adaptation of the reference's ``tf.Variable(shape=[None, D])``
dynamic-data idiom (SURVEY.md A.5.1): each data growth rebuilds the model
(arrays are immutable; a rebuild is the eager reference semantics), VGP warm
restarts go through ``update_vgp_data``, and across-iteration compile reuse
is exercised by jitting ``predict_f`` over the POSTERIOR AS A PYTREE — the
cache rides in as traced leaves, so one compiled function serves every
refreshed cache of the same shape.
"""
from typing import Any, Callable, Dict, List, Set, Tuple

import numpy as np
import pytest

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch.inducing_variables import (
    FallbackSeparateIndependentInducingVariables,
    InducingPoints,
    SharedIndependentInducingVariables,
)
from gpflow_tpu_torch.kernels import LinearCoregionalization, Matern52, SharedIndependent
from gpflow_tpu_torch.likelihoods import Exponential
from gpflow_tpu_torch.models import GPR, SGPR, SVGP, VGP, update_vgp_data
from gpflow_tpu_torch.models.util import training_loss_closure
from gpflow_tpu_torch.posteriors import AbstractPosterior, PrecomputeCacheType
from .test_torch_translated_support import jit, translated_test_environment  # noqa: F401

_MAXITER = 10
_DEFAULT_ATOL = 1e-10
_DEFAULT_RTOL = 1e-7

_TESTED_POSTERIORS: Set[type] = set()

_MODEL_FACTORIES: List[Tuple[str, Callable[..., Any], bool, float, float]] = []


def model_factory(multi_output: bool = False, atol: float = _DEFAULT_ATOL,
                  rtol: float = _DEFAULT_RTOL):
    def register(fn):
        _MODEL_FACTORIES.append((fn.__name__, fn, multi_output, atol, rtol))
        return fn

    return register


def create_kernel():
    return Matern52()


def create_inducing_points(data):
    rng = np.random.RandomState(20220208)
    return InducingPoints(rng.rand(5, data[0].shape[1]))


def create_q(n_inducing, *, row_scale=1, column_scale=1):
    rng = np.random.RandomState(20220133)
    q_mu = rng.rand(row_scale * n_inducing, column_scale)
    q_sqrt = rng.rand(row_scale * n_inducing, column_scale) ** 2
    return True, q_mu, q_sqrt


@model_factory(rtol=1e-3)
def create_gpr(data):
    return GPR(data=data, kernel=create_kernel())


@model_factory(rtol=1e-4)
def create_sgpr(data):
    return SGPR(data=data, kernel=create_kernel(),
                inducing_variable=create_inducing_points(data))


@model_factory(rtol=5e-3)
def create_vgp(data):
    return VGP(data=data, kernel=create_kernel(), likelihood=Exponential())


@model_factory()
def create_svgp__independent_single_output(data):
    iv = create_inducing_points(data)
    q_diag, q_mu, q_sqrt = create_q(iv.num_inducing)
    return SVGP(kernel=create_kernel(), likelihood=Exponential(),
                inducing_variable=iv, q_diag=q_diag, q_mu=q_mu, q_sqrt=q_sqrt)


@model_factory(multi_output=True)
def create_svgp__fully_correlated_multi_output(data):
    P = data[1].shape[1]
    kernel = SharedIndependent(create_kernel(), output_dim=P)
    iv = create_inducing_points(data)
    q_diag, q_mu, q_sqrt = create_q(iv.num_inducing, row_scale=P)
    return SVGP(kernel=kernel, likelihood=Exponential(), inducing_variable=iv,
                q_diag=q_diag, q_mu=q_mu, q_sqrt=q_sqrt)


@model_factory(multi_output=True)
def create_svgp__independent_multi_output(data):
    P = data[1].shape[1]
    kernel = SharedIndependent(create_kernel(), output_dim=P)
    iv = SharedIndependentInducingVariables(create_inducing_points(data))
    q_diag, q_mu, q_sqrt = create_q(5, column_scale=P)
    return SVGP(kernel=kernel, likelihood=Exponential(), inducing_variable=iv,
                q_diag=q_diag, q_mu=q_mu, q_sqrt=q_sqrt)


@model_factory(multi_output=True)
def create_svgp__fallback_independent_latent_posterior(data):
    P = data[1].shape[1]
    rng = np.random.RandomState(20220131)
    kernel = LinearCoregionalization([create_kernel()], W=rng.randn(P, 1))
    iv = FallbackSeparateIndependentInducingVariables([create_inducing_points(data)])
    q_diag, q_mu, q_sqrt = create_q(5)
    return SVGP(kernel=kernel, likelihood=Exponential(), inducing_variable=iv,
                q_diag=q_diag, q_mu=q_mu, q_sqrt=q_sqrt)


@model_factory(multi_output=True)
def create_svgp__linear_coregionalization(data):
    P = data[1].shape[1]
    rng = np.random.RandomState(20220131)
    kernel = LinearCoregionalization([create_kernel()], W=rng.randn(P, 1))
    iv = SharedIndependentInducingVariables(create_inducing_points(data))
    q_diag, q_mu, q_sqrt = create_q(5)
    return SVGP(kernel=kernel, likelihood=Exponential(), inducing_variable=iv,
                q_diag=q_diag, q_mu=q_mu, q_sqrt=q_sqrt)


_F_MINIMUM_SINGLE = np.array([[0.3, 0.5]])
_F_MINIMUM_MULTI = np.array([[0.2, 0.4], [0.4, 0.6], [0.6, 0.8]])


def _f(X: np.ndarray, f_minimum: np.ndarray) -> np.ndarray:
    err = X[:, None, :] - f_minimum[None, :, :]
    return np.sum(err**2, axis=-1)


def _initial_data(multi_output: bool):
    f_minimum = _F_MINIMUM_MULTI if multi_output else _F_MINIMUM_SINGLE
    rng = np.random.RandomState(20220126)
    X = rng.rand(3, f_minimum.shape[1])
    return (X, _f(X, f_minimum)), f_minimum


def _grow(data, f_minimum, rng):
    X, Y = data
    X_new = rng.rand(1, X.shape[1])
    return np.concatenate([X, X_new]), np.concatenate([Y, _f(X_new, f_minimum)])


def _fit_model(factory, data, model=None):
    """Eager-reference semantics for incremental data: VGP warm-restarts via
    update_vgp_data; internal-data models rebuild; SVGP is data-free."""
    if model is not None and isinstance(model, VGP):
        update_vgp_data(model, data)
        return model
    return factory(data)


def _optimize(model, data):
    gpf.optimizers.Scipy().minimize(
        training_loss_closure(model, data, compile=True),
        model.trainable_variables,
        options={"maxiter": _MAXITER},
        method="BFGS",
    )


@pytest.mark.parametrize(
    "name, factory, multi_output, atol, rtol",
    _MODEL_FACTORIES,
    ids=[f[0] for f in _MODEL_FACTORIES],
)
def test_posterior_bo_integration__predict_f(name, factory, multi_output, atol, rtol):
    """Incrementally added data is reflected in the cached posterior, and the
    SAME jitted predict function serves every refreshed cache."""
    (X, Y), f_minimum = _initial_data(multi_output)
    rng = np.random.RandomState(20220127)
    X_new = np.random.RandomState(20220128).rand(3, X.shape[1])
    n_outputs = Y.shape[1]

    @jit
    def predict_f(posterior, Xq):
        return posterior.predict_f(Xq)

    model = factory((X, Y))
    for _ in range(3):
        X, Y = _grow((X, Y), f_minimum, rng)
        model = _fit_model(factory, (X, Y), model)
        posterior = model.posterior(PrecomputeCacheType.VARIABLE)
        _TESTED_POSTERIORS.add(type(posterior))
        posterior.update_cache()
        mean, var = predict_f(posterior, X_new)
        assert np.asarray(mean).shape == (3, n_outputs)
        assert np.asarray(var).shape == (3, n_outputs)

        eager_model = factory((X, Y))
        if isinstance(model, VGP):
            eager_model = model  # update_vgp_data IS the model state; compare fused
        eager_mean, eager_var = eager_model.predict_f(X_new)
        np.testing.assert_allclose(np.asarray(eager_mean), np.asarray(mean),
                                   rtol=rtol, atol=atol)
        np.testing.assert_allclose(np.asarray(eager_var), np.asarray(var),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize(
    "name, factory, multi_output, atol, rtol",
    [f for f in _MODEL_FACTORIES if f[0] in ("create_gpr", "create_sgpr",
                                             "create_svgp__independent_single_output")],
    ids=lambda f: f if isinstance(f, str) else "",
)
def test_posterior_bo_integration__optimization(name, factory, multi_output, atol, rtol):
    """Data added incrementally is considered when optimizing; the compiled
    cached posterior after optimization equals an eager twin optimized the
    same way (reference ``test_bo_integration.py:401-445``)."""
    (X, Y), f_minimum = _initial_data(multi_output)
    rng = np.random.RandomState(20220127)
    X_new = np.random.RandomState(20220128).rand(3, X.shape[1])
    n_outputs = Y.shape[1]

    for _ in range(3):
        X, Y = _grow((X, Y), f_minimum, rng)

    model = factory((X, Y))
    _optimize(model, (X, Y))
    posterior = model.posterior(PrecomputeCacheType.VARIABLE)
    _TESTED_POSTERIORS.add(type(posterior))
    posterior.update_cache()
    mean, var = jit(lambda p, Xq: p.predict_f(Xq))(posterior, X_new)
    assert np.asarray(mean).shape == (3, n_outputs)
    assert np.asarray(var).shape == (3, n_outputs)

    eager_model = factory((X, Y))
    _optimize(eager_model, (X, Y))
    eager_mean, eager_var = eager_model.predict_f(X_new)
    np.testing.assert_allclose(np.asarray(eager_mean), np.asarray(mean),
                               rtol=max(rtol, 1e-5), atol=max(atol, 1e-8))
    np.testing.assert_allclose(np.asarray(eager_var), np.asarray(var),
                               rtol=max(rtol, 1e-5), atol=max(atol, 1e-8))


def test_zzz_bo_posterior_class_coverage():
    """The BO flow must have exercised every posterior family a BO library
    would see (reference's tested_posteriors registry fixture)."""
    names = {c.__name__ for c in _TESTED_POSTERIORS}
    assert {
        "GPRPosterior",
        "SGPRPosterior",
        "VGPPosterior",
        "IndependentPosteriorSingleOutput",
        "IndependentPosteriorMultiOutput",
        "FullyCorrelatedPosterior",
        "FallbackIndependentLatentPosterior",
        "LinearCoregionalizationPosterior",
    } <= names, names
