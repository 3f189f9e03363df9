"""The whole serving slice of gpflow_tpu_torch against gpflow_tpu: a JAX SVGP
and its port with the same values (moved over by ``load_jax_values``), the
same requests, on the CPU."""
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.conditionals.util import inv_solve as jax_inv_solve
from gpflow_tpu.models import SVGP as JaxSVGP
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch.conditionals import inv_solve
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.ops import launch_counts
from gpflow_tpu_torch.utilities import load_jax_values
from gpflow_tpu_torch.utilities import read_values as port_read_values
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

M, N, D, L = 32, 60, 3, 1  # N > M, so the INV_SOLVE route takes effect


def _values(dtype, seed=0):
    """Model values and a request, in the layout of ``read_values``."""
    rng = np.random.RandomState(seed)
    X = (rng.rand(N, D) * 4).astype(dtype)
    q_sqrt = np.tril(0.1 * rng.randn(L, M, M))
    q_sqrt[:, np.arange(M), np.arange(M)] = 0.2 + 0.5 * rng.rand(L, M)
    values = {
        ".inducing_variable.Z": (rng.rand(M, D) * 4).astype(dtype),
        ".kernel.lengthscales": (0.8 + 0.6 * rng.rand(D)).astype(dtype),
        ".kernel.variance": np.asarray(1.4, dtype),
        ".likelihood.variance": np.asarray(0.1, dtype),
        ".q_mu": rng.randn(M, L).astype(dtype),
        ".q_sqrt": q_sqrt.astype(dtype),
    }
    return values, X


def _jax_model(values, whiten):
    dtype = values[".q_mu"].dtype
    model = JaxSVGP(
        kernel=gpflow_tpu.kernels.SquaredExponential(lengthscales=np.ones(D, dtype)),
        likelihood=gpflow_tpu.likelihoods.Gaussian(0.5),
        inducing_variable=np.zeros((M, D), dtype),
        whiten=whiten,
    )
    gpflow_tpu.utilities.multiple_assign(model, values)
    return model


def _port_of(jax_model, dtype, whiten):
    model = SVGP(
        kernel=kernels.SquaredExponential(lengthscales=np.ones(D, dtype)),
        likelihood=likelihoods.Gaussian(0.5),
        inducing_variable=np.zeros((M, D), dtype),
        whiten=whiten,
    )
    load_jax_values(model, read_values(jax_model))
    return model


def _requests(model, X, route):
    """The slice's entry points: (mean, var) pairs from one request."""
    with torch.no_grad():
        if route == "cached":
            post = model.posterior()
            return [post.predict_f(X), (post.predict_mean(X),), post.predict_f(X, full_cov=True)]
        with inv_solve(route == "inv_solve"):
            return [model.predict_f(X), model.predict_f(X, full_cov=True), model.predict_y(X)]


def _jax_requests(model, X, route):
    if route == "cached":
        post = model.posterior()
        return [post.predict_f(X), (post.predict_mean(X),), post.predict_f(X, full_cov=True)]
    with jax_inv_solve(route == "inv_solve"):
        return [model.predict_f(X), model.predict_f(X, full_cov=True), model.predict_y(X)]


def _assert_close(got, want, rtol, atol_scale):
    for g_pair, w_pair in zip(got, want):
        for g, w in zip(g_pair, w_pair):
            w = np.asarray(w)
            g = g.numpy()
            assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
            assert np.all(np.isfinite(g))
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_scale * np.max(np.abs(w)))


@pytest.mark.parametrize("route", ["cached", "solve", "inv_solve"])
@pytest.mark.parametrize("whiten", [True, False])
def test_slice_matches_jax_f64(route, whiten):
    # 1e-8 relative, with the same bound times the largest entry as an
    # absolute floor for entries that cancel towards zero
    values, X = _values(np.float64)
    jax_model = _jax_model(values, whiten)
    model = _port_of(jax_model, np.float64, whiten)
    _assert_close(_requests(model, torch.from_numpy(X), route), _jax_requests(jax_model, X, route),
                  rtol=1e-8, atol_scale=1e-8)


@pytest.mark.parametrize("route", ["cached", "solve", "inv_solve"])
def test_slice_matches_jax_f32(route):
    # Both sides round in float32 but sum in different orders, and the cached
    # route holds an explicit inverse of Kuu (error ~ cond(Kuu)^2 * eps32);
    # with the f32 jitter 1e-4 these well-separated inducing points give
    # cond(Kuu) of a few hundred, so 2e-3 of the largest entry bounds both.
    values, X = _values(np.float32, seed=1)
    with gpflow_tpu.config.as_context(gpflow_tpu.config.Config(float=np.float32)), \
            config.as_context(config.Config(float=torch.float32, device="cpu")):
        jax_model = _jax_model(values, whiten=True)
        model = _port_of(jax_model, np.float32, whiten=True)
        want = _jax_requests(jax_model, X, route)
        got = _requests(model, torch.from_numpy(X), route)
    _assert_close(got, want, rtol=0.0, atol_scale=2e-3)


def test_slice_runs_on_cpu_without_kernel_launches():
    values, X = _values(np.float64)
    model = _port_of(_jax_model(values, True), np.float64, True)
    before = launch_counts["K1"]
    _requests(model, torch.from_numpy(X), "cached")
    _requests(model, torch.from_numpy(X), "inv_solve")
    assert launch_counts["K1"] == before == 0


def test_predict_y_rejects_full_cov():
    values, X = _values(np.float64)
    model = _port_of(_jax_model(values, True), np.float64, True)
    with pytest.raises(NotImplementedError, match="full_cov"):
        model.predict_y(torch.from_numpy(X), full_cov=True)


def test_load_jax_values_paths_match_read_values():
    values, _ = _values(np.float64)
    model = _port_of(_jax_model(values, True), np.float64, True)
    got = port_read_values(model)
    assert sorted(got) == sorted(values)
    for k in values:
        np.testing.assert_allclose(got[k], values[k], rtol=1e-14, atol=1e-15)


@pytest.mark.parametrize("change", ["unknown", "missing", "shape", "domain"])
def test_load_jax_values_rejects_before_changing_anything(change):
    values, _ = _values(np.float64)
    model = _port_of(_jax_model(values, True), np.float64, True)
    before = port_read_values(model)
    bad = {k: v + 1.0 for k, v in values.items()}
    if change == "unknown":
        bad[".kernel.period"] = np.asarray(1.0)
    elif change == "missing":
        del bad[".q_mu"]
    elif change == "shape":
        bad[".kernel.lengthscales"] = np.ones(D + 1)
    else:
        bad[".likelihood.variance"] = np.asarray(-1.0)
    with pytest.raises((KeyError, ValueError)):
        load_jax_values(model, bad)
    after = port_read_values(model)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k])
