"""Exact GPR of gpflow_tpu_torch against gpflow_tpu on the CPU: the log
marginal likelihood and its gradient on the solve and INV_SOLVE routes,
cached and fused prediction, ``load_jax_values``, and the default device.
Inputs lie on the grid of multiples of 1/8, with power-of-two lengthscales,
so that both packages' distances are exact; Matern 1/2 then differentiates
K(X) at coincident points without the rounding noise of the norm expansion.
Unless a test states otherwise, float64 agrees to 1e-8 relative to the
largest entry."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.base import functionalize
from gpflow_tpu.conditionals.util import inv_solve as jax_inv_solve
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import Parameter, config, kernels
from gpflow_tpu_torch.conditionals import inv_solve
from gpflow_tpu_torch.models import GPR, GPR_deprecated
from gpflow_tpu_torch.ops import launch_counts
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict
from gpflow_tpu_torch.utilities import read_values as port_read_values

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

N, D, NEW = 96, 3, 40
KERNELS = ("SquaredExponential", "Matern12")
ROUTES = (("solve", False), ("inv_solve", True))


def _data(seed=0, P=1):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 9, size=(N, D)) / 8.0
    Y = np.sin(3.0 * X[:, :1]) + 0.1 * rng.randn(N, P)
    Xnew = rng.randint(0, 17, size=(NEW, D)) / 16.0
    return X, Y, Xnew


LS = np.array([0.5, 1.0, 2.0])


def _models(kernel, X, Y, cls="GPR"):
    jm = getattr(gpflow_tpu.models, cls)(
        (X, Y), getattr(gpflow_tpu.kernels, kernel)(variance=1.3, lengthscales=LS), noise_variance=0.1
    )
    pm = globals()[cls]((X, Y), getattr(kernels, kernel)(variance=1.3, lengthscales=LS), noise_variance=0.1)
    return jm, pm


def _close(got, want, rtol=1e-8):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _jax_loss_and_grads(jm, flag):
    paths = sorted(jax_parameter_dict(jm))
    params = [jax_parameter_dict(jm)[p] for p in paths]
    with jax_inv_solve(flag):
        loss, grads = jax.value_and_grad(functionalize(jm.training_loss, params))(
            tuple(p.unconstrained_variable for p in params)
        )
    return loss, dict(zip(paths, grads))


def _port_loss_and_grads(pm, flag):
    with inv_solve(flag):
        loss = pm.training_loss()
        loss.backward()
    return loss.detach(), {path: p.unconstrained.grad for path, p in parameter_dict(pm).items()}


@pytest.mark.parametrize("P", [1, 2])
@pytest.mark.parametrize("route,flag", ROUTES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_training_loss_and_gradient_match_jax_f64(kernel, route, flag, P):
    X, Y, _ = _data(P=P)
    jm, pm = _models(kernel, X, Y)
    want_loss, want = _jax_loss_and_grads(jm, flag)
    got_loss, got = _port_loss_and_grads(pm, flag)
    assert got.keys() == want.keys() == {".kernel.lengthscales", ".kernel.variance", ".likelihood.variance"}
    _close(got_loss, want_loss)
    for path in want:
        _close(got[path], want[path])
    _close(pm.log_marginal_likelihood(), -np.asarray(want_loss))


@pytest.mark.parametrize("route,flag", ROUTES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_training_loss_and_gradient_f32_against_f64(kernel, route, flag):
    # float32 against the float64 JAX model. cond(K + 0.1 I) is about 3e2 for
    # these inputs (asserted below), so the solves and the explicit inverse
    # of INV_SOLVE carry about cond * eps32 = 2e-5 relative error: 2e-4 of
    # the largest gradient entry, and 2e-5 of the loss.
    X, Y, _ = _data()
    jm, _ = _models(kernel, X, Y)
    K = np.asarray(jm.kernel(X)) + 0.1 * np.eye(N)
    assert np.linalg.cond(K) < 1e3
    want_loss, want = _jax_loss_and_grads(jm, flag)
    with config.as_context(dataclasses.replace(config.config(), float=torch.float32)):
        pm = GPR((X, Y), getattr(kernels, kernel)(variance=1.3, lengthscales=LS), noise_variance=0.1)
    assert pm.data[0].dtype == pm.kernel.variance.dtype == torch.float32
    got_loss, got = _port_loss_and_grads(pm, flag)
    _close(got_loss.double(), want_loss, rtol=2e-5)
    scale = max(float(np.max(np.abs(np.asarray(g)))) for g in want.values())
    for path in want:
        np.testing.assert_allclose(got[path].double().numpy(), np.asarray(want[path]), rtol=0.0, atol=2e-4 * scale)


def _requests(model, Xnew, Ynew, route_flag):
    """Every prediction entry point, in one list."""
    post = model.posterior()
    out = [post.predict_f(Xnew), post.predict_f(Xnew, full_cov=True), (post.predict_mean(Xnew),)]
    out.append((model.posterior(precompute_cache=None).predict_mean(Xnew),))
    with (inv_solve if isinstance(model, GPR) else jax_inv_solve)(route_flag):
        out += [model.predict_f(Xnew), model.predict_f(Xnew, full_cov=True), model.predict_y(Xnew),
                (model.predict_log_density((Xnew, Ynew)),)]
    return out


@pytest.mark.parametrize("route,flag", ROUTES)
@pytest.mark.parametrize("kernel", KERNELS)
def test_predictions_match_jax_f64(kernel, route, flag):
    X, Y, Xnew = _data(seed=1)
    Ynew = np.sin(3.0 * Xnew[:, :1])
    jm, pm = _models(kernel, X, Y)
    want = _requests(jm, Xnew, Ynew, flag)
    with torch.no_grad():
        got = _requests(pm, torch.from_numpy(Xnew), torch.from_numpy(Ynew), flag)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            _close(gt, wt, rtol=1e-10)


@pytest.mark.parametrize("route,flag", ROUTES)
def test_gpr_deprecated_fused_predict_f_matches_jax(route, flag):
    X, Y, Xnew = _data(seed=2)
    jm, pm = _models("SquaredExponential", X, Y, cls="GPR_deprecated")
    with jax_inv_solve(flag):
        want = jm.predict_f(Xnew)
    with inv_solve(flag), torch.no_grad():
        got = pm.predict_f(torch.from_numpy(Xnew))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10)


def test_posterior_cache_holds_err_lm_alpha():
    X, Y, _ = _data(seed=3)
    _, pm = _models("SquaredExponential", X, Y)
    with torch.no_grad():
        err, Lm, alpha = pm.posterior().cache
        K = pm.kernel(pm.data[0]) + 0.1 * torch.eye(N, dtype=torch.float64)
    _close(err, Y)
    _close(Lm @ Lm.mT, K, rtol=1e-12)
    _close(K @ alpha, Y, rtol=1e-10)
    assert pm.posterior(precompute_cache="nocache").cache is None


def test_load_jax_values_round_trips_a_gpr():
    X, Y, _ = _data(seed=4)
    jm, pm = _models("Matern12", X, Y)
    values = {".kernel.lengthscales": np.array([0.7, 1.9, 0.4]), ".kernel.variance": np.array(2.2),
              ".likelihood.variance": np.array(0.03)}
    gpflow_tpu.utilities.multiple_assign(jm, values)
    load_jax_values(pm, read_values(jm))
    got, want = port_read_values(pm), read_values(jm)
    assert got.keys() == want.keys() == values.keys()
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-15)
    _close(pm.training_loss().detach(), jm.training_loss(), rtol=1e-12)


def test_training_loss_closure_and_trainable_variables():
    X, Y, _ = _data(seed=5)
    _, pm = _models("SquaredExponential", X, Y)
    assert pm.training_loss_closure(compile=False) == pm.training_loss
    closure = pm.training_loss_closure()  # traced once, then replayed
    assert closure().item() == closure().item() == pm.training_loss().item()
    assert closure.traced.trace_count == 1
    assert [p.name for p in pm.trainable_variables] == ["variance", "lengthscales", "variance"]
    assert pm.trainable_variables == pm.trainable_parameters


def test_noise_variance_and_likelihood_are_exclusive():
    from gpflow_tpu_torch.likelihoods import Gaussian

    X, Y, _ = _data()
    with pytest.raises(ValueError, match="Cannot set both"):
        GPR((X, Y), kernels.SquaredExponential(), noise_variance=0.1, likelihood=Gaussian(0.1))
    assert float(GPR((X, Y), kernels.SquaredExponential()).likelihood.variance.value) == pytest.approx(1.0)


def test_gpr_on_the_cpu_launches_no_kernel():
    X, Y, Xnew = _data(seed=6)
    before = dict(launch_counts)
    for kernel in KERNELS:
        _, pm = _models(kernel, X, Y)
        for _, flag in ROUTES:
            _port_loss_and_grads(pm, flag)
            with torch.no_grad():
                pm.posterior().predict_f(torch.from_numpy(Xnew))
    assert launch_counts == before == {"K1": 0, "K2": 0}


# --- the default device ------------------------------------------------------------


def test_default_device_is_the_card():
    assert config.Config().device == torch.device("cuda")
    assert config.Config(device="cpu").device == torch.device("cpu")
    with config.as_context(dataclasses.replace(config.config(), device="cuda")):
        assert config.default_device() == torch.device("cuda")
    assert config.default_device() == torch.device("cpu")


def test_model_without_a_device_request_lands_on_the_default_device():
    X, Y, _ = _data()
    for device in ("cpu", torch.device("cpu")):
        config.set_default_device(device)
        pm = GPR((X, Y), kernels.Matern12(lengthscales=LS), noise_variance=0.1)
        tensors = list(pm.parameters()) + list(pm.data)
        assert {t.device for t in tensors} == {config.default_device()} == {torch.device("cpu")}
        assert pm.data[0].dtype == torch.float64 and pm.log_prior_density().device == torch.device("cpu")


def test_building_on_the_card_needs_one():
    # the card is the default: without one, building raises torch's own
    # error; nothing falls back to the CPU
    X, Y, _ = _data()
    with config.as_context(dataclasses.replace(config.config(), device="cuda")):
        if torch.cuda.is_available():
            pm = GPR((X, Y), kernels.SquaredExponential(), noise_variance=0.1)
            assert pm.data[0].is_cuda and pm.kernel.variance.device.type == "cuda"
        else:
            with pytest.raises((RuntimeError, AssertionError)):
                Parameter(1.0)
            with pytest.raises((RuntimeError, AssertionError)):
                GPR((X, Y), kernels.SquaredExponential(), noise_variance=0.1)
