"""The functions and mean functions of gpflow_tpu_torch (``functions`` and
its alias ``mean_functions``), ``utilities.parameter_or_function`` and the
Gaussian likelihood's ``scale`` and Function variance, against gpflow_tpu on
the CPU in float64 on the same numpy inputs. Outputs and gradients with
respect to every parameter agree to 1e-10 relative to the largest entry;
the Gaussian's input-dependent noise is held through an SGPR objective and
its gradient."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, functions, kernels, likelihoods, mean_functions, models
from gpflow_tpu_torch.utilities import (
    evaluate_parameter_or_function,
    load_jax_values,
    parameter_dict,
    prepare_parameter_or_function,
)

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _value_and_grads(jm, pm, jfn, pfn):
    """(JAX value, JAX grads, port value, port grads) of ``fn`` with respect
    to every trainable parameter, keyed by path."""
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    jv, jg = jax.value_and_grad(functionalize(jfn, [jparams[p] for p in paths]))(
        tuple(jparams[p].unconstrained_variable for p in paths)
    )
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    assert sorted(params) == paths
    pv = pfn()
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths]) if paths else ()
    return jv, dict(zip(paths, jg)), pv.detach(), dict(zip(paths, pg))


def _build(pkg, name):
    f = pkg
    rng = np.random.RandomState(7)
    A, b = rng.randn(3, 2), rng.randn(2)
    if name == "Linear":
        return f.Linear(A=A, b=b)
    if name == "Linear default":
        return f.Linear()
    if name == "Identity":
        return f.Identity(input_dim=3)
    if name == "Constant":
        return f.Constant(c=np.array([0.3, -1.2]))
    if name == "Constant default":
        return f.Constant()
    if name == "Zero":
        return f.Zero(output_dim=2)
    if name == "Polynomial":
        return f.Polynomial(degree=3, input_dim=3, output_dim=2, w=rng.randn(2, 20))
    if name == "Additive":
        return f.Linear(A=A, b=b) + f.Constant(c=np.array([0.5, 0.1]))
    if name == "Product":
        return f.Linear(A=A, b=b) * f.Polynomial(degree=2, input_dim=3, output_dim=2, w=rng.randn(2, 10))
    raise KeyError(name)


NAMES = ["Linear", "Linear default", "Identity", "Constant", "Constant default", "Zero", "Polynomial", "Additive",
         "Product"]


@pytest.mark.parametrize("batch", [(), (2,)])
@pytest.mark.parametrize("name", NAMES)
def test_function_values_and_gradients_match_jax_f64(name, batch):
    rng = np.random.RandomState(8)
    X = rng.randn(*batch, 9, 3)
    if name in ("Linear default", "Constant default"):
        X = X[..., :1]
    jm, pm = _build(gpflow_tpu.functions, name), _build(functions, name)
    W = rng.randn(*np.shape(jm(X)))
    jv, jg, pv, pg = _value_and_grads(jm, pm, lambda: (jm(X) * W).sum(),
                                      lambda: (pm(torch.from_numpy(X)) * torch.from_numpy(W)).sum())
    with torch.no_grad():
        _close(pm(torch.from_numpy(X)), jm(X))
    _close(pv, jv)
    for path in jg:
        _close(pg[path], jg[path])


def test_polynomial_at_zero_has_finite_gradient():
    X = torch.zeros(4, 2, dtype=torch.float64, requires_grad=True)
    out = functions.Polynomial(degree=3, input_dim=2)(X)
    (g,) = torch.autograd.grad(out.sum(), X)
    assert bool(torch.isfinite(g).all())
    _close(out, np.ones((4, 1)))
    assert functions.Polynomial.compute_powers(2, 2) == gpflow_tpu.functions.Polynomial.compute_powers(2, 2)


def test_switched_mean_function_matches_jax_and_loads_its_weights():
    rng = np.random.RandomState(9)
    X = np.concatenate([rng.randn(11, 2), rng.randint(0, 3, (11, 1)).astype(float)], axis=1)
    X[-1, -1] = 5.0  # a label outside the branches selects none: 0, as in the JAX package
    parts = lambda f: [f.Constant(c=np.array([1.5])), f.Linear(A=rng.randn(2, 1), b=rng.randn(1)),  # noqa: E731
                       f.Zero()]
    jm = gpflow_tpu.functions.SwitchedMeanFunction(parts(gpflow_tpu.functions))
    pm = functions.SwitchedMeanFunction(parts(functions))
    assert isinstance(pm.meanfunctions, torch.nn.ModuleList) and len(pm.meanfunctions) == 3
    values = read_values(jm)
    assert set(values) == set(parameter_dict(pm)) == {".functions[0].c", ".functions[1].A", ".functions[1].b"}
    load_jax_values(pm, values)
    with torch.no_grad():
        _close(pm(torch.from_numpy(X)), jm(X))


def test_mean_functions_is_an_alias_and_zero_has_no_parameter():
    for name in functions.__all__:
        assert getattr(mean_functions, name) is getattr(functions, name)
    z = functions.Zero()
    assert isinstance(z, functions.Constant) and isinstance(z, functions.MeanFunction)
    assert list(z.parameters()) == [] and parameter_dict(z) == {}
    # every model of the earlier slices keeps its paths: no .mean_function.c
    m = models.GPR((np.zeros((3, 1)), np.zeros((3, 1))), kernel=kernels.SquaredExponential())
    assert sorted(parameter_dict(m)) == [".kernel.lengthscales", ".kernel.variance", ".likelihood.variance"]
    with pytest.raises(ValueError, match="input_dim"):
        functions.Identity().A
    _close(functions.Identity(input_dim=2).A, np.eye(2))
    with pytest.raises(ValueError, match="2-dimensional"):
        functions.Linear(A=gpflow_tpu_torch.Parameter(np.ones(2)))


def test_default_parameters_take_the_default_float():
    with config.as_context(config.Config(float=torch.float32, device="cpu")):
        assert functions.Constant().c.dtype == torch.float32
        lin = functions.Linear()
        assert lin.A.dtype == lin.b.dtype == torch.float32
        assert functions.Polynomial(2, 2).w.dtype == torch.float32
    assert functions.Linear(A=np.ones((2, 1), np.float32)).A.dtype == torch.float32


def test_evaluate_parameter_or_function_clamps_a_function():
    X = np.linspace(-2.0, 2.0, 7)[:, None]
    for lower in (None, 0.5):
        jv = gpflow_tpu.utilities.evaluate_parameter_or_function(
            gpflow_tpu.functions.Linear(A=[[1.0]], b=[0.1]), X, lower_bound=lower)
        pv = evaluate_parameter_or_function(functions.Linear(A=[[1.0]], b=[0.1]), torch.from_numpy(X),
                                            lower_bound=lower)
        _close(pv, jv)
    f = functions.Constant()
    assert prepare_parameter_or_function(f) is f
    p = prepare_parameter_or_function(0.3, lower_bound=1e-6)
    assert abs(float(evaluate_parameter_or_function(p, torch.zeros(2, 1)).detach()) - 0.3) < 1e-15


def _noise(pkg, kind):
    """A Gaussian likelihood of ``kind``, from the package ``pkg`` (either
    gpflow_tpu or gpflow_tpu_torch)."""
    rng = np.random.RandomState(10)
    A, b = 0.3 * rng.randn(2, 1), np.array([0.2])
    if kind == "variance":
        return pkg.likelihoods.Gaussian(0.15)
    if kind == "scale":
        return pkg.likelihoods.Gaussian(scale=0.4)
    if kind == "Function variance":  # clamped at the lower bound where A x + b falls below it
        return pkg.likelihoods.Gaussian(pkg.functions.Linear(A=A, b=b), variance_lower_bound=0.05)
    if kind == "Function scale":
        return pkg.likelihoods.Gaussian(scale=pkg.functions.Linear(A=A, b=b + 0.2))
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["variance", "scale", "Function variance", "Function scale"])
def test_gaussian_noise_through_sgpr_matches_jax_f64(kind):
    rng = np.random.RandomState(11)
    X, Z = rng.rand(40, 2) * 3.0, rng.rand(8, 2) * 3.0
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(40, 1)
    jm = gpflow_tpu.models.SGPR((X, Y), gpflow_tpu.kernels.SquaredExponential(lengthscales=[0.8, 1.1]), Z,
                                likelihood=_noise(gpflow_tpu, kind))
    pm = models.SGPR((X, Y), kernels.SquaredExponential(lengthscales=[0.8, 1.1]), Z,
                     likelihood=_noise(gpflow_tpu_torch, kind))
    assert set(parameter_dict(pm)) == set(read_values(jm))
    jv, jg, pv, pg = _value_and_grads(jm, pm, jm.training_loss, pm.training_loss)
    _close(pv, jv)
    for path in jg:
        _close(pg[path], jg[path])
    with torch.no_grad():
        _close(pm.likelihood.variance_at(torch.from_numpy(X)), jm.likelihood.variance_at(X))
        for got, want in zip(pm.predict_y(torch.from_numpy(X[:5])), jm.predict_y(X[:5])):
            _close(got, want)


def test_gaussian_rejects_both_variance_and_scale():
    with pytest.raises(ValueError, match="both"):
        likelihoods.Gaussian(0.1, scale=0.3)
    assert likelihoods.Gaussian(scale=0.3).variance is None
