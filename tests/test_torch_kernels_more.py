"""The kernels of gpflow_tpu_torch beyond the isotropic stationary ones,
against gpflow_tpu on the CPU in float64 on the same numpy inputs: Sum and
Product (``k1 + k2``, ``k1 * k2``, flattening, active dims on separate
dimensions), Linear, Polynomial, Static, White, Constant, Bias, Periodic,
AnisotropicStationary, Cosine and the RBF alias; K(X), K(X, X2), the
diagonal and the gradients with respect to every parameter agree to 1e-10
relative to the largest entry. Also: which kernels route to K1, the
``trainable_variables`` of a combination, and weights carried from a JAX
model with list paths."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, models
from gpflow_tpu_torch.kernels import stationaries
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
N, N2, D = 12, 9, 3


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _build(pkg, name):
    """The kernel ``name`` built from the package ``pkg`` (either kernels
    module), with the same values on both sides."""
    k = pkg
    if name == "Sum":
        return k.SquaredExponential(variance=1.3, lengthscales=[0.7, 1.2, 0.9]) + k.Linear(variance=0.4)
    if name == "Product":
        return k.Matern52(lengthscales=1.1) * k.Linear(variance=[0.5, 0.8, 1.3])
    if name == "nested Sum":
        return (k.SquaredExponential() + k.White(variance=0.2)) + (k.Constant(variance=0.6) + k.Linear())
    if name == "Sum on separate dims":
        return k.SquaredExponential(lengthscales=[0.8, 1.4], active_dims=[0, 2]) + k.Linear(active_dims=[1])
    if name == "Product on slices":
        return k.Matern32(active_dims=slice(0, 2)) * k.Periodic(k.SquaredExponential(active_dims=[2]), period=0.7)
    if name == "Linear":
        return k.Linear(variance=[0.5, 0.8, 1.3])
    if name == "Polynomial":
        return k.Polynomial(degree=2.0, variance=0.6, offset=0.3)
    if name == "White":
        return k.White(variance=0.3)
    if name == "Constant":
        return k.Constant(variance=1.7)
    if name == "Bias":
        return k.Bias(variance=0.9)
    if name == "Periodic SE":
        return k.Periodic(k.SquaredExponential(variance=1.2, lengthscales=[0.6, 0.9, 1.4]), period=[1.1, 0.8, 2.0])
    if name == "Periodic Matern12":
        return k.Periodic(k.Matern12(lengthscales=0.7), period=1.3)
    if name == "Cosine":  # ARD lengthscales are unconstrained: a negative one is assigned
        c = k.Cosine(variance=1.4, lengthscales=[0.9, 1.6, 2.2])
        c.lengthscales.assign(np.array([0.9, -1.6, 2.2]))
        return c
    if name == "RBF":
        return k.RBF(variance=0.8, lengthscales=0.6)
    raise KeyError(name)


NAMES = ["Sum", "Product", "nested Sum", "Sum on separate dims", "Product on slices", "Linear", "Polynomial",
         "White", "Constant", "Bias", "Periodic SE", "Periodic Matern12", "Cosine", "RBF"]


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return rng.rand(N, D) * 2.0, rng.rand(N2, D) * 2.0, rng.randn(N, N2), rng.randn(N, N)


@pytest.mark.parametrize("name", NAMES)
def test_kernel_matrices_match_jax_f64(name):
    X, X2, _, _ = _inputs()
    jk, pk = _build(gpflow_tpu.kernels, name), _build(kernels, name)
    Xt, X2t = torch.from_numpy(X), torch.from_numpy(X2)
    with torch.no_grad():
        _close(pk(Xt), jk(X))
        _close(pk(Xt, X2t), jk(X, X2))
        _close(pk(Xt, full_cov=False), jk(X, full_cov=False))
        _close(pk.K_diag(Xt), jk.K_diag(X))


@pytest.mark.parametrize("name", NAMES)
def test_kernel_gradients_match_jax_f64(name):
    """d/dtheta of sum(W * K(X, X2)) + sum(V * K(X)) for every trainable
    parameter, keyed by the JAX package's paths."""
    X, X2, W, V = _inputs(1)
    jk, pk = _build(gpflow_tpu.kernels, name), _build(kernels, name)
    jparams = {p: v for p, v in jax_parameter_dict(jk).items() if v.trainable}
    paths = sorted(jparams)
    objective = lambda k, x, x2, w, v: (k(x, x2) * w).sum() + (k(x) * v).sum()  # noqa: E731
    _, jgrads = reference_jit(jax.value_and_grad(functionalize(lambda: objective(jk, X, X2, W, V),
                                                         [jparams[p] for p in paths])))(
        tuple(jparams[p].unconstrained_variable for p in paths)
    )
    params = {p: v for p, v in parameter_dict(pk).items() if v.trainable}
    assert sorted(params) == paths
    value = objective(pk, *(torch.from_numpy(a) for a in (X, X2, W, V)))
    grads = torch.autograd.grad(value, [params[p].unconstrained for p in paths])
    for path, got, want in zip(paths, grads, jgrads):
        _close(got, want)


def test_sums_and_products_flatten_and_register_every_term():
    k = kernels.SquaredExponential() + kernels.Linear() + kernels.White()
    assert isinstance(k, kernels.Sum) and len(k.kernels) == 3
    assert isinstance(k.kernels, torch.nn.ModuleList)
    p = (kernels.Matern52() * kernels.Linear()) * kernels.Constant()
    assert isinstance(p, kernels.Product) and len(p.kernels) == 3
    mixed = (kernels.Matern52() * kernels.Linear()) + kernels.Constant()
    assert isinstance(mixed, kernels.Sum) and isinstance(mixed.kernels[0], kernels.Product)
    # every term's parameters are the model's: what an optimizer is handed
    model = models.GPR((np.zeros((4, 1)), np.zeros((4, 1))), kernel=k)
    paths = {id(v): path for path, v in parameter_dict(model).items()}
    assert sorted(paths[id(v)] for v in model.trainable_variables) == [
        ".kernel.kernels[0].lengthscales", ".kernel.kernels[0].variance", ".kernel.kernels[1].variance",
        ".kernel.kernels[2].variance", ".likelihood.variance",
    ]
    with pytest.raises(TypeError, match="Kernel"):
        kernels.Sum([kernels.Linear(), object()])


@pytest.mark.parametrize("dims,separate", [
    (([0], [1]), True), (([0, 2], [1]), True), (([0, 1], [1, 2]), False), ((slice(0, 1), [1]), False),
])
def test_on_separate_dimensions_matches_jax(dims, separate):
    a, b = dims
    for pkg in (gpflow_tpu.kernels, kernels):
        k = pkg.Linear(active_dims=a) + pkg.White(active_dims=b)
        assert k.on_separate_dimensions is separate
        assert k.kernels[0].on_separate_dims(k.kernels[1]) is separate


def test_active_dims_setter_and_periodic_delegation():
    k = kernels.Linear()
    k.active_dims = [2, 0]
    assert k.active_dims == (2, 0)
    p = kernels.Periodic(kernels.SquaredExponential(active_dims=[1]))
    assert p.active_dims == (1,)
    p.active_dims = [0]
    assert p.base_kernel.active_dims == (0,) and p.active_dims == (0,)
    with pytest.raises(TypeError, match="IsotropicStationary"):
        kernels.Periodic(kernels.Linear())


def test_anisotropic_ard_lengthscales_are_unconstrained():
    c = kernels.Cosine(lengthscales=[1.0, 2.0])
    assert type(c.lengthscales.transform).__name__ == "Identity"
    c.lengthscales.assign(np.array([1.0, -2.0]))
    assert float(c.lengthscales.value.detach()[1]) == -2.0
    assert kernels.RBF is kernels.SquaredExponential


def test_k1_routing_by_exact_type(monkeypatch):
    """Which kernels' K reaches K1, with ``_routes_to_kernel`` forced true on
    the CPU and ``stationary_kernel_matrix`` recorded: the SquaredExponential
    terms of a Sum and a Product do; a Periodic, a Cosine, the Linear and
    static terms and a user's subclass do not."""
    calls = []
    real = stationaries.stationary_kernel_matrix

    def recording(X, Z, lengthscales, variance, family, alpha=None):
        calls.append(family)
        return real(X, Z, lengthscales, variance, family, alpha=alpha)

    monkeypatch.setattr(stationaries, "_routes_to_kernel", lambda X: True)
    monkeypatch.setattr(stationaries, "stationary_kernel_matrix", recording)

    class MySE(kernels.SquaredExponential):
        pass

    X = torch.from_numpy(np.random.RandomState(3).rand(6, 2))
    cases = [
        (kernels.SquaredExponential() + kernels.Linear(), ["rbf"]),
        (kernels.Matern52() * kernels.SquaredExponential() * kernels.White(), ["matern52", "rbf"]),
        (kernels.Periodic(kernels.SquaredExponential()), []),
        (kernels.Cosine(), []),
        (MySE(), []),
        (kernels.Polynomial() + kernels.Constant(), []),
    ]
    for k, want in cases:
        calls.clear()
        k(X)
        assert calls == want, (type(k).__name__, calls)
        calls.clear()
        k(X, full_cov=False)
        assert calls == []


def test_sum_kernel_model_weights_load_from_jax_read_values():
    """A JAX GPR with a Sum kernel: its ``read_values`` loads into the port
    unchanged, list children written ``.kernel.kernels[0]....``."""
    rng = np.random.RandomState(4)
    X, Y = rng.rand(10, 2), rng.randn(10, 1)
    jm = gpflow_tpu.models.GPR(
        (X, Y), kernel=gpflow_tpu.kernels.SquaredExponential(lengthscales=[0.3, 0.9])
        + gpflow_tpu.kernels.Periodic(gpflow_tpu.kernels.Matern12(), period=0.4) + gpflow_tpu.kernels.Linear(0.7),
        noise_variance=0.2,
    )
    pm = models.GPR(
        (X, Y), kernel=kernels.SquaredExponential(lengthscales=[1.0, 1.0])
        + kernels.Periodic(kernels.Matern12()) + kernels.Linear(), noise_variance=1.0,
    )
    values = read_values(jm)
    assert ".kernel.kernels[1].base_kernel.lengthscales" in values
    assert set(parameter_dict(pm)) == set(values)
    load_jax_values(pm, values)
    with torch.no_grad():
        _close(pm.log_marginal_likelihood(), jm.log_marginal_likelihood())
