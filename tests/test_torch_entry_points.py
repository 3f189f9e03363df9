"""The port's public entry points against the JAX package's: numpy inputs
(ROADMAP F3), the documentation examples that import neither jax nor optax,
and the class members and argument names (F4).

* A grid of entry points (kernels' ``__call__``, ``K`` and ``K_diag``, mean
  functions, the likelihoods' public methods, the models' and posteriors'
  ``predict_*``, ``elbo`` and ``training_loss``) is fed the same numpy
  arrays in both packages, unconverted, and must agree to float64
  round-off. The port returns tensors that may carry the autograd graph;
  the test reads them with ``detach()`` (the output side, a deviation in
  ROADMAP).
* The 12 examples of ``doc/examples`` that import neither jax nor optax
  run through the port, copied with the package's name replaced, under
  ``CI=1`` as ``tests/integration/test_examples.py`` runs them. numpy cannot
  read a tensor that carries the graph, so the run wraps
  ``torch.Tensor.__array__`` (what ``np.asarray`` calls) to detach first.
* Every public class and function of the JAX package has its public
  methods, properties and argument names in the port's counterpart: the
  JAX package's arguments, in their order, among the port's. The written
  exclusions are those of ROADMAP F4.
"""
import importlib
import importlib.util
import inspect
import pathlib

import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu_torch import config

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-12
rng = np.random.RandomState(7)
X = rng.randn(12, 2)
X2 = rng.randn(5, 2)
Y = np.sin(X[:, :1]) + 0.1 * rng.randn(12, 1)
F = rng.randn(12, 1)
FVAR = 0.1 + rng.rand(12, 1)
YB = (rng.rand(12, 1) < 0.5).astype(float)


def _np(value):
    if isinstance(value, (tuple, list)):
        return [_np(v) for v in value]
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _close(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.max(np.abs(want)), 1e-300))


KERNELS = {
    "SquaredExponential": lambda k: k.SquaredExponential(variance=1.3, lengthscales=[0.7, 1.2]),
    "Matern52": lambda k: k.Matern52(variance=0.8, lengthscales=0.9),
    "Periodic": lambda k: k.Periodic(k.SquaredExponential(lengthscales=0.6), period=1.7),
    "Sum": lambda k: k.SquaredExponential() + k.Linear(variance=0.4),
    "Product": lambda k: k.Matern32() * k.Linear(),
    "Linear": lambda k: k.Linear(variance=[0.5, 2.0]),
    "Polynomial": lambda k: k.Polynomial(degree=2.0),
    "White": lambda k: k.White(variance=0.3),
    "ArcCosine": lambda k: k.ArcCosine(order=1),
}
KERNEL_CALLS = {
    "k(X)": lambda k: k(X),
    "k(X, X2)": lambda k: k(X, X2),
    "k(X, full_cov=False)": lambda k: k(X, full_cov=False),
    "K(X)": lambda k: k.K(X),
    "K(X, X2)": lambda k: k.K(X, X2),
    "K_diag(X)": lambda k: k.K_diag(X),
}


@pytest.mark.parametrize("call", KERNEL_CALLS)
@pytest.mark.parametrize("kernel", KERNELS)
def test_kernels_take_numpy(kernel, call):
    fn = KERNEL_CALLS[call]
    _close(fn(KERNELS[kernel](gpflow_tpu_torch.kernels)), fn(KERNELS[kernel](gpflow_tpu.kernels)))


MEAN_FUNCTIONS = {
    "Linear": lambda m: m.Linear(A=np.array([[0.5], [-1.0]]), b=np.array([0.3])),
    "Constant": lambda m: m.Constant(c=np.array([1.5])),
    "Zero": lambda m: m.Zero(),
    "Polynomial": lambda m: m.Polynomial(degree=2, input_dim=2, output_dim=1),
}


@pytest.mark.parametrize("mean_function", MEAN_FUNCTIONS)
def test_mean_functions_take_numpy(mean_function):
    build = MEAN_FUNCTIONS[mean_function]
    _close(build(gpflow_tpu_torch.mean_functions)(X), build(gpflow_tpu.mean_functions)(X))


LIKELIHOODS = {
    "Gaussian": (lambda lk: lk.Gaussian(variance=0.3), Y),
    "Bernoulli": (lambda lk: lk.Bernoulli(), YB),
    "StudentT": (lambda lk: lk.StudentT(), Y),
}
LIKELIHOOD_CALLS = {
    "log_prob": lambda lk, y: lk.log_prob(X, F, y),
    "conditional_mean": lambda lk, y: lk.conditional_mean(X, F),
    "conditional_variance": lambda lk, y: lk.conditional_variance(X, F),
    "predict_mean_and_var": lambda lk, y: lk.predict_mean_and_var(X, F, FVAR),
    "predict_log_density": lambda lk, y: lk.predict_log_density(X, F, FVAR, y),
    "variational_expectations": lambda lk, y: lk.variational_expectations(X, F, FVAR, y),
}


@pytest.mark.parametrize("call", LIKELIHOOD_CALLS)
@pytest.mark.parametrize("likelihood", LIKELIHOODS)
def test_likelihoods_take_numpy(likelihood, call):
    build, y = LIKELIHOODS[likelihood]
    fn = LIKELIHOOD_CALLS[call]
    _close(fn(build(gpflow_tpu_torch.likelihoods), y), fn(build(gpflow_tpu.likelihoods), y))


MODELS = {
    "GPR": lambda p: p.models.GPR((X, Y), kernel=p.kernels.SquaredExponential(), noise_variance=0.2),
    "SGPR": lambda p: p.models.SGPR((X, Y), kernel=p.kernels.SquaredExponential(), inducing_variable=X[:4].copy(),
                                    noise_variance=0.2),
    "VGP": lambda p: p.models.VGP((X, Y), kernel=p.kernels.Matern52(), likelihood=p.likelihoods.Gaussian(0.2)),
    "SVGP": lambda p: p.models.SVGP(kernel=p.kernels.SquaredExponential(), likelihood=p.likelihoods.Gaussian(0.2),
                                    inducing_variable=X[:4].copy(), num_data=12,
                                    mean_function=p.mean_functions.Linear(np.array([[0.3], [0.1]]))),
}


def _external(m):
    return type(m).__name__ == "SVGP"


MODEL_CALLS = {
    "predict_f": lambda m: m.predict_f(X2),
    "predict_f full_cov": lambda m: m.predict_f(X2, full_cov=True),
    "predict_y": lambda m: m.predict_y(X2),
    "predict_log_density": lambda m: m.predict_log_density((X, Y)),
    "posterior().predict_f": lambda m: m.posterior().predict_f(X2),
    "training_loss": lambda m: m.training_loss((X, Y)) if _external(m) else m.training_loss(),
    "elbo": lambda m: m.elbo((X, Y)) if _external(m) else m.elbo(),
}
MODEL_GRID = [(m, c) for m in MODELS for c in MODEL_CALLS if (m, c) != ("GPR", "elbo")]  # GPR has no elbo


@pytest.mark.parametrize("model,call", MODEL_GRID)
def test_models_take_numpy(model, call):
    fn = MODEL_CALLS[call]
    _close(fn(MODELS[model](gpflow_tpu_torch)), fn(MODELS[model](gpflow_tpu)))


def test_a_tensor_passes_through_unconverted():
    """A tensor argument is handed on as it is: no copy and no move, so a
    CUDA tensor costs no host synchronisation (phases 7 and 25 run under
    sync debug mode "error")."""
    from gpflow_tpu_torch.base import input_to_tensor

    kernel = gpflow_tpu_torch.kernels.SquaredExponential()
    t = torch.from_numpy(X)
    assert input_to_tensor(kernel, t) is t
    x, n, i = input_to_tensor(kernel, (X, 2, np.arange(3)))
    assert x.dtype == torch.float64 and n.dtype == torch.float64 and i.dtype == torch.int64


# --- the documentation examples -------------------------------------------------

EXAMPLES_DIR = pathlib.Path(gpflow_tpu.__file__).parent.parent / "doc" / "examples"
NO_JAX_EXAMPLES = sorted(
    p.name for p in EXAMPLES_DIR.glob("*.py")
    if not any(s in p.read_text() for s in ("import jax", "from jax", "import optax", "from optax"))
)


def test_the_examples_without_jax_are_twelve():
    assert len(NO_JAX_EXAMPLES) == 12, NO_JAX_EXAMPLES


@pytest.mark.parametrize("example", NO_JAX_EXAMPLES)
def test_doc_example_runs_through_the_port(example, tmp_path, monkeypatch):
    monkeypatch.setenv("CI", "1")  # caps loop counts via ci_utils.reduce_in_tests
    as_array = torch.Tensor.__array__
    monkeypatch.setattr(torch.Tensor, "__array__", lambda t, *a, **k: as_array(t.detach(), *a, **k))
    path = tmp_path / example
    path.write_text((EXAMPLES_DIR / example).read_text().replace("gpflow_tpu", "gpflow_tpu_torch"))
    spec = importlib.util.spec_from_file_location(example[:-3], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert "gpflow_tpu_torch" in module.__dict__ or any(
        getattr(v, "__name__", "").startswith("gpflow_tpu_torch") for v in module.__dict__.values()
    )
    module.main()


# --- class members and argument names ---------------------------------------------

# what the port's classes and functions lack of the JAX package's, each with its reason
EXCLUDED_MEMBERS = {
    "tree_flatten": "a JAX pytree hook",
    "tree_unflatten": "a JAX pytree hook",
    "parameters": "torch's nn.Module.parameters(), which torch.optim uses; the JAX property is all_parameters",
}
# arguments of the JAX package renamed or absent in the port, each with its reason
RENAMED_ARGUMENTS = {
    "key": "generator",  # the HMC and Monte-Carlo draws take a torch.Generator (ROADMAP, deviations)
}
ABSENT_ARGUMENTS = {
    "interpret": "Pallas's interpret mode; the port's kernels are CUDA C++",
}


def _jax_modules():
    root = pathlib.Path(gpflow_tpu.__file__).parent
    for path in sorted(root.rglob("*.py")):
        parts = path.relative_to(root.parent).with_suffix("").parts
        yield ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _arguments(fn):
    try:
        return list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return None


def _holds(jax_args, port_args):
    """The JAX package's arguments, renamed or left out as written, in their
    order among the port's."""
    want = [RENAMED_ARGUMENTS.get(a, a) for a in jax_args if a not in ABSENT_ARGUMENTS]
    it = iter(port_args)
    return all(a in it for a in want)


def _member_gaps(module_name):
    jax_module = importlib.import_module(module_name)
    port_module = importlib.import_module("gpflow_tpu_torch" + module_name[len("gpflow_tpu"):])
    gaps = []
    for name, jax_value in vars(jax_module).items():
        if name.startswith("_") or getattr(jax_value, "__module__", None) != jax_module.__name__:
            continue
        port_value = getattr(port_module, name, None)
        if port_value is None:
            continue  # the module's __all__ is test_torch_utilities_surface.py's
        if inspect.isfunction(jax_value):
            if not _holds(_arguments(jax_value), _arguments(port_value) or []):
                gaps.append((name, _arguments(jax_value), _arguments(port_value)))
            continue
        if not inspect.isclass(jax_value):
            continue
        for member in dir(jax_value):
            if member.startswith("_") and member not in ("__init__", "__call__"):
                continue
            if member in EXCLUDED_MEMBERS or (hasattr(object, member) and member != "__init__"):
                continue
            jax_member = inspect.getattr_static(jax_value, member)
            try:
                port_member = inspect.getattr_static(port_value, member)
            except AttributeError:
                gaps.append((f"{name}.{member}", "missing"))
                continue
            if isinstance(jax_member, property) and callable(port_member) and not isinstance(port_member, property):
                gaps.append((f"{name}.{member}", "a method where the JAX package has a property"))
                continue
            if member == "__call__" and issubclass(port_value, torch.nn.Module):
                port_member = port_value.forward  # an nn.Module's call runs its forward
            jax_fn = getattr(jax_member, "__func__", jax_member)
            port_fn = getattr(port_member, "__func__", port_member)
            if inspect.isfunction(jax_fn) and callable(port_fn):
                jax_args, port_args = _arguments(jax_fn), _arguments(port_fn)
                if jax_args is not None and not _holds(jax_args, port_args or []):
                    gaps.append((f"{name}.{member}", jax_args, port_args))
    return gaps


@pytest.mark.parametrize("module_name", list(_jax_modules()))
def test_class_members_and_arguments(module_name):
    assert _member_gaps(module_name) == []


def test_parameter_members_of_f4():
    """The members F4 found missing: ``unconstrained_variable``, ``ndim``,
    ``forward_np``/``inverse_np`` on every bijector, ``pallas_available``
    of a dtype, and ``all_parameters`` for the JAX ``Module.parameters``."""
    from gpflow_tpu import bijectors as jb
    from gpflow_tpu_torch import Parameter, bijectors as pb
    from gpflow_tpu_torch.ops import pallas_available

    p = Parameter(np.ones((3, 2)), transform=pb.positive())
    assert p.unconstrained_variable is p.unconstrained and p.ndim == 2
    assert pallas_available(torch.float64) is False and pallas_available(np.float32) is False  # no card here
    model = MODELS["SVGP"](gpflow_tpu_torch)
    model.kernel.variance.trainable = False
    assert len(model.all_parameters) == len(model.trainable_parameters) + 1
    x = np.abs(rng.randn(3, 6)) + 0.1
    pairs = [(jb.Identity(), pb.Identity()), (jb.Exp(), pb.Exp()), (jb.Softplus(), pb.Softplus()),
             (jb.Shift(0.5), pb.Shift(0.5)), (jb.Sigmoid(), pb.Sigmoid()),
             (jb.Chain([jb.Shift(0.1), jb.Exp()]), pb.Chain([pb.Shift(0.1), pb.Exp()])),
             (jb.FillTriangular(), pb.FillTriangular())]
    for j, t in pairs:
        v = x if not isinstance(j, jb.Sigmoid) else x / (x.max() + 1.0)
        _close(t.forward_np(v), j.forward_np(v))
        _close(t.inverse_np(t.forward_np(v)), j.inverse_np(j.forward_np(v)))
    tri = np.tril(rng.randn(2, 3, 3))
    _close(pb.TriangularMask().forward_np(tri), jb.TriangularMask().forward_np(tri))
    assert isinstance(pb.Bijector.forward_np, type(pb.Exp.forward_np))
