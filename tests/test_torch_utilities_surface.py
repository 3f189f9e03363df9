"""The public surface of gpflow_tpu_torch against gpflow_tpu's, and the
utilities of its last slice, on the CPU against the JAX package on the same
numpy inputs: for every JAX module with a counterpart at the same path, its
``__all__`` less the port's is a written list of exclusions; the module
tree's traversal, ``leaf_components`` and the summary table (the same text
for a model whose values came across through ``load_jax_values``);
``training_loop`` against the optax path in float64; ``FillTriangular``,
``triangular_size``, ``broadcasting_elementwise`` and ``eye``;
``PrecomputedValue``; ``capture_parameter_reads``; ``profile``."""
import glob
import importlib
import json
import operator
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpflow_tpu
import gpflow_tpu.posteriors as jax_posteriors
from gpflow_tpu.base import capture_parameter_reads as jax_capture
from gpflow_tpu.utilities import read_values as jax_read_values
import gpflow_tpu_torch
from gpflow_tpu_torch import Parameter, bijectors, config, kernels, likelihoods, priors
from gpflow_tpu_torch.base import capture_parameter_reads
from gpflow_tpu_torch.models import GPR, SVGP
from gpflow_tpu_torch.posteriors import PrecomputedValue, get_precomputed_value_shape
from gpflow_tpu_torch.utilities import (
    annotate,
    broadcasting_elementwise,
    eye,
    is_variable,
    leaf_components,
    load_jax_values,
    parameter_dict,
    positive_parameter,
    print_summary,
    profile,
    read_values,
    tabulate_module_summary,
    training_loop,
    traverse_module,
    triangular_size,
)
from gpflow_tpu_torch.utilities.shapes import _shape_of
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

JAX_ROOT = Path(gpflow_tpu.__file__).parent
# JAX modules with no counterpart in the port, each with its reason (none
# since the mesh and the sharded data were ported)
NOT_PORTED: dict = {}
# names of a ported module's __all__ that the port's lacks, each with its
# reason (the private back-compat Pallas aliases of
# gpflow_tpu/ops/pallas_distance.py are not in its __all__ and need none)
EXCLUDED: dict = {}


def _jax_modules():
    names = []
    for path in sorted(JAX_ROOT.rglob("*.py")):
        parts = path.relative_to(JAX_ROOT.parent).with_suffix("").parts
        names.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return names


@pytest.mark.parametrize("name", _jax_modules())
def test_public_surface(name):
    """Each module of the JAX package has a counterpart at the same path in
    the port (or a written reason), whose ``__all__`` holds the JAX
    module's but for the written exclusions."""
    port_name = "gpflow_tpu_torch" + name[len("gpflow_tpu"):]
    if name in NOT_PORTED:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(port_name)
        return
    jax_module, port_module = importlib.import_module(name), importlib.import_module(port_name)
    missing = set(getattr(jax_module, "__all__", ())) - set(getattr(port_module, "__all__", ()))
    assert missing == set(EXCLUDED.get(name, {})), f"{port_name} lacks {sorted(missing)}"
    for attr in getattr(port_module, "__all__", ()):
        assert hasattr(port_module, attr), f"{port_name}.__all__ names {attr!r}, which it lacks"


def test_exclusions_name_real_modules():
    assert set(NOT_PORTED) <= set(_jax_modules()) and set(EXCLUDED) <= set(_jax_modules())


def _data(n=16, d=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, d) * 3
    return X, np.sin(2 * X[:, :1]) + 0.1 * rng.randn(n, 1)


def _gpr_pair(kernel="sum"):
    """A GPR in both packages with the same values; a Sum kernel with a
    prior on one lengthscale puts a list index and a prior in the paths."""
    data = _data()
    if kernel == "sum":
        jk = gpflow_tpu.kernels.SquaredExponential(lengthscales=[0.7, 1.3]) + gpflow_tpu.kernels.Linear()
        jk.kernels[0].lengthscales.prior = gpflow_tpu.priors.Gamma(2.0, 1.0)
        pk = kernels.SquaredExponential(lengthscales=[1.0, 1.0]) + kernels.Linear()
        pk.kernels[0].lengthscales.prior = priors.Gamma(2.0, 1.0)
    else:
        jk = gpflow_tpu.kernels.Matern52(lengthscales=[0.7, 1.3])
        pk = kernels.Matern52(lengthscales=[1.0, 1.0])
    jm = gpflow_tpu.models.GPR(data, jk, noise_variance=0.3)
    pm = GPR(data, pk, noise_variance=1.0)
    load_jax_values(pm, jax_read_values(jm))
    return jm, pm


def _svgp_pair(m=5):
    X, Y = _data()
    rng = np.random.RandomState(7)
    q_sqrt = np.tril(0.1 * rng.randn(1, m, m), k=-1)
    q_sqrt[0, np.arange(m), np.arange(m)] = 0.5 + rng.rand(m)
    jm = gpflow_tpu.models.SVGP(kernel=gpflow_tpu.kernels.SquaredExponential(lengthscales=[0.7, 1.3]),
                                likelihood=gpflow_tpu.likelihoods.Gaussian(0.2), inducing_variable=X[:m].copy(),
                                num_data=len(X))
    jm.q_sqrt.assign(q_sqrt)
    jm.q_mu.assign(rng.randn(m, 1))
    pm = SVGP(kernel=kernels.SquaredExponential(lengthscales=np.ones(2)), likelihood=likelihoods.Gaussian(1.0),
              inducing_variable=np.zeros((m, 2)), num_data=len(X))
    load_jax_values(pm, jax_read_values(jm))
    return jm, pm, (X, Y)


@pytest.mark.parametrize("which", ["gpr", "svgp"])
def test_leaf_components_and_traversal(which):
    jm, pm = _gpr_pair()[:2] if which == "gpr" else _svgp_pair()[:2]
    assert list(leaf_components(pm)) == list(gpflow_tpu.utilities.leaf_components(jm))

    def collect(leaf, path, state):
        return state + [path]

    got = traverse_module(pm, ("", []), collect, (Parameter,))
    want = gpflow_tpu.utilities.traverse_module(jm, ("", []), collect, (gpflow_tpu.Parameter,))
    assert got == want and sorted(got) == sorted(parameter_dict(pm))


@pytest.mark.parametrize("fmt", [None, "fancy_grid", "simple", "grid", "plain", "html", "github"])
@pytest.mark.parametrize("which", ["gpr", "svgp"])
def test_summary_table_is_the_jax_package_s(which, fmt):
    jm, pm = _gpr_pair()[:2] if which == "gpr" else _svgp_pair()[:2]
    got = tabulate_module_summary(pm, fmt)
    assert got == gpflow_tpu.utilities.tabulate_module_summary(jm, fmt)
    assert "Parameter" in got and "float64" in got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_summary_dtype_and_values(dtype):
    """The dtype column names numpy's type, and the values come from one
    copy that keeps each parameter's own type."""
    _, pm = _gpr_pair("matern")
    pm = pm.to(dtype)
    text = tabulate_module_summary(pm, "plain")
    values = read_values(pm)
    assert text.count(str(dtype).replace("torch.", "")) == len(values)
    assert f"{values['.likelihood.variance'].reshape(())}" in text


def test_print_summary_routes(capsys, monkeypatch):
    """A named format prints the table; "notebook" displays it as HTML
    through IPython (here a stand-in module)."""
    _, pm = _gpr_pair()
    print_summary(pm, "grid")
    assert capsys.readouterr().out == tabulate_module_summary(pm, "grid") + "\n"
    shown = []
    display = types.ModuleType("IPython.display")
    display.HTML = lambda s: ("HTML", s)
    display.display = shown.append
    monkeypatch.setitem(sys.modules, "IPython", types.ModuleType("IPython"))
    monkeypatch.setitem(sys.modules, "IPython.display", display)
    print_summary(pm, "notebook")
    assert shown == [("HTML", "<pre>" + tabulate_module_summary(pm, "html") + "</pre>")]


def test_print_summary_default_format_is_the_config_s(capsys):
    jm, pm = _gpr_pair()
    for m in (gpflow_tpu.config, config):
        m.set_default_summary_fmt("simple")
    try:
        print_summary(pm)
        got = capsys.readouterr().out
        gpflow_tpu.utilities.print_summary(jm)
        assert got == capsys.readouterr().out
        assert got == tabulate_module_summary(pm, "simple") + "\n"
    finally:
        for m in (gpflow_tpu.config, config):
            m.set_default_summary_fmt("fancy_grid")


def _loop_pair(which):
    if which == "gpr":
        jm, pm = _gpr_pair("matern")
        return jm, pm, jm.training_loss, pm.training_loss
    jm, pm, data = _svgp_pair()
    return (jm, pm, jm.training_loss_closure(data, compile=False),
            pm.training_loss_closure(tuple(torch.from_numpy(a) for a in data), compile=False))


@pytest.mark.parametrize("use_scan", [False, True])
@pytest.mark.parametrize("which", ["gpr", "svgp"])
def test_training_loop_is_the_optax_path(which, use_scan):
    """Ten Adam steps in float64 from the same values: the same loss
    history and the same final values, within 1e-10 relative."""
    jm, pm, jclosure, pclosure = _loop_pair(which)
    jvars = jm.trainable_variables if which == "svgp" else None
    pvars = pm.trainable_variables if which == "svgp" else None
    want = np.asarray(gpflow_tpu.utilities.training_loop(jclosure, var_list=jvars, maxiter=10, use_scan=use_scan))
    got = training_loop(pclosure, var_list=pvars, maxiter=10, use_scan=use_scan)
    assert got.shape == (10,) and got.dtype == torch.float64 and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    assert want[-1] < want[0]
    jv = jax_read_values(jm)
    for path, value in read_values(pm).items():
        np.testing.assert_allclose(value, jv[path], rtol=1e-10, atol=1e-14, err_msg=path)
    assert all(p.unconstrained.grad is None for p in pm.trainable_variables)


def test_training_loop_with_another_optimizer():
    """An optimizer factory (plain SGD) against optax.sgd, on a var_list
    that leaves the likelihood out."""
    jm, pm = _gpr_pair("matern")
    want = np.asarray(gpflow_tpu.utilities.training_loop(
        jm.training_loss, optimizer=optax.sgd(0.01), var_list=jm.kernel.trainable_variables, maxiter=5))
    got = training_loop(pm.training_loss, optimizer=lambda params: torch.optim.SGD(params, lr=0.01),
                        var_list=pm.kernel.trainable_variables, maxiter=5)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10)
    assert float(pm.likelihood.variance.numpy()) == float(np.asarray(jm.likelihood.variance.value)) == 0.3


def test_training_loop_errors_and_no_steps():
    jm, pm = _gpr_pair("matern")
    for loop, closure in ((gpflow_tpu.utilities.training_loop, lambda: jm.training_loss()),
                          (training_loop, lambda: pm.training_loss())):
        with pytest.raises(ValueError, match="needs `var_list`"):
            loop(closure, maxiter=1)
    for loop, m in ((gpflow_tpu.utilities.training_loop, jm), (training_loop, pm)):
        with pytest.raises(ValueError, match="use_scan=True"):
            loop(m.training_loss, maxiter=1, use_scan=True, compile=True)
    empty = training_loop(pm.training_loss, maxiter=0)
    assert empty.shape == (0,) and empty.dtype == torch.float64
    assert np.asarray(gpflow_tpu.utilities.training_loop(jm.training_loss, maxiter=0)).shape == (0,)


@pytest.mark.parametrize("which", ["gpr", "svgp"])
def test_capture_parameter_reads(which):
    """The Parameters a training loss reads, in first-read order, each once,
    as in the JAX package."""
    jm, pm, jclosure, pclosure = _loop_pair(which)
    jpaths = {id(p): k for k, p in gpflow_tpu.utilities.parameter_dict(jm).items()}
    ppaths = {id(p): k for k, p in parameter_dict(pm).items()}
    with jax_capture() as jcap:
        jclosure()
    with capture_parameter_reads() as pcap:
        pclosure()
        with capture_parameter_reads() as inner:
            pm.likelihood.variance.value
    assert [ppaths[id(p)] for p in pcap.parameters] == [jpaths[id(p)] for p in jcap.parameters]
    assert len(pcap.parameters) == len(set(map(id, pcap.parameters))) == len(ppaths)
    assert inner.parameters == [pm.likelihood.variance]


@pytest.mark.parametrize("batch", [(), (2,), (2, 3)])
@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_fill_triangular(n, batch):
    rng = np.random.RandomState(n)
    x = rng.randn(*batch, triangular_size(n))
    jb, pb = gpflow_tpu.bijectors.FillTriangular(), bijectors.FillTriangular()
    want = np.asarray(jb.forward(jnp.asarray(x)))
    got = pb.forward(torch.from_numpy(x))
    assert got.shape == batch + (n, n) and pb.forward_shape(torch.Size(x.shape)) == got.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(pb.inverse(got).numpy(), x)
    np.testing.assert_array_equal(pb.inverse(got).numpy(), np.asarray(jb.inverse(jnp.asarray(want))))
    ldj = pb.forward_log_det_jacobian(torch.from_numpy(x))
    np.testing.assert_array_equal(ldj.numpy(), np.asarray(jb.forward_log_det_jacobian(jnp.asarray(x))))


def test_fill_triangular_parameter():
    """A Parameter with FillTriangular stores n(n+1)/2 values and shows, and
    takes, the [n, n] matrix."""
    L = np.tril(np.arange(1.0, 10.0).reshape(3, 3))
    p = Parameter(L, transform=bijectors.FillTriangular())
    jp = gpflow_tpu.Parameter(L, transform=gpflow_tpu.bijectors.FillTriangular())
    assert p.unconstrained.shape == (6,) and tuple(p.shape) == jp.shape == (3, 3)
    np.testing.assert_array_equal(p.numpy(), L)
    p.assign(2 * L)
    np.testing.assert_array_equal(p.numpy(), 2 * L)
    with pytest.raises(ValueError, match="cannot assign"):
        p.assign(np.eye(4))
    with pytest.raises(ValueError, match="not a triangular number"):
        bijectors.FillTriangular().forward(torch.zeros(4))


@pytest.mark.parametrize("n", [0, 1, 2, 7, 2048])
def test_triangular_size(n):
    assert triangular_size(n) == gpflow_tpu.bijectors.triangular_size(n) == n * (n + 1) // 2
    assert gpflow_tpu_torch.utilities.bijectors.triangular_size is triangular_size


@pytest.mark.parametrize("op", [operator.add, operator.mul, operator.sub, torch.maximum])
@pytest.mark.parametrize("shapes", [((3,), (4,)), ((2, 3), (4,)), ((), (2, 2))])
def test_broadcasting_elementwise(op, shapes):
    rng = np.random.RandomState(1)
    a, b = np.asarray(rng.randn(*shapes[0])), np.asarray(rng.randn(*shapes[1]))
    jop = jnp.maximum if op is torch.maximum else op
    want = np.asarray(gpflow_tpu.utilities.broadcasting_elementwise(jop, jnp.asarray(a), jnp.asarray(b)))
    got = broadcasting_elementwise(op, torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == shapes[0] + shapes[1]
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("num, value, dtype", [(3, 1.0, None), (4, 2.5, np.float32), (2, 0.1, np.float64)])
def test_eye(num, value, dtype):
    want = np.asarray(gpflow_tpu.utilities.eye(num, value, dtype))
    got = eye(num, value, None if dtype is None else config.as_torch_dtype(dtype))
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    t = eye(2, torch.tensor(3.0, dtype=torch.float64))
    np.testing.assert_array_equal(t.numpy(), 3.0 * np.eye(2))


def test_precomputed_value_shapes():
    alpha, Qinv = np.ones((4, 2)), np.ones((2, 4, 4))
    got = PrecomputedValue.wrap_alpha_Qinv(torch.from_numpy(alpha), torch.from_numpy(Qinv))
    want = jax_posteriors.PrecomputedValue.wrap_alpha_Qinv(jnp.asarray(alpha), jnp.asarray(Qinv))
    for g, w in zip(got, want):
        assert g.axis_dynamic == w.axis_dynamic
        assert get_precomputed_value_shape(g) == jax_posteriors.get_precomputed_value_shape(w)
    v = PrecomputedValue(torch.zeros(5, 3, 2), (True, False, True))
    assert PrecomputedValue.shape_of(v) == (None, 3, None)
    # registered with the shape contracts, which skip a shape with unknown axes
    assert _shape_of(v) is None and _shape_of(PrecomputedValue(torch.zeros(5, 3), (False, False))) == (5, 3)


def test_profile_writes_a_trace(tmp_path):
    _, pm = _gpr_pair("matern")
    with profile(str(tmp_path)):
        for _ in range(2):
            with annotate("train_step"):
                pm.training_loss()
    traces = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        trace = json.load(f)
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("train_step") == 2
    with pytest.raises(NotImplementedError, match="Perfetto"):
        with profile(str(tmp_path), create_perfetto_link=True):
            pass


def test_misc_helpers():
    p = positive_parameter(2.0)
    jp = gpflow_tpu.utilities.positive_parameter(2.0)
    assert p.transform.name == jp.transform.name and positive_parameter(p) is p
    np.testing.assert_allclose(p.unconstrained.detach().numpy(), np.asarray(jp.unconstrained_variable), rtol=1e-15)
    assert is_variable(p) and not is_variable(torch.zeros(1)) and not is_variable(2.0)
    assert gpflow_tpu.utilities.is_variable(jp)
    from gpflow_tpu_torch.models import util

    assert util.ExternalDataTrainingLossMixin is gpflow_tpu_torch.models.training_mixins.ExternalDataTrainingLossMixin
    assert util.InducingPointsLike is not None and util.InducingVariablesLike is not None
    assert gpflow_tpu_torch.TensorType is gpflow_tpu_torch.base.TensorType
    assert gpflow_tpu_torch.default_float() == torch.float64
    assert gpflow_tpu_torch.quadrature.NDiagGHQuadrature is not None
