"""The shape contracts of gpflow_tpu_torch against gpflow_tpu's.

A walk of every module of both packages collects each function and method
that carries ``__check_shapes__`` or ``__inherits_check_shapes__``, the
implementations registered in dispatch tables among them, and the port must
hold the same qualified names with the same spec strings, but for the
exclusions written below with their reasons. Then each decorated entry point
of slices 1-6 (the posteriors, natural gradients, GPR, SGPR, CGLB, the
likelihoods and quadrature, and what they stand on) takes one malformed and
one valid call, built from a seeded numpy generator, with the checks on in
both packages: both raise their own ``ShapeError`` on the malformed call and
accept the valid one, giving outputs of the same shapes and values (float64,
1e-8 of the largest entry; the JAX side under ``jax.jit`` where it
computes). Last, slices 1-6's paths run once with the port's checks on and
once off and give the same numbers, the flagship's symbolic artifact
exported with the checks on serves every batch size, and a malformed request
fails before any kernel matrix is computed."""
import importlib
import inspect
import pathlib
import pkgutil
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpflow_tpu as gj
import gpflow_tpu_torch as gt
from gpflow_tpu.utilities import shapes as jax_shapes
from gpflow_tpu_torch import config
from gpflow_tpu_torch.utilities import shapes as port_shapes
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

# The modules whose contracts came with slices 1-6 (they had none in the
# port before): every one must hold contracts in both packages.
SLICE_MODULES = (
    "bijectors", "conditionals.util", "inducing_variables.inducing_variables",
    "inducing_variables.multioutput.inducing_variables", "kernels.base", "kullback_leiblers",
    "likelihoods.base", "likelihoods.scalar_continuous", "likelihoods.scalar_discrete", "likelihoods.utils",
    "logdensities", "models.cglb", "models.gplvm", "models.gpr", "models.model", "models.sgpr",
    "models.training_mixins", "optimizers.natgrad", "posteriors", "quadrature.base", "quadrature.gauss_hermite",
    "utilities.misc", "utilities.model_utils", "utilities.ops",
)
# Modules of the JAX package that the port does not hold, each with its reason
# (none: the mesh and the sharded data came last).
MODULE_EXCLUSIONS: dict = {}
# Contracts of the JAX package that the port does not carry, each with its reason.
EXCLUSIONS: dict = {}
INHERIT = "inherit_check_shapes"


def _modules(package):
    root = importlib.import_module(package)
    names = [m.name for m in pkgutil.walk_packages(root.__path__, package + ".")]
    return {name[len(package) + 1:]: importlib.import_module(name) for name in names if "._build" not in name}


def _record(table, module, qualname, fn):
    specs = getattr(fn, "__check_shapes__", None)
    if getattr(fn, "__inherits_check_shapes__", False):
        table[(module, qualname)] = INHERIT
    elif specs is not None:
        table[(module, qualname)] = tuple(specs)


def _contracts(package):
    """{(module, qualified name): specs or INHERIT} of every contract in
    ``package``. A method of an ``nn.Module`` is named as the JAX package
    names it (``forward`` as ``__call__``); an implementation registered in
    a dispatch table is named ``<table>[<qualified name>]``, apart from the
    module attribute of the same function, so that the registered callable
    itself is the checked one."""
    dispatcher = importlib.import_module(package + ".utilities.multipledispatch").Dispatcher
    table = {}
    for module_name, module in _modules(package).items():
        for value in vars(module).values():
            if isinstance(value, dispatcher):
                for fn in set(value.funcs.values()):
                    if getattr(fn, "__module__", None) == module.__name__:
                        _record(table, module_name, f"{value.name}[{fn.__qualname__}]", fn)
            if getattr(value, "__module__", None) != module.__name__:
                continue
            if inspect.isfunction(value):
                _record(table, module_name, value.__qualname__, value)
            elif inspect.isclass(value):
                is_module = issubclass(value, torch.nn.Module)
                for attr, member in vars(value).items():
                    if isinstance(member, (staticmethod, classmethod)):
                        member = member.__func__
                    name = "__call__" if is_module and attr == "forward" else attr
                    accessors = (member.fget, member.fset) if isinstance(member, property) else (member,)
                    for fn in accessors:
                        if callable(fn):
                            _record(table, module_name, f"{value.__qualname__}.{name}", fn)
    return table


JAX_CONTRACTS = _contracts("gpflow_tpu")
PORT_CONTRACTS = _contracts("gpflow_tpu_torch")
CONTRACT_MODULES = sorted({m for m, _ in JAX_CONTRACTS} | {m for m, _ in PORT_CONTRACTS})


def _of_module(table, module):
    return {q: specs for (m, q), specs in table.items() if m == module}


@pytest.mark.parametrize("module", CONTRACT_MODULES)
def test_the_port_holds_the_jax_packages_contracts(module):
    want = {q: s for q, s in _of_module(JAX_CONTRACTS, module).items() if (module, q) not in EXCLUSIONS}
    got = _of_module(PORT_CONTRACTS, module)
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    differ = sorted(q for q in set(want) & set(got) if want[q] != got[q])
    assert not missing and not extra and not differ, (
        f"{module}: missing {missing}, not in the JAX package {extra}, other specs "
        f"{[(q, want[q], got[q]) for q in differ]}")


def test_every_slice_module_holds_contracts_in_both_packages():
    for module in SLICE_MODULES:
        assert _of_module(JAX_CONTRACTS, module), module
        assert _of_module(PORT_CONTRACTS, module), module


def test_the_exclusions_are_the_only_gaps():
    jax_modules, port_modules = set(_modules("gpflow_tpu")), set(_modules("gpflow_tpu_torch"))
    assert jax_modules - port_modules == set(MODULE_EXCLUSIONS)
    for module in MODULE_EXCLUSIONS:
        assert not _of_module(JAX_CONTRACTS, module), f"{module} holds contracts: compare them"
    for key in EXCLUSIONS:
        assert key in JAX_CONTRACTS and key not in PORT_CONTRACTS, key
    assert len(JAX_CONTRACTS) - len(EXCLUSIONS) == len(PORT_CONTRACTS)


def test_the_registered_callable_is_the_checked_one():
    """A contract sits under its dispatch registration, so that the table
    calls the checked function (the KL and the conditionals)."""
    for package in ("gpflow_tpu", "gpflow_tpu_torch"):
        kl = importlib.import_module(package + ".kullback_leiblers")
        registered = set(kl.prior_kl.funcs.values())
        assert registered and all(hasattr(fn, "__check_shapes__") for fn in registered), package
    assert PORT_CONTRACTS[("kullback_leiblers", "prior_kl[_prior_kl_default]")] == \
        JAX_CONTRACTS[("kullback_leiblers", "prior_kl[_prior_kl_default]")]


def test_swap_dimensions_wraps_the_same_contract():
    """The conversions' wrapper carries its own contract, which
    ``functools.wraps`` hides under the converted function's: a probe
    without one shows it."""
    probe = lambda a, b: (a, b)  # noqa: E731
    want = gj.optimizers.natgrad.swap_dimensions(probe).__check_shapes__
    assert gt.optimizers.natgrad.swap_dimensions(probe).__check_shapes__ == want


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_each_spec_names_an_argument(module):
    """A spec whose argument the function does not take would never be
    checked: every spec names an argument of the port's function."""
    for qualname, specs in _of_module(PORT_CONTRACTS, module).items():
        if specs == INHERIT:
            continue
        obj = importlib.import_module(f"gpflow_tpu_torch.{module}")
        if "[" in qualname:  # a dispatch registration: its module attribute
            qualname = qualname[qualname.index("[") + 1:-1]
        for part in qualname.split("."):
            obj = vars(obj)[part] if part in vars(obj) else vars(obj)["forward"]
        if isinstance(obj, (staticmethod, classmethod)):
            obj = obj.__func__
        if isinstance(obj, property):
            obj = obj.fget
        params = inspect.signature(inspect.unwrap(obj)).parameters
        for spec in specs:
            name = spec.split(":")[0].strip().split("[")[0].split(".")[0]
            assert name == "return" or name in params, f"{module}.{qualname}: {spec!r}"


# --------------------------------------------------------------------------
# The same calls in both packages
# --------------------------------------------------------------------------


@pytest.fixture
def checks_on():
    previous = port_shapes.get_enable_check_shapes(), jax_shapes.get_enable_check_shapes()
    port_shapes.set_enable_check_shapes(True)
    jax_shapes.set_enable_check_shapes(True)
    try:
        yield
    finally:
        port_shapes.set_enable_check_shapes(previous[0])
        jax_shapes.set_enable_check_shapes(previous[1])


N, M, D, NEW = 12, 5, 2, 7


def _rng(seed=0):
    return np.random.RandomState(seed)


def _lower(rng, *shape):
    L = np.tril(rng.randn(*shape) * 0.1)
    idx = np.arange(shape[-1])
    L[..., idx, idx] = 0.5 + rng.rand(*shape[:-1])
    return L


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _both(fn_j, fn_p, ok, bad=None, jit=True):
    """The four calls of a case: each package's function on the valid
    arguments ``ok`` and the malformed ``bad`` (numpy arrays, turned into
    tensors for the port). The JAX function is jitted where ``jit``."""
    call_j = reference_jit(fn_j) if jit else fn_j
    return (lambda: call_j(*ok), (lambda: fn_j(*bad)) if bad is not None else None,
            lambda: fn_p(*_t(*ok)), (lambda: fn_p(*_t(*bad))) if bad is not None else None)


def _data(seed=0, P=1):
    rng = _rng(seed)
    X = rng.rand(N, D) * 2.0
    Y = np.sin(3.0 * X[:, :1]) + 0.1 * rng.randn(N, P)
    Z = X[:M].copy()
    Xnew = rng.rand(NEW, D) * 2.0
    return X, Y, Z, Xnew


def _models(cls, P=1, **kwargs):
    X, Y, Z, _ = _data(P=P)
    out = []
    for pkg in (gj, gt):
        kernel = pkg.kernels.SquaredExponential(lengthscales=[0.8, 1.1])
        if cls == "GPR":
            out.append(pkg.models.GPR((X, Y), kernel, noise_variance=0.1))
        else:
            out.append(getattr(pkg.models, cls)((X, Y), kernel, inducing_variable=Z, noise_variance=0.1, **kwargs))
    return out


def _svgp(pkg, L=1, q_diag=False, whiten=True, likelihood="Gaussian"):
    _, _, Z, _ = _data()
    return pkg.models.SVGP(pkg.kernels.Matern52(lengthscales=[0.8, 1.1]), getattr(pkg.likelihoods, likelihood)(),
                           Z, num_latent_gps=L, q_diag=q_diag, whiten=whiten, num_data=N)


def _method(objs, name, ok, bad=None, jit=True):
    return _both(lambda *a: getattr(objs[0], name)(*a), lambda *a: getattr(objs[1], name)(*a), ok, bad, jit=jit)


def _no_args(objs, name, jit=True):
    jm, pm = objs
    fn = (lambda: getattr(jm, name)())
    return (reference_jit(fn) if jit else fn), None, lambda: getattr(pm, name)(), None


def _ops_cases():
    rng = _rng(1)
    A, B3 = rng.randn(5, 2), rng.randn(4, 3)
    X3 = rng.randn(2, 5, 3)
    return {
        "ops.eye": _both(lambda v: gj.utilities.ops.eye(3, v), lambda v: gt.utilities.ops.eye(3, v),
                         (np.asarray(2.0),), (np.ones(2),)),
        "ops.square_distance": _both(gj.utilities.ops.square_distance, gt.utilities.ops.square_distance,
                                     (A, rng.randn(4, 2)), (A, B3)),
        "ops.square_distance X2 None": _both(lambda x: gj.utilities.ops.square_distance(x, None),
                                             lambda x: gt.utilities.ops.square_distance(x, None), (X3,), (A[0],)),
        "ops.difference_matrix": _both(gj.utilities.ops.difference_matrix, gt.utilities.ops.difference_matrix,
                                       (A, rng.randn(4, 2)), (A, B3)),
        "ops.pca_reduce": _both(lambda x: gj.utilities.ops.pca_reduce(x, 1),
                                lambda x: gt.utilities.ops.pca_reduce(x, 1), (A,), (X3,), jit=False),
        "ops.leading_transpose": _both(lambda x: gj.utilities.ops.leading_transpose(x, [..., -1, -2]),
                                       lambda x: gt.utilities.ops.leading_transpose(x, [..., -1, -2]), (X3,)),
        "ops.broadcasting_elementwise": _both(
            lambda a, b: gj.utilities.ops.broadcasting_elementwise(jnp.add, a, b),
            lambda a, b: gt.utilities.ops.broadcasting_elementwise(torch.add, a, b), (A, B3)),
        "misc.to_default_float": _both(gj.utilities.to_default_float, gt.utilities.to_default_float, (X3,),
                                       jit=False),
        "misc.to_default_int": _both(gj.utilities.to_default_int, gt.utilities.to_default_int, (X3 > 0,), jit=False),
        "bijectors.triangular_size": _both(gj.bijectors.triangular_size, gt.bijectors.triangular_size,
                                           (np.asarray(4),), (np.array([4]),), jit=False),
        "model_utils.add_noise_cov": _both(gj.utilities.add_noise_cov, gt.utilities.add_noise_cov,
                                           (np.eye(4), np.asarray(0.3)), (rng.randn(3, 4), np.asarray(0.3))),
        "model_utils.add_likelihood_noise_cov": _both(
            lambda K, X: gj.utilities.add_likelihood_noise_cov(K, gj.likelihoods.Gaussian(0.2), X),
            lambda K, X: gt.utilities.add_likelihood_noise_cov(K, gt.likelihoods.Gaussian(0.2), X),
            (np.eye(5), A), (np.eye(4), A), jit=False),
    }


def _density_cases():
    rng = _rng(2)
    x, mu = rng.randn(3, 2), rng.randn(3, 2)
    L = _lower(rng, 3, 3)
    p = rng.rand(3, 2) * 0.8 + 0.1
    return {
        "logdensities.gaussian": _both(gj.logdensities.gaussian, gt.logdensities.gaussian, (x, mu, p)),
        "logdensities.bernoulli": _both(gj.logdensities.bernoulli, gt.logdensities.bernoulli, ((x > 0) * 1.0, p)),
        "logdensities.poisson": _both(gj.logdensities.poisson, gt.logdensities.poisson, (np.round(p * 5), p + 1)),
        "logdensities.multivariate_normal": _both(gj.logdensities.multivariate_normal,
                                                  gt.logdensities.multivariate_normal,
                                                  (x, mu[:, :1], L), (x, mu, _lower(rng, 4, 4))),
        "likelihoods.utils.inv_probit": _both(gj.likelihoods.utils.inv_probit, gt.likelihoods.utils.inv_probit,
                                              (x,)),
    }


def _kernel_cases():
    rng = _rng(3)
    X, Z = rng.rand(4, 2), rng.rand(3, 2)
    kj, kp = gj.kernels.Matern32(lengthscales=[0.7, 1.3]), gt.kernels.Matern32(lengthscales=[0.7, 1.3])
    ivs = (lambda Z: gj.inducing_variables.InducingPoints(Z), lambda Z: gt.inducing_variables.InducingPoints(Z))
    iv = gt.inducing_variables.InducingPoints(Z)
    jiv = gj.inducing_variables.InducingPoints(Z)
    shared = (gj.inducing_variables.FallbackSharedIndependentInducingVariables(jiv),
              gt.inducing_variables.FallbackSharedIndependentInducingVariables(iv))
    separate = (gj.inducing_variables.FallbackSeparateIndependentInducingVariables([jiv, jiv]),
                gt.inducing_variables.FallbackSeparateIndependentInducingVariables([iv, iv]))
    return {
        "Kernel.__call__": _both(lambda a, b: kj(a, b), lambda a, b: kp(a, b), (X, Z), (X, rng.rand(3, 3))),
        "Kernel.__call__ full_cov=False": _both(lambda a: kj(a, full_cov=False), lambda a: kp(a, full_cov=False),
                                                (X,), (X[0],)),
        "InducingPoints.__init__": (lambda: ivs[0](Z).Z.value, lambda: ivs[0](Z[None]),
                                    lambda: ivs[1](Z).Z.value, lambda: ivs[1](Z[None])),
        "InducingPoints.num_inducing": (lambda: np.asarray(jiv.num_inducing), None,
                                        lambda: np.asarray(iv.num_inducing), None),
        "FallbackShared.num_inducing": (lambda: np.asarray(shared[0].num_inducing), None,
                                        lambda: np.asarray(shared[1].num_inducing), None),
        "FallbackSeparate.num_inducing": (lambda: np.asarray(separate[0].num_inducing), None,
                                          lambda: np.asarray(separate[1].num_inducing), None),
    }


def _conditional_cases():
    rng = _rng(4)
    A = rng.randn(M, M)
    Kmm = A @ A.T + M * np.eye(M)
    Lm = np.linalg.cholesky(Kmm)
    Kmn, f, q_sqrt = rng.randn(M, NEW), rng.randn(M, 2), _lower(rng, 2, M, M)
    Knn_diag, Knn = rng.rand(NEW) + 2.0, np.eye(NEW) * 3.0
    cu_j, cu_p = gj.conditionals.util, gt.conditionals.util
    cases = {}
    for name, full, Kn in (("", False, Knn_diag), (" full_cov", True, Knn)):
        cases["base_conditional" + name] = _both(
            lambda a, b, c, d, e, full=full: cu_j.base_conditional(a, b, c, d, full_cov=full, q_sqrt=e),
            lambda a, b, c, d, e, full=full: cu_p.base_conditional(a, b, c, d, full_cov=full, q_sqrt=e),
            (Kmn, Kmm, Kn, f, q_sqrt), (Kmn, Kmm[:-1, :-1], Kn, f, q_sqrt))
        cases["base_conditional_with_lm" + name] = _both(
            lambda a, b, c, d, full=full: cu_j.base_conditional_with_lm(a, b, c, d, full_cov=full, white=True),
            lambda a, b, c, d, full=full: cu_p.base_conditional_with_lm(a, b, c, d, full_cov=full, white=True),
            (Kmn, Lm, Kn, f), (Kmn, Lm, Kn[:-1], f))
    cases["expand_independent_outputs"] = _both(
        lambda v: cu_j.expand_independent_outputs(v, True, True),
        lambda v: cu_p.expand_independent_outputs(v, True, True), (rng.rand(2, 3, 3),), (rng.rand(3, 2),))
    q_mu = rng.randn(M, 2)
    cases["gauss_kl"] = _both(gj.kullback_leiblers.gauss_kl, gt.kullback_leiblers.gauss_kl,
                              (q_mu, q_sqrt, Kmm), (q_mu, q_sqrt[None], Kmm))
    cases["gauss_kl diagonal"] = _both(lambda a, b: gj.kullback_leiblers.gauss_kl(a, b),
                                       lambda a, b: gt.kullback_leiblers.gauss_kl(a, b),
                                       (q_mu, rng.rand(M, 2) + 0.1), (q_mu, rng.rand(M, 3) + 0.1))
    Z = rng.rand(M, D)
    kern = (gj.kernels.SquaredExponential(), gt.kernels.SquaredExponential())
    ivs = (gj.inducing_variables.InducingPoints(Z), gt.inducing_variables.InducingPoints(Z))
    cases["prior_kl"] = _both(lambda a, b: gj.kullback_leiblers.prior_kl(ivs[0], kern[0], a, b, whiten=False),
                              lambda a, b: gt.kullback_leiblers.prior_kl(ivs[1], kern[1], a, b, whiten=False),
                              (q_mu, q_sqrt), (q_mu, q_sqrt[:1, :-1, :-1]))
    return cases


def _likelihood_cases():
    rng = _rng(5)
    X, F, Fv = rng.rand(6, 2), rng.randn(6, 1), rng.rand(6, 1) + 0.1
    Y, Yb, Yc = rng.randn(6, 1), (rng.rand(6, 1) > 0.5) * 1.0, np.floor(rng.rand(6, 1) * 4)
    F3 = rng.randn(5, 1)
    cases = {}
    for lik, y, kwargs in (("Gaussian", Y, {"variance": 0.3}), ("Bernoulli", Yb, {}), ("Poisson", Yc, {}),
                           ("StudentT", Y, {}),
                           ("Ordinal", Yc, {"bin_edges": np.array([-1.0, 0.0, 1.0])})):
        objs = (getattr(gj.likelihoods, lik)(**kwargs), getattr(gt.likelihoods, lik)(**kwargs))
        cases[f"{lik}.log_prob"] = _method(objs, "log_prob", (X, F, y), (X, F3, y))
        # F: [batch..., Q] admits any F of rank 1 or more
        cases[f"{lik}.conditional_mean"] = _method(objs, "conditional_mean", (X, F), (X, F[0, 0]))
        cases[f"{lik}.conditional_variance"] = _method(objs, "conditional_variance", (X, F), (X, F[0, 0]))
        cases[f"{lik}.predict_mean_and_var"] = _method(objs, "predict_mean_and_var", (X, F, Fv), (X, F, Fv[:5]))
        cases[f"{lik}.predict_log_density"] = _method(objs, "predict_log_density", (X, F, Fv, y),
                                                      (X, F, Fv[:5], y))
        cases[f"{lik}.variational_expectations"] = _method(objs, "variational_expectations", (X, F, Fv, y),
                                                           (X, F, Fv[:5], y))
    cases["Ordinal.__init__"] = (lambda: None, lambda: gj.likelihoods.Ordinal(np.zeros((2, 2))),
                                 lambda: None, lambda: gt.likelihoods.Ordinal(np.zeros((2, 2))))
    ordinal = (gj.likelihoods.Ordinal(np.array([-1.0, 1.0])), gt.likelihoods.Ordinal(np.array([-1.0, 1.0])))
    cases["Ordinal._make_phi"] = _method(ordinal, "_make_phi", (F,))
    return cases


def _quadrature_cases():
    rng = _rng(6)
    mean, var = rng.randn(4, 2), rng.rand(4, 2) + 0.1
    gh_j, gh_p = gj.quadrature.gauss_hermite, gt.quadrature.gauss_hermite
    quad = (gj.quadrature.NDiagGHQuadrature(2, 5), gt.quadrature.NDiagGHQuadrature(2, 5))
    fun_j = lambda X: jnp.sum(jnp.sin(X), axis=-1, keepdims=True)  # noqa: E731
    fun_p = lambda X: torch.sum(torch.sin(X), dim=-1, keepdim=True)  # noqa: E731
    zs = [rng.randn(3), rng.randn(4)]
    return {
        "GaussianQuadrature.__call__": _both(lambda m, v: quad[0](fun_j, m, v), lambda m, v: quad[1](fun_p, m, v),
                                             (mean, var), (mean, var[:3])),
        "GaussianQuadrature.logspace": _both(lambda m, v: quad[0].logspace(fun_j, m, v),
                                             lambda m, v: quad[1].logspace(fun_p, m, v), (mean, var),
                                             (mean, var[:, :1])),
        "NDiagGHQuadrature._build_X_W": _both(quad[0]._build_X_W, quad[1]._build_X_W, (mean, var),
                                              (mean, var[:3])),
        "gh_points_and_weights": (lambda: gh_j.gh_points_and_weights(7), None,
                                  lambda: gh_p.gh_points_and_weights(7), None),
        "ndgh_points_and_weights": (lambda: gh_j.ndgh_points_and_weights(2, 3), None,
                                    lambda: gh_p.ndgh_points_and_weights(2, 3), None),
        "list_to_flat_grid": (lambda: gh_j.list_to_flat_grid(zs), lambda: gh_j.list_to_flat_grid([np.eye(2)]),
                              lambda: gh_p.list_to_flat_grid(zs), lambda: gh_p.list_to_flat_grid([np.eye(2)])),
        "reshape_Z_dZ": (lambda: gh_j.reshape_Z_dZ(zs, zs), lambda: gh_j.reshape_Z_dZ(zs, [np.eye(2)]),
                         lambda: gh_p.reshape_Z_dZ(zs, zs), lambda: gh_p.reshape_Z_dZ(zs, [np.eye(2)])),
        "repeat_as_list": (lambda: gh_j.repeat_as_list(zs[0], 3), None, lambda: gh_p.repeat_as_list(zs[0], 3), None),
    }


def _model_cases():
    X, Y, Z, Xnew = _data()
    Xbad = Xnew[:, :1]
    cases = {}
    for cls, extra in (("GPR", {}), ("SGPR", {}), ("GPRFITC", {}),
                       ("CGLB", {"max_cg_iters": 20, "cg_tolerance": 1e-6})):
        objs = _models(cls, **extra)
        cases[f"{cls}.__init__"] = (lambda: None, lambda cls=cls, extra=extra: _models_bad(gj, cls, extra),
                                    lambda: None, lambda cls=cls, extra=extra: _models_bad(gt, cls, extra))
        cases[f"{cls}.predict_f"] = _method(objs, "predict_f", (Xnew,), (Xnew[0],))
        cases[f"{cls}.predict_f full_cov"] = _both(lambda a, objs=objs: objs[0].predict_f(a, full_cov=True),
                                                   lambda a, objs=objs: objs[1].predict_f(a, full_cov=True),
                                                   (Xnew,), (Xnew[0],))
        cases[f"{cls}.predict_y"] = _method(objs, "predict_y", (Xnew,), (Xnew[0],))
        cases[f"{cls}.predict_log_density"] = _both(lambda a, b, objs=objs: objs[0].predict_log_density((a, b)),
                                                    lambda a, b, objs=objs: objs[1].predict_log_density((a, b)),
                                                    (X, Y), jit=cls != "CGLB")
        cases[f"{cls}.training_loss"] = _no_args(objs, "training_loss", jit=cls != "CGLB")
        cases[f"{cls}.maximum_log_likelihood_objective"] = _no_args(objs, "maximum_log_likelihood_objective",
                                                                    jit=cls != "CGLB")
        cases[f"{cls}.log_posterior_density"] = _no_args(objs, "log_posterior_density", jit=cls != "CGLB")
    gpr = _models("GPR")
    cases["GPR.log_marginal_likelihood"] = _no_args(gpr, "log_marginal_likelihood")
    sgpr = _models("SGPR")
    for name in ("elbo", "upper_bound", "compute_qu"):
        cases[f"SGPR.{name}"] = _no_args(sgpr, name)
    cases["SGPR._common_calculation"] = (reference_jit(lambda: tuple(sgpr[0]._common_calculation())), None,
                                         lambda: tuple(sgpr[1]._common_calculation()), None)
    fitc = _models("GPRFITC")
    cases["GPRFITC.common_terms"] = _no_args(fitc, "common_terms")
    cases["GPRFITC.fitc_log_marginal_likelihood"] = _no_args(fitc, "fitc_log_marginal_likelihood")
    svgp = (_svgp(gj), _svgp(gt))
    cases["SVGP.training_loss"] = _both(lambda a, b: svgp[0].training_loss((a, b)),
                                        lambda a, b: svgp[1].training_loss((a, b)), (X, Y), (X, Y[:-1]))
    cases["SVGP.elbo"] = _both(lambda a, b: svgp[0].elbo((a, b)), lambda a, b: svgp[1].elbo((a, b)), (X, Y))
    return cases


def _models_bad(pkg, cls, extra):
    X, Y, Z, _ = _data()
    kernel = pkg.kernels.SquaredExponential()
    if cls == "GPR":
        return pkg.models.GPR((X, Y[:-1]), kernel, noise_variance=0.1)
    return getattr(pkg.models, cls)((X, Y[:-1]), kernel, inducing_variable=Z, noise_variance=0.1, **extra)


def _cglb_cases():
    rng = _rng(7)
    cg_j, cg_p = gj.models.cglb, gt.models.cglb
    n, m = 9, 4
    A, v = rng.randn(m, n) * 0.3, rng.randn(2, n)
    LB = np.linalg.cholesky(np.eye(m) + A @ A.T)
    S = rng.randn(n, n)
    K = S @ S.T + n * np.eye(n)
    precs = (cg_j.NystromPreconditioner(A, LB, 0.5), cg_p.NystromPreconditioner(*_t(A, LB, 0.5)))
    return {
        "NystromPreconditioner.__init__": (lambda: None, lambda: cg_j.NystromPreconditioner(A, LB[:-1, :-1], 0.5),
                                           lambda: None,
                                           lambda: cg_p.NystromPreconditioner(*_t(A, LB[:-1, :-1], 0.5))),
        "NystromPreconditioner.__call__": _both(precs[0], precs[1], (v,), (v[0],)),
        "cglb_conjugate_gradient": _both(
            lambda Kop, b, x0: cg_j.cglb_conjugate_gradient(Kop, b, x0, precs[0], 1e-10, 50, 10),
            lambda Kop, b, x0: cg_p.cglb_conjugate_gradient(Kop, b, x0, precs[1], 1e-10, 50, 10),
            (K, v, np.zeros_like(v)), (K, v, np.zeros((2, n - 1))), jit=False),
        "CGLB.aux_vec": (lambda: _models("CGLB")[0].aux_vec.value, None, lambda: _models("CGLB")[1].aux_vec.value,
                         None),
    }


class _Built:
    """The two packages' objects that ``make(i, *args)`` builds (i = 0 the
    JAX package's, 1 the port's), built at the first read: a posterior with
    a precomputed cache computes it at construction, which every worker
    would otherwise pay while it collects the cases' names."""

    def __init__(self, make, *args):
        self._make, self._args, self._objs = make, args, None

    def __getitem__(self, i):
        if self._objs is None:
            self._objs = [self._make(j, *self._args) for j in (0, 1)]
        return self._objs[i]


def _posterior_cases():
    rng = _rng(8)
    X, Y, Z, Xnew = _data()
    q_mu, q_sqrt = rng.randn(M, 2), _lower(rng, 2, M, M)
    cases = {}
    kern = (gj.kernels.Matern52(), gt.kernels.Matern52())
    ivs = (gj.inducing_variables.InducingPoints(Z), gt.inducing_variables.InducingPoints(Z))

    def independent(i, qm, qs, cache="tensor"):
        cls = (gj, gt)[i].posteriors.IndependentPosteriorSingleOutput
        return cls(kern[i], ivs[i], _as((qm, qs), i)[0], _as((qm, qs), i)[1], whiten=True, precompute_cache=cache)

    def gpr(i, data):
        pkg = (gj, gt)[i]
        return pkg.posteriors.GPRPosterior(kern[i], _as(data, i), pkg.likelihoods.Gaussian(0.2),
                                           pkg.functions.Zero(), precompute_cache="tensor")

    def sgpr(i, data, Zi):
        pkg = (gj, gt)[i]
        return pkg.posteriors.SGPRPosterior(kern[i], _as(data, i), pkg.inducing_variables.InducingPoints(Zi),
                                            pkg.likelihoods.Gaussian(0.2), 1, pkg.functions.Zero(),
                                            precompute_cache="tensor")

    for name, make, ok, bad in (
        ("IndependentPosterior.__init__", independent, (q_mu, q_sqrt), (q_mu, q_sqrt[:1])),
        ("IndependentPosterior.__init__ diagonal", independent, (q_mu, rng.rand(M, 2)), (q_mu, rng.rand(M, 3))),
        ("GPRPosterior.__init__", gpr, ((X, Y),), ((X, Y[:-1]),)),
        ("SGPRPosterior.__init__", sgpr, ((X, Y), Z), ((X, Y), Z[:, :1])),
    ):
        posts = _Built(make, *ok)
        cases[name] = (lambda posts=posts: tuple(posts[0].cache), lambda make=make, bad=bad: make(0, *bad),
                       lambda posts=posts: tuple(posts[1].cache), lambda make=make, bad=bad: make(1, *bad))
        stem = name.split(".")[0] + (" diagonal" if "diagonal" in name else "")
        cases[f"{stem}.predict_f"] = _method(posts, "predict_f", (Xnew,), (Xnew[:, :1],))
        cases[f"{stem}.fused_predict_f full_cov"] = _both(
            lambda a: posts[0].fused_predict_f(a, full_cov=True),
            lambda a: posts[1].fused_predict_f(a, full_cov=True), (Xnew,), (Xnew[None, :, :1],))
    post = _Built(independent, q_mu, q_sqrt)
    cases["BasePosterior._set_qdist"] = (lambda: None, lambda: post[0]._set_qdist(q_mu, q_sqrt[..., None]),
                                         lambda: None,
                                         lambda: post[1]._set_qdist(*_t(q_mu, q_sqrt[..., None])))
    cases["BasePosterior.q_sqrt"] = (lambda: post[0].q_sqrt, None, lambda: post[1].q_sqrt, None)
    return cases


def _as(values, i):
    """numpy values as they are for the JAX package (i = 0), as tensors for the port."""
    if i == 0:
        return values
    return tuple(torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray) else v for v in values)


def _natgrad_cases():
    rng = _rng(9)
    ng_j, ng_p = gj.optimizers.natgrad, gt.optimizers.natgrad
    mu, s_sqrt = rng.randn(M, 2), _lower(rng, 2, M, M)
    cases = {}
    for name in ("natural_to_meanvarsqrt", "meanvarsqrt_to_natural", "natural_to_expectation",
                 "expectation_to_natural", "expectation_to_meanvarsqrt", "meanvarsqrt_to_expectation"):
        fj, fp = getattr(ng_j, name), getattr(ng_p, name)
        a, b = (mu, -0.5 * np.linalg.inv(s_sqrt @ np.swapaxes(s_sqrt, -1, -2))) if name.startswith("natural") else (
            (mu, s_sqrt @ np.swapaxes(s_sqrt, -1, -2) + mu.T[:, :, None] * mu.T[:, None, :])
            if name.startswith("expectation") else (mu, s_sqrt))
        cases[name] = _both(fj, fp, (a, b), (a, b[:1]))
        cases[name + " swap=False"] = _both(lambda x, y, fj=fj: fj(x, y, swap=False),
                                            lambda x, y, fp=fp: fp(x, y, swap=False),
                                            (np.swapaxes(a, 0, 1)[:, :, None], b), (a, b))
    cases["_inverse_lower_triangular"] = _both(ng_j._inverse_lower_triangular, ng_p._inverse_lower_triangular,
                                               (s_sqrt,), (s_sqrt[0],))
    for xi in ("XiNat", "XiSqrtMeanVar"):
        xj, xp = getattr(ng_j, xi)(), getattr(ng_p, xi)()
        for method in ("meanvarsqrt_to_xi", "xi_to_meanvarsqrt", "naturals_to_xi"):
            a, b = (mu, -0.5 * np.linalg.inv(s_sqrt @ np.swapaxes(s_sqrt, -1, -2))) \
                if method == "naturals_to_xi" else (mu, s_sqrt)
            if xi == "XiNat" and method == "xi_to_meanvarsqrt":
                b = -0.5 * np.linalg.inv(s_sqrt @ np.swapaxes(s_sqrt, -1, -2))
            cases[f"{xi}.{method}"] = _both(getattr(xj, method), getattr(xp, method), (a, b), (a, b[:, :-1]))
    return cases


def _natgrad_model_cases():
    X, Y, _, _ = _data()
    cases = {}

    def minimize(i, bad):
        pkg = (gj, gt)[i]
        m = _svgp(pkg, L=2)
        data = _as((X, np.concatenate([Y, Y], axis=1)), i)
        q_sqrt = m.q_sqrt
        if bad:
            q_sqrt = pkg.Parameter(np.stack([np.eye(M)] * 3), transform=pkg.bijectors.triangular())
        pkg.optimizers.NaturalGradient(1.0).minimize(lambda: m.training_loss(data), [(m.q_mu, q_sqrt)])
        return m.q_mu.value, m.q_sqrt.value

    cases["NaturalGradient.minimize"] = (lambda: minimize(0, False), lambda: minimize(0, True),
                                         lambda: minimize(1, False), lambda: minimize(1, True))

    def apply(i, bad):
        pkg = (gj, gt)[i]
        m = _svgp(pkg, L=2)
        grad_mu, grad_sqrt = np.full((M, 2), 0.01), np.zeros((2, M, M))
        if bad:
            grad_mu = np.full((M + 1, 2), 0.01)
        pkg.optimizers.NaturalGradient(0.5)._natgrad_apply_gradients(*_as((grad_mu, grad_sqrt), i), m.q_mu,
                                                                     m.q_sqrt)
        return m.q_mu.value, m.q_sqrt.value

    cases["NaturalGradient._natgrad_apply_gradients"] = (lambda: apply(0, False), lambda: apply(0, True),
                                                         lambda: apply(1, False), lambda: apply(1, True))
    return cases


def _gplvm_cases():
    rng = _rng(10)
    Y = rng.randn(8, 3)
    Xmean, Xvar = rng.randn(8, 2), np.full((8, 2), 0.1)
    objs = [pkg.models.BayesianGPLVM(Y, Xmean, Xvar, pkg.kernels.SquaredExponential(),
                                     inducing_variable=Xmean[:4].copy()) for pkg in (gj, gt)]
    Xn = rng.randn(5, 2)
    return {
        "BayesianGPLVM.predict_f": _method(objs, "predict_f", (Xn,), (Xn[0],)),
        "BayesianGPLVM.predict_y": _method(objs, "predict_y", (Xn,), (Xn[0],)),
    }


CASES = {name: calls for group in (_ops_cases, _density_cases, _kernel_cases, _conditional_cases,
                                   _likelihood_cases, _quadrature_cases, _model_cases, _cglb_cases,
                                   _posterior_cases, _natgrad_cases, _natgrad_model_cases, _gplvm_cases)
         for name, calls in group().items()}


def _leaves(out):
    if out is None:
        return []
    if isinstance(out, (tuple, list)):
        return [leaf for o in out for leaf in _leaves(o)]
    if isinstance(out, torch.Tensor):
        return [out.detach().numpy()]
    if isinstance(out, (jax.Array, np.ndarray, np.number, float, int)):
        return [np.asarray(out)]
    value = getattr(out, "value", None)  # a Parameter
    return _leaves(value) if value is not None else []


@pytest.mark.parametrize("name", sorted(CASES))
def test_both_packages_reject_and_accept_the_same_calls(name, checks_on):
    jax_ok, jax_bad, port_ok, port_bad = CASES[name]
    if jax_bad is not None:
        with pytest.raises(jax_shapes.ShapeError):
            jax_bad()
        with pytest.raises(port_shapes.ShapeError):
            port_bad()
    want, got = _leaves(jax_ok()), _leaves(port_ok())
    assert [w.shape for w in want] == [g.shape for g in got], name
    for w, g in zip(want, got):
        scale = max(float(np.max(np.abs(w))) if w.size else 0.0, 1e-300)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=0.0, atol=1e-8 * scale,
                                   err_msg=name)


# --------------------------------------------------------------------------
# The port's paths with the checks on
# --------------------------------------------------------------------------


def _conditional_inputs(R, full_cov, q_kind, white):
    rng = _rng(11)
    A = rng.randn(M, M)
    Kmm = A @ A.T + M * np.eye(M)
    Kmn = rng.randn(M, NEW)
    Knn = (lambda B: B @ B.T + np.eye(NEW))(rng.randn(NEW, NEW)) if full_cov else rng.rand(NEW) + 3.0
    f = rng.randn(M, R)
    q_sqrt = {None: None, "diagonal": rng.rand(M, R) + 0.1, "full": _lower(rng, R, M, M)}[q_kind]
    return Kmn, Kmm, Knn, f, q_sqrt


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("q_kind", [None, "diagonal", "full"])
@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("R", [1, 3])
def test_base_conditional_meets_its_return_specs(R, full_cov, q_kind, white, checks_on):
    """The port leaves out the JAX package's R = 1 matmul path; its output
    still meets the return specs for R = 1 and R > 1, and the numbers."""
    Kmn, Kmm, Knn, f, q_sqrt = _conditional_inputs(R, full_cov, q_kind, white)
    kwargs = dict(full_cov=full_cov, white=white)
    want = reference_jit(lambda a, b, c, d, e: gj.conditionals.util.base_conditional(a, b, c, d, q_sqrt=e, **kwargs))(
        Kmn, Kmm, Knn, f, q_sqrt)
    got = gt.conditionals.util.base_conditional(*_t(Kmn, Kmm, Knn, f), q_sqrt=None if q_sqrt is None
                                                else torch.from_numpy(q_sqrt), **kwargs)
    assert got[0].shape == (NEW, R)
    assert got[1].shape == ((R, NEW, NEW) if full_cov else (NEW, R))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0.0, atol=1e-10 * float(np.max(np.abs(w))))


def _posterior_pairs():
    X, Y, Z, _ = _data(P=2)
    pairs = {}
    for name, kwargs in (("SVGP L=1", {}), ("SVGP L=2 q_diag", {"L": 2, "q_diag": True}),
                         ("SVGP L=2 unwhitened", {"L": 2, "whiten": False})):
        pairs[name] = tuple(_svgp(pkg, **kwargs) for pkg in (gj, gt))
    pairs["GPR P=2"] = tuple(_models("GPR", P=2))
    pairs["SGPR P=2"] = tuple(_models("SGPR", P=2))
    return pairs


POSTERIORS = _posterior_pairs()


@pytest.mark.parametrize("name", sorted(POSTERIORS))
def test_the_posterior_caches_have_the_jax_packages_shapes(name, checks_on):
    """The cached routes' specs read the cache (alpha [M, L], Qinv
    [L, M, M]; the GPR's and SGPR's own terms): each entry of the port's
    cache has the shape of the JAX package's, and the cached route agrees."""
    jm, pm = POSTERIORS[name]
    jpost, ppost = jm.posterior(), pm.posterior()
    assert [tuple(np.shape(c)) for c in jpost.cache] == [tuple(c.shape) for c in ppost.cache]
    Xnew = _data()[3]
    for full_cov in (False, True):
        want = jpost.predict_f(Xnew, full_cov=full_cov)
        got = ppost.predict_f(torch.from_numpy(Xnew), full_cov=full_cov)
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=0.0,
                                       atol=1e-8 * float(np.max(np.abs(w))))


def _slices_once():
    """Slices 1-6 of the port on small data: the SVGP (Gaussian; one latent
    GP and two, diagonal and unwhitened) with its objective, gradients,
    trainer steps and requests; the Bernoulli SVGP's natural-gradient steps
    (fused trainer, ``minimize`` with XiSqrtMeanVar) and requests; GPR with
    two L-BFGS iterations and its posterior; SGPR, GPRFITC and the
    matrix-free CGLB with their gradients and requests; the Poisson and
    Ordinal expectations through Gauss-Hermite quadrature."""
    from gpflow_tpu_torch.optimizers import NaturalGradient, Scipy
    from gpflow_tpu_torch.optimizers.natgrad import XiSqrtMeanVar
    from gpflow_tpu_torch.parallel import DataParallelTrainer

    torch.manual_seed(0)
    X, Y, Z, Xnew = _data(P=2)
    Xt, Yt, Xn = _t(X, Y[:, :1], Xnew)
    Y2 = torch.from_numpy(Y)
    Yb = (Yt > 0).to(Yt.dtype)
    out = []

    def value_and_grads(loss, model):
        return [loss.detach()] + list(torch.autograd.grad(loss, [p.unconstrained for p in
                                                                 model.trainable_variables]))

    for kwargs, y in (({}, Yt), ({"L": 2, "q_diag": True}, Y2), ({"L": 2, "whiten": False}, Y2)):
        m = _svgp(gt, **kwargs)
        out += value_and_grads(m.training_loss((Xt, y)), m)
        with torch.no_grad():
            post = m.posterior()
            out += list(post.predict_f(Xn)) + [post.predict_mean(Xn)]
            out += list(m.predict_f(Xn, full_cov=True)) + list(m.predict_f(Xn, full_output_cov=True))
            out += list(m.predict_y(Xn)) + [m.predict_log_density((Xt, y))]
    trainer = DataParallelTrainer(_svgp(gt))
    out.append(trainer.run_steps((Xt[None].repeat(2, 1, 1), Yt[None].repeat(2, 1, 1))))
    bern = _svgp(gt, likelihood="Bernoulli")
    trainer = DataParallelTrainer(bern, natgrad_gamma=0.5, natgrad_fused=True)
    out.append(trainer.run_steps((Xt[None].repeat(2, 1, 1), Yb[None].repeat(2, 1, 1))))
    NaturalGradient(0.1, XiSqrtMeanVar()).minimize(lambda: bern.training_loss((Xt, Yb)), [(bern.q_mu, bern.q_sqrt)])
    out += [bern.q_mu.value.detach(), bern.q_sqrt.value.detach()]
    with torch.no_grad():
        out += list(bern.predict_y(Xn)) + [bern.predict_log_density((Xt, Yb))]
    gpr = gt.models.GPR((X, Y), gt.kernels.Matern12(lengthscales=[0.8, 1.1]), noise_variance=0.1)
    out += value_and_grads(gpr.training_loss(), gpr)
    Scipy().minimize(gpr.training_loss, gpr.trainable_variables, options={"maxiter": 2})
    with torch.no_grad():
        out += list(gpr.posterior().predict_f(Xn, full_cov=True)) + list(gpr.predict_y(Xn))
        out.append(gpr.predict_log_density((torch.from_numpy(X), Y2)))
    for cls, extra in (("SGPR", {}), ("GPRFITC", {}), ("CGLB", {"matrix_free_chunk": 5, "cg_tolerance": 1e-8})):
        m = getattr(gt.models, cls)((X, Y), gt.kernels.Matern52(lengthscales=[0.8, 1.1]), inducing_variable=Z,
                                    noise_variance=0.1, **extra)
        out += value_and_grads(m.training_loss(), m)
        with torch.no_grad():
            out += list(m.predict_f(Xn)) + list(m.predict_y(Xn))
            if cls == "SGPR":
                out += [m.upper_bound()] + list(m.compute_qu()) + list(m.posterior().predict_f(Xn, full_cov=True))
    rng = _rng(12)
    F, Fv = _t(rng.randn(6, 1), rng.rand(6, 1) + 0.1)
    for lik, y in ((gt.likelihoods.Poisson(), np.floor(rng.rand(6, 1) * 4)),
                   (gt.likelihoods.Ordinal(np.array([-1.0, 0.0, 1.0])), np.floor(rng.rand(6, 1) * 4))):
        out += [lik.variational_expectations(Xt[:6], F, Fv, torch.from_numpy(y))]
        out += list(lik.predict_mean_and_var(Xt[:6], F, Fv))
    return out


def test_slices_1_to_6_run_with_the_checks_on_and_give_the_same_numbers():
    previous = port_shapes.get_enable_check_shapes()
    try:
        port_shapes.set_enable_check_shapes(False)
        off = _slices_once()
        port_shapes.set_enable_check_shapes(True)
        on = _slices_once()
    finally:
        port_shapes.set_enable_check_shapes(previous)
    assert len(on) == len(off)
    for i, (a, b) in enumerate(zip(on, off)):
        assert a.shape == b.shape and torch.equal(a, b), i


def test_the_artifact_exported_with_the_checks_on_serves_every_batch(tmp_path, checks_on):
    """A symbolic batch exported with the checks on is not specialised by
    them: the loaded program serves 50, 7 and 1 rows as the live posterior."""
    from gpflow_tpu_torch.utilities import export_serving, load_serving

    model = _svgp(gt)
    export_serving(model, str(tmp_path / "checked"), input_dim=D, methods=("predict_f", "predict_y", "predict_mean"))
    served = load_serving(str(tmp_path / "checked"))
    post = model.posterior()
    rng = _rng(13)
    for n in (50, 7, 1):
        Xn = torch.from_numpy(rng.rand(n, D) * 2.0)
        with torch.no_grad():
            want = post.predict_f(Xn)
        got = served.predict_f(Xn)
        assert [tuple(g.shape) for g in got] == [(n, 1), (n, 1)]
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0.0, atol=1e-12)
        assert served.predict_mean(Xn).shape == (n, 1)


def test_a_malformed_call_fails_before_any_kernel_matrix(monkeypatch, checks_on):
    """With the checks on, a request whose D is not Z's fails the kernel's
    contract on the cached and the fused route, and a q_sqrt of rank 4 fails
    the KL's, before the kernel computes any matrix (on the card, before
    any launch of K1)."""
    model = _svgp(gt)
    post = model.posterior()
    calls = []
    K = model.kernel.K
    monkeypatch.setattr(model.kernel, "K", lambda *a, **k: calls.append("K") or K(*a, **k))
    bad = torch.from_numpy(_rng(14).rand(4, D + 1))
    q_sqrt = model.q_sqrt.value.detach()[None]
    for call in (lambda: post.predict_f(bad), lambda: model.predict_f(bad),
                 lambda: gt.kullback_leiblers.prior_kl(model.inducing_variable, model.kernel, model.q_mu.value,
                                                      q_sqrt, whiten=False)):
        with pytest.raises(port_shapes.ShapeError):
            call()
    assert calls == []
    model.predict_f(bad[:, :D])
    assert calls  # the valid request does reach the kernel


# --- the decorated sites, counted as the JAX package's coverage test counts them ---

# The areas of ``tests/gpflow_tpu/utilities/test_contract_coverage.py:22-36``,
# each globbed under both packages' roots.
CONTRACT_AREAS = {
    "posteriors": ["posteriors.py"],
    "models": ["models/*.py"],
    "kernels": ["kernels/*.py", "kernels/multioutput/*.py"],
    "optimizers": ["optimizers/*.py"],
    "utilities": ["utilities/*.py", "bijectors.py"],
    "inducing_variables": ["inducing_variables/**/*.py"],
    "likelihoods": ["likelihoods/*.py"],
    "conditionals": ["conditionals/**/*.py"],
    "expectations": ["expectations/*.py"],
    "all": ["**/*.py"],
}
_DECORATED = re.compile(r"^\s*@_?(?:check_shapes|inherit_check_shapes)\b", re.MULTILINE)


def _sites(package, patterns):
    root = pathlib.Path(importlib.import_module(package).__file__).parent
    return sum(
        len(_DECORATED.findall(path.read_text()))
        for pattern in patterns
        for path in sorted(root.glob(pattern))
        if path.name != "shapes.py" and "_build" not in path.parts
    )


@pytest.mark.parametrize("area", sorted(CONTRACT_AREAS))
def test_the_port_decorates_as_many_sites_as_the_jax_package(area):
    """The JAX package's area floors, counted over the port: the port's
    decorated sites in each area at least the JAX package's own count
    (posteriors 39, 429 in all, since the q-distribution classes came)."""
    jax_sites = _sites("gpflow_tpu", CONTRACT_AREAS[area])
    assert jax_sites > 0
    assert _sites("gpflow_tpu_torch", CONTRACT_AREAS[area]) >= jax_sites
