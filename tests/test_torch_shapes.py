"""The shape contracts of gpflow_tpu_torch (``utilities.shapes``, the port's
own copy of ``gpflow_tpu/utilities/shapes.py``): the same specs accept and
reject the same shapes in both packages; checks are off by default and
switched by ``set_enable_check_shapes`` or GPFLOW_TPU_TORCH_CHECK_SHAPES;
they read ``.shape`` only (meta tensors, which hold no values, pass); each
decorated entry point of the VGP slice raises ``ShapeError`` on a wrong
shape; and the whole slice runs once with the checks on, giving the same
numbers as with them off."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch as gt
from gpflow_tpu.utilities import shapes as jax_shapes
from gpflow_tpu_torch import config, functions, kernels, likelihoods, models, posteriors
from gpflow_tpu_torch.conditionals import conditional
from gpflow_tpu_torch.optimizers import NaturalGradient, Scipy
from gpflow_tpu_torch.utilities import (
    ShapeError,
    check_shape,
    check_shapes,
    evaluate_parameter_or_function,
    get_enable_check_shapes,
    inherit_check_shapes,
    register_get_shape,
    set_enable_check_shapes,
)
from gpflow_tpu_torch.utilities import shapes as port_shapes
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def checks_on():
    previous = get_enable_check_shapes()
    set_enable_check_shapes(True)
    try:
        yield
    finally:
        set_enable_check_shapes(previous)


# (specs, arguments as shapes, whether the call passes)
SPEC_CASES = [
    (("X: [batch..., N, D]", "X2: [batch2..., N2, D]", "return: [batch..., N, batch2..., N2]"),
     {"X": (2, 5, 3), "X2": (4, 3), "ret": (2, 5, 4)}, True),
    (("X: [batch..., N, D]", "X2: [batch2..., N2, D]"), {"X": (5, 3), "X2": (4, 2), "ret": ()}, False),
    (("X: [N, D]", "return: [N] if not full_cov", "return: [N, N] if full_cov"),
     {"X": (5, 2), "full_cov": True, "ret": (5, 5)}, True),
    (("X: [N, D]", "return: [N] if not full_cov", "return: [N, N] if full_cov"),
     {"X": (5, 2), "full_cov": False, "ret": (5, 5)}, False),
    (("f: [M, R]", "q_sqrt: [M, R] | [R, M, M]"), {"f": (6, 2), "q_sqrt": (2, 6, 6), "ret": ()}, True),
    (("f: [M, R]", "q_sqrt: [M, R] | [R, M, M]"), {"f": (6, 2), "q_sqrt": (3, 6, 6), "ret": ()}, False),
    (("X: [M, D, maybe_R...]",), {"X": (6, 2, 1), "ret": ()}, True),
    (("c: [broadcast Q]", "return: [N, Q]"), {"c": (), "ret": (4, 3)}, True),
    # broadcast dims are not pinned
    (("var: [broadcast n_active_dims]", "X: [N, n_active_dims]"), {"var": (3,), "X": (5, 2), "ret": ()}, True),
    (("var: [n_active_dims]", "X: [N, n_active_dims]"), {"var": (3,), "X": (5, 2), "ret": ()}, False),
    (("X: [batch..., N, D]", "return: [batch..., N, 1]"), {"X": (2, 3, 4), "ret": (3, 3, 1)}, False),
    (("data[0]: [N, D]", "data[1]: [N, P]"), {"data": ((5, 2), (5, 1)), "ret": ()}, True),
    (("data[0]: [N, D]", "data[1]: [N, P]"), {"data": ((5, 2), (4, 1)), "ret": ()}, False),
    (("return: []",), {"ret": (1,)}, False),
    (("xs[all]: [N, 2]",), {"xs": [(3, 2), (3, 2)], "ret": ()}, True),
    (("xs[all]: [N, 2]",), {"xs": [(3, 2), (4, 2)], "ret": ()}, False),
]


def _call(module, specs, case, make):
    names = [s.split(":")[0].split("[")[0] for s in specs if not s.startswith("return")]
    args = {n: case.get(n) for n in dict.fromkeys(names)}
    flags = {k: v for k, v in case.items() if isinstance(v, bool)}

    def shaped(v):
        if isinstance(v, tuple) and v and isinstance(v[0], tuple):
            return tuple(make(s) for s in v)
        if isinstance(v, list):
            return [make(s) for s in v]
        return make(v)

    params = list(dict.fromkeys(names)) + list(flags)
    src = f"def fn({', '.join(params)}):\n    return RET\n"
    scope = {"RET": make(case["ret"])}
    exec(src, scope)  # a function of exactly the named arguments
    fn = module.check_shapes(*specs)(scope["fn"])
    return fn(**{n: shaped(v) for n, v in args.items()}, **flags)


@pytest.mark.parametrize("specs,case,passes", SPEC_CASES)
def test_specs_accept_and_reject_as_the_jax_package_does(specs, case, passes, checks_on):
    previous = jax_shapes.get_enable_check_shapes()
    jax_shapes.set_enable_check_shapes(True)
    try:
        outcomes = []
        for module, make in ((jax_shapes, np.zeros), (port_shapes, lambda s: torch.zeros(s, device="meta"))):
            try:
                _call(module, specs, case, make)
                outcomes.append(True)
            except module.ShapeError:
                outcomes.append(False)
        assert outcomes == [passes, passes]
    finally:
        jax_shapes.set_enable_check_shapes(previous)


def test_checks_are_off_by_default_and_follow_the_environment():
    for value, want in (("0", False), ("", False), ("false", False), ("No", False), ("off", False), ("1", True),
                        ("true", True)):
        assert port_shapes._env_enabled(value) is want
    assert port_shapes._state["enabled"] is False or os.environ.get("GPFLOW_TPU_TORCH_CHECK_SHAPES")
    # the variable is read when the module is first imported
    code = ("from gpflow_tpu_torch.utilities import get_enable_check_shapes as g, set_enable_check_shapes as s\n"
            "print(g()); s(False); print(g())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, GPFLOW_TPU_TORCH_CHECK_SHAPES="1"),
                         capture_output=True, text=True, timeout=30)  # 3.4-6.8 s in the tier-1 run
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["True", "False"]


def test_off_means_no_check_and_on_reads_shapes_only():
    previous = get_enable_check_shapes()
    set_enable_check_shapes(False)
    try:
        f = check_shapes("X: [N, 2]", "return: [N]")(lambda X: X)
        f(torch.zeros(3, 5))  # not checked
        assert check_shape(torch.zeros(3), "[N, D]") is not None
        set_enable_check_shapes(True)
        with pytest.raises(ShapeError):
            f(torch.zeros(3, 5))
        with pytest.raises(ShapeError):
            check_shape(torch.zeros(3), "[N, D]")
        # meta tensors carry a shape and no values: a contract never reads one
        meta = torch.zeros(4, 2, device="meta")
        assert check_shapes("X: [N, 2]", "return: [N, 2]")(lambda X: X)(meta) is meta
        # the port's Parameter, numpy arrays and Python scalars have shapes
        check_shapes("a: [3]", "b: [2, 2]", "c: []")(lambda a, b, c: None)(gt.Parameter(np.ones(3)), np.eye(2), 1.5)
    finally:
        set_enable_check_shapes(previous)


def test_register_get_shape_and_inherited_contracts(checks_on):
    class Box:
        pass

    register_get_shape(Box)(lambda b: (7, 2))
    with pytest.raises(ShapeError):
        check_shapes("b: [N, 3]")(lambda b: None)(Box())

    class Wrong(kernels.Kernel):
        @inherit_check_shapes
        def K(self, X, X2=None):
            return torch.zeros(X.shape[0] + 1, X.shape[0])

        @inherit_check_shapes
        def K_diag(self, X):
            return torch.zeros(X.shape[0])

    with pytest.raises(ShapeError):
        Wrong().K(torch.zeros(3, 2))
    assert Wrong().K_diag(torch.zeros(3, 2)).shape == (3,)
    iv = gt.inducing_variables.InducingPoints(np.zeros((5, 2)))
    assert iv.shape == (5, 2, 1)


def _vgp(N=12, D=2, P=1, likelihood=None):
    rng = np.random.RandomState(0)
    X, Y = rng.rand(N, D), rng.randn(N, P)
    k = kernels.SquaredExponential() + kernels.Linear()
    return models.VGP((X, Y), k, likelihood or likelihoods.Gaussian(0.1), mean_function=functions.Constant()), X, Y


def _entry_points():
    """(name, call that hands a wrongly shaped argument) for each decorated
    entry point of the slice."""
    rng = np.random.RandomState(1)
    X, X3 = torch.from_numpy(rng.rand(6, 2)), torch.from_numpy(rng.rand(6, 3))
    vgp, Xd, Yd = _vgp()
    svgp = models.SVGP_deprecated(kernels.Matern52(), likelihoods.Gaussian(), np.zeros((4, 2)))
    return [
        ("Kernel.forward", lambda: kernels.SquaredExponential()(X, X3)),
        ("Sum term K", lambda: kernels.Linear().K(X, X3)),
        ("Stationary.__init__", lambda: kernels.Matern12(variance=np.ones(2))),
        ("Linear kernel.__init__", lambda: kernels.Linear(variance=np.ones((2, 2)))),
        ("Static.__init__", lambda: kernels.White(variance=np.ones(2))),
        ("Polynomial kernel.__init__", lambda: kernels.Polynomial(offset=np.ones(2))),
        ("Periodic.__init__", lambda: kernels.Periodic(kernels.SquaredExponential(), period=np.ones((2, 2)))),
        ("Cosine.K_d", lambda: kernels.Cosine().K_d(torch.zeros(3))),
        ("Function.__init__ Constant", lambda: functions.Constant(c=np.ones((2, 2)))),
        ("Function.__init__ Linear", lambda: functions.Linear(A=np.ones((2, 2, 2)))),
        ("Function.__init__ Polynomial", lambda: functions.Polynomial(2, 2, w=np.ones((2, 2, 2)))),
        ("Function.forward", lambda: functions.Constant()(torch.zeros(3))),
        ("evaluate_parameter_or_function", lambda: evaluate_parameter_or_function(functions.Zero(), torch.zeros(3))),
        ("Gaussian.variance_at", lambda: likelihoods.Gaussian().variance_at(torch.zeros(3))),
        ("conditional dense", lambda: conditional(X, X, kernels.Matern52(), torch.zeros(5, 1))),
        ("conditional sparse", lambda: conditional(
            X, gt.inducing_variables.InducingPoints(np.zeros((4, 2))), kernels.Matern52(), torch.zeros(4, 1),
            q_sqrt=torch.eye(3)[None])),
        ("VGPPosterior.__init__", lambda: posteriors.VGPPosterior(
            kernels.Matern52(), X, torch.zeros(5, 1), torch.eye(6)[None], precompute_cache=None)),
        ("VGP.__init__", lambda: models.VGP((Xd, Yd[:-1]), kernels.Matern52(), likelihoods.Gaussian())),
        ("VGPOpperArchambeau.__init__", lambda: models.VGPOpperArchambeau(
            (Xd, Yd[:-1]), kernels.Matern52(), likelihoods.Gaussian())),
        ("VGP.predict_f", lambda: vgp.predict_f(torch.zeros(3))),
        ("update_vgp_data", lambda: models.update_vgp_data(vgp, (Xd, Yd[:-2]))),
        ("SVGP_deprecated.__init__", lambda: models.SVGP_deprecated(
            kernels.Matern52(), likelihoods.Gaussian(), np.zeros((4, 2)), q_mu=np.zeros((4, 1)),
            q_sqrt=np.stack([np.eye(4)] * 2))),
        ("SVGP_deprecated.predict_f", lambda: svgp.predict_f(torch.zeros(3))),
        ("training_loss", lambda: models.training_loss(svgp, (torch.zeros(5, 2), torch.zeros(4, 1)))),
        ("training_loss_closure", lambda: models.training_loss_closure(vgp, (torch.zeros(5, 2), torch.zeros(4, 1)))),
        ("maximum_log_likelihood_objective", lambda: models.maximum_log_likelihood_objective(
            vgp, (torch.zeros(5, 2), torch.zeros(4, 1)))),
    ]


@pytest.mark.parametrize("name", [n for n, _ in _entry_points()])
def test_each_entry_point_raises_shape_error(name, checks_on):
    fn = dict(_entry_points())[name]
    with pytest.raises(ShapeError):
        fn()


def _slice_once():
    """The whole VGP slice on small data: the objectives with their
    gradients, a natural-gradient step, two L-BFGS iterations, the
    posterior and its requests, update_vgp_data, the Opper-Archambeau VGP,
    SVGP_deprecated and SVGP, a Function-noise SGPR and the conditional."""
    torch.manual_seed(0)
    rng = np.random.RandomState(2)
    out = []
    vgp, X, Y = _vgp(N=10, likelihood=likelihoods.Bernoulli())
    Yc = (Y > 0).astype(float)
    vgp = models.VGP((X, Yc), kernels.SquaredExponential() + kernels.Linear(), likelihoods.Bernoulli(),
                     mean_function=functions.Constant())
    Xnew = torch.from_numpy(rng.rand(5, 2))
    out.append(vgp.training_loss().detach())
    out += torch.autograd.grad(vgp.training_loss(), [p.unconstrained for p in vgp.trainable_variables])
    NaturalGradient(1.0).minimize(vgp.training_loss, [(vgp.q_mu, vgp.q_sqrt)])
    Scipy().minimize(models.training_loss_closure(vgp, (X, Yc)), vgp.trainable_variables, options={"maxiter": 2})
    with torch.no_grad():
        post = vgp.posterior()
        out += list(post.predict_f(Xnew)) + list(post.predict_f(Xnew, full_cov=True))
        out += list(vgp.predict_f(Xnew)) + list(vgp.predict_y(Xnew))
        out.append(vgp.predict_log_density((torch.from_numpy(X), torch.from_numpy(Yc))))
    models.update_vgp_data(vgp, (np.concatenate([X, rng.rand(3, 2)]), np.concatenate([Yc, np.ones((3, 1))])))
    out.append(vgp.elbo().detach())
    oa = models.VGPOpperArchambeau((X, Y), kernels.Periodic(kernels.Matern32()) * kernels.Constant(),
                                   likelihoods.Gaussian(scale=0.3), mean_function=functions.Linear(A=np.ones((2, 1))))
    out.append(oa.elbo().detach())
    out += torch.autograd.grad(oa.training_loss(), [p.unconstrained for p in oa.trainable_variables])
    with torch.no_grad():
        out += list(oa.predict_f(Xnew, full_cov=True))
    for cls in ("SVGP_deprecated", "SVGP"):
        m = getattr(models, cls)(kernels.Cosine() + kernels.White(), likelihoods.Gaussian(), X[:4].copy(),
                                 mean_function=functions.Polynomial(2, 2), num_data=10)
        out.append(m.training_loss((torch.from_numpy(X), torch.from_numpy(Y))).detach())
        with torch.no_grad():
            out += list(m.predict_f(Xnew))
    sgpr = models.SGPR((X, Y), kernels.RBF(), X[:3].copy(),
                       likelihood=likelihoods.Gaussian(functions.Constant(np.array([0.2]))))
    out.append(sgpr.training_loss().detach())
    with torch.no_grad():
        out += list(conditional(Xnew, torch.from_numpy(X), kernels.Matern52(), torch.from_numpy(Y),
                                q_sqrt=torch.from_numpy(np.ones((10, 1))), full_cov=True))
    return out


def test_the_slice_runs_with_checks_on_and_gives_the_same_numbers():
    previous = get_enable_check_shapes()
    try:
        set_enable_check_shapes(False)
        off = _slice_once()
        set_enable_check_shapes(True)
        on = _slice_once()
    finally:
        set_enable_check_shapes(previous)
    assert len(on) == len(off)
    for a, b in zip(on, off):
        assert a.shape == b.shape and torch.equal(a, b)


def test_the_jax_package_keeps_its_own_switch():
    assert jax_shapes is not port_shapes and gpflow_tpu.utilities.shapes is jax_shapes
    port_before, jax_before = get_enable_check_shapes(), jax_shapes.get_enable_check_shapes()
    try:
        set_enable_check_shapes(not port_before)
        assert jax_shapes.get_enable_check_shapes() is jax_before
        jax_shapes.set_enable_check_shapes(not jax_before)
        assert get_enable_check_shapes() is (not port_before)
    finally:
        set_enable_check_shapes(port_before)
        jax_shapes.set_enable_check_shapes(jax_before)
