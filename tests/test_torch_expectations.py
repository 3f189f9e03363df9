"""The psi statistics (``expectations``), ``probability_distributions`` and
``uncertain_conditional`` of gpflow_tpu_torch against gpflow_tpu, on the CPU
in float64, on the same seeded numpy inputs. Every one of the 35 functions
registered with ``dispatch.expectation`` and the two registered with
``dispatch.quadrature_expectation`` (three routes: a Gaussian, a
DiagonalGaussian over separate dimensions, a MarkovGaussian) is reached by
at least one case, and each case agrees with the JAX package's
``expectation`` to 1e-10 relative to the largest entry; the gradients of
psi1 and psi2 with respect to the input moments, Z and the kernel's
parameters likewise. The JAX side runs under ``jax.jit``."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu_torch import config
from gpflow_tpu_torch.expectations import dispatch, expectation, quadrature_expectation
from gpflow_tpu_torch.probability_distributions import DiagonalGaussian, Gaussian, MarkovGaussian
from gpflow_tpu_torch.utilities import parameter_dict, set_enable_check_shapes
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
N, D, M, Q = 5, 2, 4, 3
NGHP = 6  # quadrature points a dimension where a case falls back to quadrature

rng = np.random.RandomState(5)
XMU = rng.randn(N, D)
XVAR = 0.05 + 0.1 * rng.rand(N, D)
_a = 0.2 * rng.randn(N, D, D)
XCOV = np.einsum("nij,nkj->nik", _a, _a) + 0.08 * np.eye(D)
# a MarkovGaussian over N + 1 steps: marginal covariances and the
# cross-covariances of consecutive steps from one joint covariance
_joint = 0.15 * rng.randn((N + 1) * D, (N + 1) * D)
_joint = _joint @ _joint.T + 0.1 * np.eye((N + 1) * D)
MARKOV_MU = rng.randn(N + 1, D)
MARKOV_COV = np.stack([
    np.stack([_joint[i * D:(i + 1) * D, i * D:(i + 1) * D] for i in range(N + 1)]),
    np.stack([_joint[i * D:(i + 1) * D, (i + 1) * D:(i + 2) * D] if i < N else np.zeros((D, D))
              for i in range(N + 1)]),
])
Z = rng.randn(M, D)
A = rng.randn(D, Q)
B = rng.randn(Q)
C = rng.randn(Q)


def _close(got, want, rtol=RTOL):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _p(pkg, kind, mu=None, cov=None):
    """The input distribution of ``kind`` in ``pkg``, from numpy arrays (or
    from the tensors ``mu``, ``cov`` where given)."""
    pd = pkg.probability_distributions
    arrays = {"gauss": (XMU, XCOV), "diag": (XMU, XVAR), "markov": (MARKOV_MU, MARKOV_COV)}[kind]
    if mu is None:
        mu, cov = (a.copy() if pkg is gpflow_tpu else torch.from_numpy(a.copy()) for a in arrays)
    cls = {"gauss": pd.Gaussian, "diag": pd.DiagonalGaussian, "markov": pd.MarkovGaussian}[kind]
    return cls(mu, cov)


def _se(pkg, ard=False, **kwargs):
    return pkg.kernels.SquaredExponential(variance=1.3, lengthscales=[0.7, 1.1] if ard else 0.8, **kwargs)


def _lin(pkg, ard=False, **kwargs):
    return pkg.kernels.Linear(variance=[0.6, 1.2] if ard else 0.9, **kwargs)


def _iv(pkg, z=Z):
    return pkg.inducing_variables.InducingPoints(z.copy())


# Each case builds, in a package, (distribution kind, obj1, obj2, nghp,
# quadrature?): psi2's analytic forms ask the two kernels and inducing
# variables to be one object, so a case makes each once.
def _psi(kernel_fn, order):
    def case(pkg):
        k, iv = kernel_fn(pkg), _iv(pkg)
        return {0: (k, None), 1: ((k, iv), None), 2: ((k, iv), (k, iv))}[order]
    return case


def _sum(pkg):
    return _se(pkg, ard=True) + _lin(pkg)


def _means(pkg):
    f = pkg.functions
    return {"linear": f.Linear(A.copy(), B.copy()), "constant": f.Constant(C.copy()), "identity": f.Identity(D)}


def _two_means(a, b):
    def case(pkg):
        means = _means(pkg)
        return means[a], None if b is None else means[b]
    return case


def _mean_and_kernel(mean, kernel_fn, mean_first=True):
    def case(pkg):
        m, k, iv = _means(pkg)[mean], kernel_fn(pkg), _iv(pkg)
        return (m, (k, iv)) if mean_first else ((k, iv), m)
    return case


def _product(order):
    def case(pkg):
        k = _se(pkg, active_dims=[0]) * pkg.kernels.SquaredExponential(variance=0.7, lengthscales=1.4,
                                                                        active_dims=[1])
        iv = _iv(pkg)
        return {0: (k, None), 1: ((k, iv), None), 2: ((k, iv), (k, iv))}[order]
    return case


def _cross(se_first):
    def case(pkg):
        ks, kl, iv = _se(pkg), _lin(pkg), _iv(pkg)
        return ((ks, iv), (kl, iv)) if se_first else ((kl, iv), (ks, iv))
    return case


def _separate_dims(pkg):
    iv = _iv(pkg)
    return (_se(pkg, active_dims=[0]), iv), (_lin(pkg, active_dims=[1]), iv)


def _two_sums(pkg):
    iv = _iv(pkg)
    return (_sum(pkg), iv), (_lin(pkg) + pkg.kernels.SquaredExponential(lengthscales=1.3), iv)


def _markov_second(pkg):
    return None, (_se(pkg), _iv(pkg))


# name: (kind, the function that makes obj1 and obj2, nghp, through quadrature_expectation)
CASES = {
    "sqe psi0": ("gauss", _psi(_se, 0), None, False),
    "sqe psi1": ("gauss", _psi(lambda pkg: _se(pkg, ard=True), 1), None, False),
    "sqe psi2": ("gauss", _psi(_se, 2), None, False),
    "sqe psi2 diagonal ard": ("diag", _psi(lambda pkg: _se(pkg, ard=True), 2), None, False),
    "sqe psi2 separate dims": ("diag", lambda pkg: (lambda iv: ((_se(pkg, active_dims=[0]), iv),
                                                                (_se(pkg, active_dims=[1]), iv)))(_iv(pkg)),
                               None, False),
    "sqe exKxz": ("gauss", _mean_and_kernel("identity", _se), None, False),
    "sqe markov exKxz": ("markov", _mean_and_kernel("identity", lambda pkg: _se(pkg, ard=True)), None, False),
    "linear psi0": ("gauss", _psi(lambda pkg: _lin(pkg, ard=True), 0), None, False),
    "linear psi1": ("gauss", _psi(_lin, 1), None, False),
    "linear psi2": ("gauss", _psi(lambda pkg: _lin(pkg, ard=True), 2), None, False),
    "linear psi2 diagonal": ("diag", _psi(_lin, 2), None, False),
    "linear kernel times identity": ("gauss", _mean_and_kernel("identity", _lin, mean_first=False), None, False),
    "linear markov kernel times identity": ("markov", _mean_and_kernel("identity", _lin, mean_first=False),
                                            None, False),
    "identity times linear kernel": ("gauss", _mean_and_kernel("identity", _lin), None, False),
    "identity times linear kernel markov": ("markov", _mean_and_kernel("identity", _lin), None, False),
    "mean linear": ("gauss", _two_means("linear", None), None, False),
    "mean constant": ("gauss", _two_means("constant", None), None, False),
    "mean constant constant": ("gauss", _two_means("constant", "constant"), None, False),
    "mean constant linear": ("gauss", _two_means("constant", "linear"), None, False),
    "mean linear constant": ("gauss", _two_means("linear", "constant"), None, False),
    "mean identity identity": ("gauss", _two_means("identity", "identity"), None, False),
    "mean identity linear": ("gauss", _two_means("identity", "linear"), None, False),
    "mean linear identity": ("gauss", _two_means("linear", "identity"), None, False),
    "mean linear linear": ("gauss", _two_means("linear", "linear"), None, False),
    "sqe kernel times linear mean": ("gauss", _mean_and_kernel("linear", _se, mean_first=False), None, False),
    "sqe kernel times mean markov": ("markov", _mean_and_kernel("identity", _se, mean_first=False), NGHP, False),
    "constant mean times sqe": ("gauss", _mean_and_kernel("constant", _se), None, False),
    "linear mean times sqe": ("gauss", _mean_and_kernel("linear", lambda pkg: _se(pkg, ard=True)), None, False),
    "identity times matern52, by quadrature": ("gauss", _mean_and_kernel(
        "identity", lambda pkg: pkg.kernels.Matern52(lengthscales=0.9)), NGHP, False),
    "diagonal linear psi1": ("diag", _psi(_lin, 1), None, False),
    "diagonal sqe exKxz": ("diag", _mean_and_kernel("identity", _se), None, False),
    "markov sqe psi1": ("markov", _psi(_se, 1), None, False),
    "markov sqe psi1 of the next step": ("markov", _markov_second, None, False),
    "markov sqe psi2 across steps, by quadrature": ("markov", _psi(_se, 2), NGHP, False),
    "sum psi0": ("gauss", _psi(_sum, 0), None, False),
    "sum psi1": ("gauss", _psi(_sum, 1), None, False),
    "sum psi2": ("gauss", _psi(_sum, 2), None, False),
    "sum psi2 of two sums": ("gauss", _two_sums, NGHP, False),
    "linear mean times sum": ("gauss", _mean_and_kernel("linear", _sum), None, False),
    "markov identity times sum": ("markov", _mean_and_kernel("identity", _sum), None, False),
    "product psi0": ("diag", _product(0), None, False),
    "product psi1": ("diag", _product(1), None, False),
    "product psi2": ("diag", _product(2), None, False),
    "sqe times linear": ("gauss", _cross(True), None, False),
    "sqe times linear diagonal": ("diag", _cross(True), None, False),
    "linear times sqe": ("gauss", _cross(False), None, False),
    "separate dims diagonal": ("diag", _separate_dims, None, False),
    "quadrature matern52 psi2": ("gauss", _psi(lambda pkg: pkg.kernels.Matern52(lengthscales=0.9), 2), NGHP, True),
    "quadrature separate dims diagonal": ("diag", _separate_dims, NGHP, True),
    "quadrature markov psi2": ("markov", _psi(_se, 2), NGHP, True),
    "quadrature linear mean": ("gauss", _two_means("linear", None), NGHP, True),
}


def _jax_value(kind, build, nghp, quad):
    def fn():
        obj1, obj2 = build(gpflow_tpu)
        f = gpflow_tpu.expectations.quadrature_expectation if quad else gpflow_tpu.expectations.expectation
        return f(_p(gpflow_tpu, kind), obj1, obj2, nghp=nghp)
    return reference_jit(fn)()


def _port_value(kind, build, nghp, quad):
    obj1, obj2 = build(gpflow_tpu_torch)
    return (quadrature_expectation if quad else expectation)(_p(gpflow_tpu_torch, kind), obj1, obj2, nghp=nghp)


@pytest.mark.parametrize("name", sorted(CASES))
def test_expectation_matches_jax(name):
    kind, build, nghp, quad = CASES[name]
    _close(_port_value(kind, build, nghp, quad), _jax_value(kind, build, nghp, quad))


def _targets(kind, build, quad):
    """The function the port's dispatcher picks for a case's top-level call."""
    obj1, obj2 = build(gpflow_tpu_torch)
    p = _p(gpflow_tpu_torch, kind)
    (o1, f1), (o2, f2) = (o if isinstance(o, tuple) else (o, None) for o in (obj1, obj2))
    dispatcher = dispatch.quadrature_expectation if quad else dispatch.expectation
    return dispatcher.registered_fn(type(p), type(o1), type(f1), type(o2), type(f2))


def test_cases_reach_every_registration():
    """Each registered function is the top-level target of a case or is
    reached from one; with the calls recorded, all 35 + 2 are reached."""
    seen = set()
    registered = {id(f): f for d in (dispatch.expectation, dispatch.quadrature_expectation) for f in d.funcs.values()}
    assert len(set(dispatch.expectation.funcs.values())) == 35
    assert len(set(dispatch.quadrature_expectation.funcs.values())) == 2
    originals = {}
    for d in (dispatch.expectation, dispatch.quadrature_expectation):
        originals[d] = dict(d.funcs)

        def recorder(fn):
            def wrapped(*args, **kwargs):
                seen.add(id(fn))
                return fn(*args, **kwargs)
            return wrapped

        d.funcs = {sig: recorder(fn) for sig, fn in d.funcs.items()}
        d._cache.clear()
    try:
        for kind, build, nghp, quad in CASES.values():
            _port_value(kind, build, nghp, quad)
    finally:
        for d, funcs in originals.items():
            d.funcs = funcs
            d._cache.clear()
    missing = sorted(f"{registered[i].__module__}.{registered[i].__qualname__}" for i in set(registered) - seen)
    assert not missing, missing
    assert _targets("gauss", _psi(_se, 2), False).__qualname__ == \
        "_expectation_gaussian_sqe_inducingpoints__sqe_inducingpoints"


@pytest.mark.parametrize("kind, cls", [("diag", DiagonalGaussian), ("gauss", Gaussian), ("markov", MarkovGaussian)])
def test_tuple_p_picks_its_distribution_by_cov_ndim(kind, cls):
    p = _p(gpflow_tpu_torch, kind)
    k, iv = _se(gpflow_tpu_torch), _iv(gpflow_tpu_torch)
    by_tuple = expectation((p.mu, p.cov), (k, iv))
    _close(by_tuple, expectation(cls(p.mu, p.cov), (k, iv)), 0.0)
    jp = _p(gpflow_tpu, kind)
    _close(by_tuple, reference_jit(lambda: gpflow_tpu.expectations.expectation(
        (jp.mu, jp.cov), (_se(gpflow_tpu), _iv(gpflow_tpu))))())


def test_distribution_shapes():
    for kind, shape in (("gauss", (N, D)), ("diag", (N, D)), ("markov", (N, D))):
        p = _p(gpflow_tpu_torch, kind)
        assert gpflow_tpu_torch.probability_distributions.get_probability_distribution_shape(p) == shape
        assert tuple(_p(gpflow_tpu, kind).shape) == shape


def test_contracts_hold_when_checked():
    """The shape contracts of the registrations hold on every case."""
    set_enable_check_shapes(True)
    try:
        for kind, build, nghp, quad in CASES.values():
            _port_value(kind, build, nghp, quad)
    finally:
        set_enable_check_shapes(False)


def _grad_case(pkg, which):
    k = _se(pkg, ard=True) if which != "cross" else _se(pkg)
    iv = _iv(pkg)
    if which == "psi1":
        return (k, iv), None, [k, iv]
    if which == "psi2":
        return (k, iv), (k, iv), [k, iv]
    kl = _lin(pkg)
    return (k, iv), (kl, iv), [k, kl, iv]


@pytest.mark.parametrize("kind", ["gauss", "diag"])
@pytest.mark.parametrize("which", ["psi1", "psi2", "cross"])
def test_gradients_match_jax(which, kind):
    """d sum(W * expectation) with respect to the distribution's mean and
    covariance and to every parameter of the kernels and Z."""
    W = np.random.RandomState(7).randn(*((N, M) if which == "psi1" else (N, M, M)))
    jobj1, jobj2, jmods = _grad_case(gpflow_tpu, which)
    jparams = [p for m in jmods for _, p in sorted(jax_parameter_dict(m).items())]

    def jfn(unconstrained, mu, cov):
        p = _p(gpflow_tpu, kind, mu, cov)
        return jax.numpy.sum(W * functionalize(
            lambda: gpflow_tpu.expectations.expectation(p, jobj1, jobj2), jparams)(unconstrained))

    arrays = (XMU, XCOV if kind == "gauss" else XVAR)
    jg = reference_jit(jax.grad(jfn, argnums=(0, 1, 2)))(tuple(p.unconstrained_variable for p in jparams), *arrays)

    pobj1, pobj2, pmods = _grad_case(gpflow_tpu_torch, which)
    pparams = [p for m in pmods for _, p in sorted(parameter_dict(m).items())]
    mu, cov = (torch.from_numpy(a.copy()).requires_grad_() for a in arrays)
    out = expectation(_p(gpflow_tpu_torch, kind, mu, cov), pobj1, pobj2)
    pg = torch.autograd.grad(torch.sum(torch.from_numpy(W) * out), [p.unconstrained for p in pparams] + [mu, cov])
    for got, want in zip(pg, list(jg[0]) + [jg[1], jg[2]]):
        _close(got, want)


def test_psi2_gradient_where_kzz_underflows():
    """psi2's gradient in the lengthscale stays finite, and the JAX
    package's, where K(Z, Z) underflows at distant Z
    (``tests/gpflow_tpu/test_expectations.py:247``)."""
    mu, cov, zfar = np.array([[10.0]]), np.array([[[0.1]]]), np.array([[-10.0], [10.0]])

    def jfn(log_ls):
        k = gpflow_tpu.kernels.SquaredExponential(variance=2.0, lengthscales=1.0)
        iv = gpflow_tpu.inducing_variables.InducingPoints(zfar)
        return jax.numpy.sum(functionalize(
            lambda: gpflow_tpu.expectations.expectation(gpflow_tpu.probability_distributions.Gaussian(mu, cov),
                                                        (k, iv), (k, iv)),
            [k.lengthscales])((k.lengthscales.transform.inverse(jax.numpy.exp(log_ls)),)))

    want = reference_jit(jax.grad(jfn))(np.log(0.1))
    k = gpflow_tpu_torch.kernels.SquaredExponential(variance=2.0, lengthscales=1.0)
    iv = gpflow_tpu_torch.inducing_variables.InducingPoints(zfar)
    log_ls = torch.tensor(np.log(0.1), dtype=torch.float64, requires_grad=True)
    k.lengthscales._parameters["unconstrained"] = k.lengthscales.transform.inverse(torch.exp(log_ls))
    out = torch.sum(expectation(Gaussian(torch.from_numpy(mu), torch.from_numpy(cov)), (k, iv), (k, iv)))
    (got,) = torch.autograd.grad(out, [log_ls])
    assert np.isfinite(float(got)) and np.isfinite(float(want))
    _close(got.reshape(()), np.asarray(want).reshape(()))


def test_slice_cov_matches_jax():
    cov = np.random.RandomState(3).randn(N, 4, 4)
    for dims in ([0, 2], [3, 1], [1, 2, 3], slice(1, 3)):
        jk = gpflow_tpu.kernels.SquaredExponential(active_dims=dims)
        pk = gpflow_tpu_torch.kernels.SquaredExponential(active_dims=dims)
        _close(pk.slice_cov(torch.from_numpy(cov)), jk.slice_cov(cov), 0.0)
        _close(pk.slice_cov(torch.from_numpy(cov[:, 0])), jk.slice_cov(cov[:, 0]), 0.0)


# --- uncertain_conditional


def _uncertain_inputs(pkg, mean_function, seed=8):
    r = np.random.RandomState(seed)
    Zu, q_mu = r.randn(M, D), r.randn(M, 2)
    q_sqrt = np.tril(0.2 * r.randn(2, M, M) + np.eye(M))
    kernel = pkg.kernels.SquaredExponential(variance=1.1, lengthscales=[0.9, 1.2])
    mf = None
    if mean_function == "linear":
        mf = pkg.functions.Linear(r.randn(D, 2), r.randn(2))
    elif mean_function == "zero":
        mf = pkg.functions.Zero()
    return Zu, q_mu, q_sqrt, kernel, mf


@pytest.mark.parametrize("full_output_cov", [False, True])
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("mean_function", [None, "zero", "linear"])
def test_uncertain_conditional_matches_jax(mean_function, white, full_output_cov):
    Zu, q_mu, q_sqrt, jk, jmf = _uncertain_inputs(gpflow_tpu, mean_function)
    want = reference_jit(lambda: gpflow_tpu.conditionals.uncertain_conditional(
        XMU, XCOV, gpflow_tpu.inducing_variables.InducingPoints(Zu), jk, q_mu, q_sqrt, mean_function=jmf,
        full_output_cov=full_output_cov, white=white))()
    _, _, _, pk, pmf = _uncertain_inputs(gpflow_tpu_torch, mean_function)
    got = gpflow_tpu_torch.conditionals.uncertain_conditional(
        torch.from_numpy(XMU), torch.from_numpy(XCOV), gpflow_tpu_torch.inducing_variables.InducingPoints(Zu), pk,
        torch.from_numpy(q_mu), torch.from_numpy(q_sqrt), mean_function=pmf, full_output_cov=full_output_cov,
        white=white)
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_uncertain_conditional_contract_errors():
    _, q_mu, q_sqrt, pk, _ = _uncertain_inputs(gpflow_tpu_torch, None)
    args = (torch.from_numpy(XMU), torch.from_numpy(XCOV))
    iv = gpflow_tpu_torch.inducing_variables.InducingPoints(Z)
    with pytest.raises(NotImplementedError, match="full_cov"):
        gpflow_tpu_torch.conditionals.uncertain_conditional(
            *args, iv, pk, torch.from_numpy(q_mu), torch.from_numpy(q_sqrt), full_cov=True)
    with pytest.raises(NotImplementedError):
        gpflow_tpu_torch.conditionals.uncertain_conditional(
            *args, gpflow_tpu_torch.inducing_variables.Multiscale(Z, np.ones_like(Z)), pk, torch.from_numpy(q_mu),
            torch.from_numpy(q_sqrt))
