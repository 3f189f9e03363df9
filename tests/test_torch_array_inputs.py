"""numpy and Python numbers at the port's functional API (ROADMAP F6) and
numpy dtypes wherever a dtype is taken (F7), against the JAX package, on the
CPU in float64 from the same seeded numpy inputs, unconverted.

* The public functions and dispatchers that the JAX package's tests feed
  numpy: ``logdensities``, ``conditionals.util``, ``conditional``,
  ``sample_conditional``, ``uncertain_conditional``, ``Kuu`` and ``Kuf``
  (Multiscale among them), ``gauss_kl`` and ``prior_kl``, the Markov
  expectations, the deprecated quadrature, ``Convolutional.get_patches``,
  the posteriors' constructors, the priors' ``log_prob`` and the bijectors:
  each gives the JAX package's value to 1e-12 of the largest entry.
* The rule of ``base.array_inputs`` and ``base.numpy_to_tensors``: a
  converted argument goes to the device of the call's first tensor, else of
  its first module, else ``config.default_device()`` (the ``meta`` device
  stands for the card here); a tensor passes through untouched; integer
  arrays keep their dtype.
* F8-F14, F16: numpy at the quadrature objects (and so every quadrature
  likelihood), at ``RobustMax``, ``likelihoods.utils.inv_probit``,
  ``ops.linalg``, the natural-gradient parameterisations, the kernels'
  ``scale`` and ``slice_cov``, ``utilities.ops.leading_transpose``; and
  ``GPFLOW_TPU_INV_SOLVE`` read per call.
  Each numpy route gives the JAX package's value to 1e-12 of the largest
  entry and the port's tensor route to the bit.
* F7: the dtype setters, ``Parameter``, ``Config``, ``eye``,
  ``to_default_float`` and ``pallas_available`` take a numpy dtype, a torch
  dtype or a name; the getters return torch dtypes (a written deviation).
"""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu as gj
import gpflow_tpu_torch as gt
from gpflow_tpu_torch import config
from gpflow_tpu_torch.base import array_inputs, numpy_to_tensors
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-12
rng = np.random.RandomState(23)
N, M, D, L, P = 6, 4, 2, 2, 3
X = rng.randn(N, D)
Z = rng.randn(M, D)
Q_MU = rng.randn(M, L)
Q_SQRT = np.tril(rng.randn(L, M, M)) + 2.0 * np.eye(M)
Q_DIAG = rng.rand(M, L) + 0.5


def _np(value):
    if isinstance(value, (tuple, list)):
        return [_np(v) for v in value]
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


def _close(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    assert isinstance(got, torch.Tensor), type(got)
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * max(np.max(np.abs(want)), 1e-300))


# --- logdensities --------------------------------------------------------------

_POS = rng.rand(5) + 0.5
_UNIT = rng.rand(5) * 0.8 + 0.1
_REAL = rng.randn(5)
LOGDENSITIES = {
    "gaussian": (_REAL, 0.3, _POS),
    "lognormal": (_POS, _REAL, 1.5),
    "bernoulli": ((_REAL > 0).astype(float), _UNIT),
    "poisson": (np.arange(5.0), _POS),
    "exponential": (_POS, 1.3),
    "gamma": (_POS, 2.0, _POS),
    "student_t": (_REAL, 0.1, 1.3, 3.0),
    "student_t_numpy_df": (_REAL, 0.1, _POS, _POS + 2.0),
    "beta": (_UNIT, 2.0, 3.0),
    "laplace": (_REAL, 0.5, _POS),
    "multivariate_normal": (rng.randn(3, 2), rng.randn(3, 2), np.tril(rng.randn(3, 3)) + 3.0 * np.eye(3)),
}


@pytest.mark.parametrize("name", sorted(LOGDENSITIES))
def test_logdensities_take_numpy_and_numbers(name):
    args = LOGDENSITIES[name]
    name = name.replace("_numpy_df", "")
    _close(getattr(gt.logdensities, name)(*args), getattr(gj.logdensities, name)(*args))


# --- conditionals.util ------------------------------------------------------------

def _spd(n, seed, batch=()):
    A = np.random.RandomState(seed).randn(*batch, n, n)
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


KMM, KMN, KNN = _spd(M, 1), rng.randn(M, N), _spd(N, 2)
UTIL_CASES = {
    "base_conditional": lambda m: m.base_conditional(KMN, KMM, KNN, Q_MU, full_cov=True, q_sqrt=Q_SQRT, white=True),
    "base_conditional_diag": lambda m: m.base_conditional(KMN, KMM, np.diag(KNN), Q_MU, q_sqrt=Q_DIAG, white=False),
    "base_conditional_with_lm": lambda m: m.base_conditional_with_lm(
        KMN, np.linalg.cholesky(KMM), np.diag(KNN), Q_MU, q_sqrt=Q_SQRT),
    "independent_interdomain_conditional": lambda m: m.independent_interdomain_conditional(
        rng_a.randn(M, L, N, L), _spd(M, 3, (L,)), _spd(N, 4)[None].repeat(L, 0), Q_MU, q_sqrt=Q_SQRT,
        full_cov=True, full_output_cov=False),
    "fully_correlated_conditional": lambda m: m.fully_correlated_conditional(
        rng_a.randn(M, N, L), _spd(M, 5), rng_a.rand(N, L) + 1.0, Q_MU[:, :1], q_sqrt=np.tril(Q_SQRT[:1])),
    "fully_correlated_conditional_repeat": lambda m: m.fully_correlated_conditional_repeat(
        rng_a.randn(M, N, L), _spd(M, 6), rng_a.rand(N, L) + 1.0, Q_MU, q_sqrt=Q_SQRT),
    "mix_latent_gp": lambda m: m.mix_latent_gp(
        rng_a.randn(P, L), rng_a.randn(N, L), rng_a.rand(N, L) + 0.1, False, True),
    "separate_independent_conditional_implementation": lambda m: m.separate_independent_conditional_implementation(
        rng_a.randn(L, M, N), _spd(M, 7, (L,)), rng_a.rand(L, N) + 1.0, Q_MU, q_sqrt=Q_SQRT),
    "expand_independent_outputs": lambda m: m.expand_independent_outputs(rng_a.rand(N, L), False, True),
    "rollaxis_left": lambda m: m.rollaxis_left(rng_a.randn(2, 3, 4), 1),
}


@pytest.mark.parametrize("case", sorted(UTIL_CASES))
def test_conditionals_util_takes_numpy(case):
    global rng_a
    rng_a = np.random.RandomState(5)
    want = UTIL_CASES[case](gj.conditionals.util)
    rng_a = np.random.RandomState(5)
    _close(UTIL_CASES[case](gt.conditionals.util), want)


# --- the dispatchers ------------------------------------------------------------------

def _pair(build):
    return build(gj), build(gt)


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("q_sqrt", ["full", "diag"])
def test_conditional_takes_numpy(white, q_sqrt):
    qs = Q_SQRT if q_sqrt == "full" else Q_DIAG
    want, got = (
        m.conditionals.conditional(X, m.inducing_variables.InducingPoints(Z), m.kernels.Matern52(lengthscales=0.7),
                                   Q_MU, q_sqrt=qs, white=white, full_cov=True)
        for m in (gj, gt)
    )
    _close(got, want)


def test_sample_conditional_takes_numpy():
    samples, mean, cov = gt.conditionals.sample_conditional(
        X, gt.inducing_variables.InducingPoints(Z), gt.kernels.SquaredExponential(), Q_MU, q_sqrt=Q_SQRT,
        num_samples=3, generator=torch.Generator().manual_seed(0))
    want = gj.conditionals.conditional(X, gj.inducing_variables.InducingPoints(Z), gj.kernels.SquaredExponential(),
                                       Q_MU, q_sqrt=Q_SQRT)
    _close((mean, cov), want)
    assert samples.shape == (3, N, L) and samples.dtype == torch.float64


@pytest.mark.parametrize("inducing", ["points", "multiscale"])
def test_kuu_and_kuf_take_numpy(inducing):
    scales = rng.rand(M, D) * 0.3 + 0.1
    for m in (gj, gt):
        iv = m.inducing_variables.InducingPoints(Z) if inducing == "points" else \
            m.inducing_variables.Multiscale(Z, scales)
        kernel = m.kernels.SquaredExponential(lengthscales=[0.8, 1.3])
        if m is gj:
            want = (m.covariances.Kuu(iv, kernel, jitter=1e-6), m.covariances.Kuf(iv, kernel, X))
        else:
            got = (m.covariances.Kuu(iv, kernel, jitter=1e-6), m.covariances.Kuf(iv, kernel, X))
    _close(got, want)


@pytest.mark.parametrize("whiten", [True, False])
def test_gauss_kl_and_prior_kl_take_numpy(whiten):
    _close(gt.kullback_leiblers.gauss_kl(Q_MU, Q_SQRT, KMM), gj.kullback_leiblers.gauss_kl(Q_MU, Q_SQRT, KMM))
    _close(gt.kullback_leiblers.gauss_kl(Q_MU, Q_DIAG), gj.kullback_leiblers.gauss_kl(Q_MU, Q_DIAG))
    want, got = (
        m.kullback_leiblers.prior_kl(m.inducing_variables.InducingPoints(Z), m.kernels.SquaredExponential(),
                                     Q_MU, Q_SQRT, whiten=whiten)
        for m in (gj, gt)
    )
    _close(got, want)


def test_uncertain_conditional_and_markov_expectation_take_numpy():
    Xvar = np.stack([np.diag(v) for v in rng.rand(N, D) * 0.1 + 0.01])
    want, got = (
        m.conditionals.uncertain_conditional(X, Xvar, m.inducing_variables.InducingPoints(Z),
                                             m.kernels.SquaredExponential(), Q_MU, Q_SQRT, full_output_cov=True)
        for m in (gj, gt)
    )
    _close(got, want)
    mu = rng.randn(N + 1, D)
    cov = np.stack([np.stack([np.eye(D)] * (N + 1)), np.stack([0.3 * np.eye(D)] * (N + 1))])
    want, got = (
        m.expectations.expectation(m.probability_distributions.MarkovGaussian(mu, cov),
                                   (m.kernels.Linear(variance=1.3), m.inducing_variables.InducingPoints(Z)),
                                   m.functions.Identity())
        for m in (gj, gt)
    )
    _close(got, want)


def test_deprecated_quadrature_takes_numpy():
    covs = np.stack([_spd(D, 8 + n) * 0.05 for n in range(N)])
    fn = lambda x: x ** 2  # noqa: E731
    _close(gt.quadrature.mvnquad(fn, X, covs, 5, D, (D,)), gj.quadrature.mvnquad(fn, X, covs, 5, D, (D,)))
    fvar = rng.rand(N, 1) + 0.1
    _close(gt.quadrature.ndiagquad(fn, 8, X[:, :1], fvar), gj.quadrature.ndiagquad(fn, 8, X[:, :1], fvar))


def test_get_patches_takes_numpy():
    images = rng.rand(3, 16)
    want, got = (
        m.kernels.Convolutional(m.kernels.SquaredExponential(), [4, 4], [2, 2]).get_patches(images)
        for m in (gj, gt)
    )
    _close(got, want)


@pytest.mark.parametrize("q_sqrt", ["full", "diag", "none"])
def test_posterior_constructors_take_numpy(q_sqrt):
    qs = {"full": Q_SQRT, "diag": Q_DIAG, "none": None}[q_sqrt]
    Xnew = rng.randn(5, D)
    want, got = (
        m.posteriors.IndependentPosteriorSingleOutput(
            m.kernels.SquaredExponential(), m.inducing_variables.InducingPoints(Z), Q_MU, qs, whiten=False,
            precompute_cache=m.posteriors.PrecomputeCacheType.TENSOR,
        ).predict_f(Xnew, full_cov=True)
        for m in (gj, gt)
    )
    _close(got, want)
    want, got = (
        m.posteriors.VGPPosterior(m.kernels.Matern32(), X, Q_MU[:1, :1].repeat(N, 0), np.tril(_spd(N, 9))[None],
                                  precompute_cache=m.posteriors.PrecomputeCacheType.TENSOR).predict_f(Xnew)
        for m in (gj, gt)
    )
    _close(got, want)


def test_priors_and_bijectors_take_numpy_and_numbers():
    x = rng.rand(5) + 0.1
    for name, args in [("Normal", (0.5, 2.0)), ("Gamma", (2.0, 0.5)), ("Beta", (2.0, 3.0))]:
        _close(getattr(gt.priors, name)(*args).log_prob(x * 0.9), getattr(gj.priors, name)(*args).log_prob(x * 0.9))
        _close(getattr(gt.priors, name)(*args).log_prob(np.float64(0.4)),
               getattr(gj.priors, name)(*args).log_prob(np.float64(0.4)))
    jb, tb = gj.utilities.positive(), gt.utilities.positive()
    for method in ("forward", "inverse", "forward_log_det_jacobian"):
        _close(getattr(tb, method)(x), getattr(jb, method)(x))
        _close(getattr(tb, method)(1.7), getattr(jb, method)(1.7))


# --- the rule ------------------------------------------------------------------

def test_converted_arguments_follow_the_first_tensor_else_the_default_device():
    meta = torch.zeros(5, dtype=torch.float64, device="meta")
    assert gt.logdensities.gaussian(meta, _REAL, _POS).device.type == "meta"
    assert gt.logdensities.gaussian(_REAL, _REAL, meta).device.type == "meta"
    with config.as_context(config.Config(device="meta")):
        assert gt.logdensities.gaussian(_REAL, 0.3, _POS).device.type == "meta"
    # with a module and no tensor: the module's device (the CPU here)
    with config.as_context(config.Config(device="cpu")):
        kernel, inducing = gt.kernels.SquaredExponential(), gt.inducing_variables.InducingPoints(Z)
    with config.as_context(config.Config(device="meta")):
        got = gt.covariances.Kuf(inducing, kernel, X)
    assert got.device.type == "cpu"


def test_a_tensor_passes_through_and_integer_arrays_keep_their_dtype():
    seen = []

    @array_inputs("a", "b", "c")
    def fn(a, b, c=None, flag=True):
        seen.append((a, b, c, flag))

    t = torch.ones(3, dtype=torch.float32)
    fn(t, np.arange(3), c=2.0, flag=False)
    a, b, c, flag = seen[-1]
    assert a is t and b.dtype == torch.int64 and c.dtype == torch.float64 and c.shape == () and flag is False
    args, kwargs = numpy_to_tensors([t, 3, True], {"x": t, "n": 7})
    assert args[0] is t and args[1:] == [3, True] and kwargs["x"] is t and kwargs["n"] == 7
    args, kwargs = numpy_to_tensors([t, np.float32(2.0)], {"y": np.arange(2)})
    assert args[0] is t and args[1].dtype == torch.float64 and kwargs["y"].dtype == torch.int64
    p = gt.Parameter(1.5)
    fn(p, np.ones(2))
    assert seen[-1][0].requires_grad and float(seen[-1][0]) == 1.5


def test_a_python_number_is_filled_on_the_device_not_copied(monkeypatch):
    """On the card a copy from the host synchronises; a fill does not. A
    Python ``df`` stays a number in ``student_t``, as its docstring says."""
    copies = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor", lambda *a, **k: copies.append(a) or as_tensor(*a, **k))
    x = torch.from_numpy(_REAL)
    _close(gt.logdensities.gaussian(x, 0.3, 1.5), gj.logdensities.gaussian(_REAL, 0.3, 1.5))
    _close(gt.logdensities.student_t(x, 0.1, 1.3, 3.0), gj.logdensities.student_t(_REAL, 0.1, 1.3, 3.0))
    assert copies == []


# --- F7: numpy dtypes -------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.dtype("float32"), "float32", torch.float32])
def test_dtype_arguments_take_numpy_torch_and_names(dtype):
    assert gt.Parameter(1.0, dtype=dtype).dtype == torch.float32
    assert gt.utilities.ops.eye(3, dtype=dtype).dtype == torch.float32
    assert config.Config(float=dtype).float == torch.float32
    assert gt.ops.pallas_distance.pallas_available(dtype) == gj.ops.pallas_distance.pallas_available(np.float32)
    with config.as_context():
        config.set_default_float(dtype)
        assert config.default_float() is torch.float32  # the getter gives the torch dtype
        assert gt.utilities.to_default_float(np.arange(3)).dtype == torch.float32
        assert gt.utilities.to_default_float(np.ones(2, dtype=np.float64)).dtype == torch.float32


@pytest.mark.parametrize("dtype", [np.int32, np.dtype("int32"), "int32", torch.int32])
def test_int_dtype_setter_takes_numpy_torch_and_names(dtype):
    with config.as_context():
        config.set_default_int(dtype)
        assert config.default_int() is torch.int32
        assert gt.utilities.to_default_int(np.arange(3.0)).dtype == torch.int32


def test_numpy_float32_inputs_take_the_default_float():
    """As the JAX package's ``jnp.asarray`` after ``to_default_float``: a
    numpy float32 argument is computed in ``default_float()``."""
    x32 = _REAL.astype(np.float32)
    got = gt.logdensities.gaussian(x32, 0.0, 1.0)
    assert got.dtype == torch.float64
    _close(got, gj.logdensities.gaussian(x32.astype(np.float64), 0.0, 1.0))


def test_jax_reference_runs_in_float64():
    assert jax.config.read("jax_enable_x64")


# --- F8-F13, F16: numpy where the numpy sweep (F16: a translated test) found the port raising

def _tensors(value):
    """The same inputs as float64 tensors on the CPU: the port's tensor route."""
    if isinstance(value, np.ndarray):
        return torch.as_tensor(value, dtype=torch.float64)
    return value


_GH = np.polynomial.hermite.hermgauss(7)
_FMU, _FVAR, _Y = rng.randn(N, 1), rng.rand(N, 1) + 0.1, rng.randn(N, 1)
_F3, _VAR3 = rng.randn(N, 3), rng.rand(N, 3) + 0.1
_LABELS = rng.randint(0, 3, (N, 1)).astype(float)
_L = np.linalg.cholesky(_spd(M, 11))
_NAT2 = -0.5 * np.linalg.inv(_spd(M, 12))[None].repeat(L, 0)
_ETA2 = _spd(M, 13)[None].repeat(L, 0) + Q_MU.T[:, :, None] * Q_MU.T[:, None, :]
_COV = _spd(D, 14)[None].repeat(N, 0)
_A4 = np.random.RandomState(16).randn(2, 3, 4, 5)
SWEEP_CASES = {
    # F8: the quadrature objects, and a quadrature likelihood through them
    "NDiagGHQuadrature": lambda m, a: m.quadrature.NDiagGHQuadrature(1, 20)(lambda x: x ** 2, a(_FMU), a(_FVAR)),
    "NDiagGHQuadrature.logspace": lambda m, a: m.quadrature.NDiagGHQuadrature(1, 20).logspace(
        lambda x, Y: -0.5 * (x - Y) ** 2, a(_FMU), a(_FVAR), a(_Y)),
    "NDiagGHQuadrature_2d_kwargs": lambda m, a: m.quadrature.NDiagGHQuadrature(2, 6)(
        lambda x, Y: x * Y, a(X), a(X ** 2 + 0.1), Y=a(_Y)),
    "Poisson.quadrature": lambda m, a: (lambda lik: lik.quadrature(
        lik._quadrature_log_prob, a(_FMU), a(_FVAR), X=a(X), Y=a(np.abs(np.round(_Y)))))(m.likelihoods.Poisson()),
    # F9: RobustMax
    "RobustMax": lambda m, a: m.likelihoods.RobustMax(3)(a(_F3)),
    "RobustMax.safe_sqrt": lambda m, a: m.likelihoods.RobustMax(3).safe_sqrt(a(_VAR3 - 0.3)),
    "RobustMax.prob_is_largest": lambda m, a: m.likelihoods.RobustMax(3).prob_is_largest(
        a(_LABELS), a(_F3), a(_VAR3), a(_GH[0]), a(_GH[1])),
    # F10
    "inv_probit": lambda m, a: m.likelihoods.utils.inv_probit(a(_F3)),
    # F11: ops.linalg
    "sym_jitter": lambda m, a: m.ops.linalg.sym_jitter(a(KMM)),
    "triangular_inverse": lambda m, a: m.ops.linalg.triangular_inverse(a(_L)),
    "chol_and_inverse": lambda m, a: m.ops.linalg.chol_and_inverse(a(KMM)),
    "cholesky_mm": lambda m, a: m.ops.linalg.cholesky_mm(a(KMM)),
    "mvn_logp": lambda m, a: m.ops.linalg.mvn_logp(a(KMM), a(Q_MU)),
    # F12: the natural-gradient parameterisations
    "natural_to_meanvarsqrt": lambda m, a: m.optimizers.natgrad.natural_to_meanvarsqrt(a(Q_MU), a(_NAT2)),
    "meanvarsqrt_to_natural": lambda m, a: m.optimizers.natgrad.meanvarsqrt_to_natural(a(Q_MU), a(Q_SQRT)),
    "natural_to_expectation": lambda m, a: m.optimizers.natgrad.natural_to_expectation(a(Q_MU), a(_NAT2)),
    "expectation_to_natural": lambda m, a: m.optimizers.natgrad.expectation_to_natural(a(Q_MU), a(_ETA2)),
    "expectation_to_meanvarsqrt": lambda m, a: m.optimizers.natgrad.expectation_to_meanvarsqrt(a(Q_MU), a(_ETA2)),
    "meanvarsqrt_to_expectation": lambda m, a: m.optimizers.natgrad.meanvarsqrt_to_expectation(a(Q_MU), a(Q_SQRT)),
    "XiSqrtMeanVar.naturals_to_xi": lambda m, a: m.optimizers.XiSqrtMeanVar.naturals_to_xi(a(Q_MU), a(_NAT2)),
    "XiNat.xi_to_meanvarsqrt": lambda m, a: m.optimizers.XiNat.xi_to_meanvarsqrt(a(Q_MU), a(_NAT2)),
    # F13: the kernels' scaling and slicing helpers
    "Matern32.scale": lambda m, a: m.kernels.Matern32(lengthscales=[0.5, 2.0]).scale(a(X)),
    "RBF.scaled_squared_euclid_dist": lambda m, a: m.kernels.RBF(lengthscales=0.7).scaled_squared_euclid_dist(
        a(X), a(Z)),
    "Cosine.scaled_difference_matrix": lambda m, a: m.kernels.Cosine(lengthscales=[0.5, 2.0]).scaled_difference_matrix(
        a(X), a(Z)),
    "slice_cov_full": lambda m, a: m.kernels.Linear(active_dims=[1]).slice_cov(a(_COV)),
    "slice_cov_diag": lambda m, a: m.kernels.SquaredExponential(active_dims=slice(0, 1)).slice_cov(a(X ** 2)),
    # F16 (found by the translated test_shapes.py): leading_transpose
    "leading_transpose": lambda m, a: m.utilities.ops.leading_transpose(a(_A4), [..., -1, -2]),
    "leading_transpose_leading_dim": lambda m, a: m.utilities.ops.leading_transpose(
        a(_A4), [..., -1, -2], leading_dim=1),
}


def _bits(got, want):
    if isinstance(want, (tuple, list)):
        for g, w in zip(got, want):
            _bits(g, w)
        return
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(SWEEP_CASES))
def test_numpy_route_equals_jax_and_the_tensor_route(case):
    numpy_route = SWEEP_CASES[case](gt, lambda v: v)
    _close(numpy_route, SWEEP_CASES[case](gj, lambda v: v))
    _bits(numpy_route, SWEEP_CASES[case](gt, _tensors))


# --- F14: GPFLOW_TPU_INV_SOLVE ----------------------------------------------------------

def test_inv_solve_variable_is_read_per_call(monkeypatch):
    """As the JAX package's ``_use_inv_solve``: with no explicit setting the
    variable chooses the route at each call; ``set_inv_solve`` beats it."""
    util = gt.conditionals.util
    Kmn, Knn = rng.randn(M, 3 * M), rng.rand(3 * M) + 1.0
    monkeypatch.delenv("GPFLOW_TPU_INV_SOLVE", raising=False)
    solve = util.base_conditional(Kmn, KMM, Knn, Q_MU)
    with util.inv_solve():
        inverse = util.base_conditional(Kmn, KMM, Knn, Q_MU)
    monkeypatch.setenv("GPFLOW_TPU_INV_SOLVE", "1")
    assert util._use_inv_solve() and gj.conditionals.util._use_inv_solve()
    _bits(util.base_conditional(Kmn, KMM, Knn, Q_MU), inverse)
    with util.inv_solve(False):
        _bits(util.base_conditional(Kmn, KMM, Knn, Q_MU), solve)
    monkeypatch.setenv("GPFLOW_TPU_INV_SOLVE", "false")
    assert not util._use_inv_solve() and not gj.conditionals.util._use_inv_solve()
    _close(inverse, gj.conditionals.util.base_conditional(Kmn, KMM, Knn, Q_MU))
