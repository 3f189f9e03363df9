"""The multioutput slice of gpflow_tpu_torch against gpflow_tpu, on the CPU,
on the same seeded numpy inputs and values, in float64: the four
multioutput kernels, every Kuu/Kuf registration, every registered
``conditional`` route, the cached and fused multioutput posteriors, the
dispatch of ``get_posterior_class``, ``conditional``, ``Kuu`` and ``Kuf``
over the whole (kernel, inducing variable) grid, each route's SVGP ELBO and
gradients after ``load_jax_values`` of the JAX model's ``read_values``, the
fully correlated ``prior_kl``, ``calc_num_latent_gps`` and the helpers
``mix_latent_gp``, ``rollaxis_left``/``rollaxis_right`` and
``leading_transpose``. Values agree to 1e-10 of the largest float64 entry;
dispatch and parameter paths agree exactly. Sizes follow the JAX package's
own multioutput tests: N <= 12, M = 5, P = 3 outputs, L = 2 latent GPs."""
import functools

import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, conditionals, covariances, kullback_leiblers, posteriors
from gpflow_tpu_torch.conditionals import util as putil
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict, set_enable_check_shapes
from gpflow_tpu_torch.utilities.ops import leading_transpose
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
N, D, M, P, L = 7, 2, 5, 3, 2
_rng = np.random.RandomState(9)
X = _rng.randn(N, D)
XB = _rng.randn(2, 4, D)  # a batch dimension
X2 = _rng.randn(4, D)
ZS = [_rng.randn(M, D) for _ in range(P)]
W_LMC = _rng.randn(P, L)
W_SQUARE = _rng.randn(P, P)
COV = [(False, False), (True, False), (False, True), (True, True)]


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _kernel(pkg, kind):
    K = pkg.kernels
    if kind == "se":
        return K.SquaredExponential(variance=1.1, lengthscales=0.9)
    if kind == "shared":
        return K.SharedIndependent(K.SquaredExponential(variance=1.3, lengthscales=[0.8, 1.2]), output_dim=P)
    if kind == "separate":
        return K.SeparateIndependent([K.SquaredExponential(lengthscales=0.9), K.Matern52(variance=0.7, lengthscales=1.1),
                                      K.SquaredExponential(variance=1.4, lengthscales=[0.6, 1.3])])
    if kind == "lmc":
        return K.LinearCoregionalization([K.SquaredExponential(lengthscales=[0.8, 1.1]),
                                          K.Matern52(variance=0.7, lengthscales=1.2)], W=W_LMC)
    if kind == "lmc_square":
        return K.LinearCoregionalization([K.SquaredExponential(lengthscales=[0.8, 1.1]), K.Matern52(lengthscales=1.2),
                                          K.SquaredExponential(variance=0.6, lengthscales=0.7)], W=W_SQUARE)
    raise ValueError(kind)


LATENTS = {"se": 1, "shared": P, "separate": P, "lmc": L, "lmc_square": P}


def _iv(pkg, kind, n):
    I = pkg.inducing_variables
    if kind == "ip":
        return I.InducingPoints(ZS[0])
    if kind in ("shared", "fb_shared"):
        cls = I.SharedIndependentInducingVariables if kind == "shared" else I.FallbackSharedIndependentInducingVariables
        return cls(I.InducingPoints(ZS[0]))
    cls = I.SeparateIndependentInducingVariables if kind == "separate" else I.FallbackSeparateIndependentInducingVariables
    return cls([I.InducingPoints(ZS[i]) for i in range(n)])


# every registered (inducing variable, kernel) route of ``conditional``. On
# the fully correlated route a LinearCoregionalization with L < P has a
# prior [MP, MP] of rank ML, conditioned as 1 / jitter in both packages;
# the route takes it with L = P, where the prior has full rank.
ROUTES = [("shared", "shared"), ("separate", "shared"), ("shared", "separate"), ("separate", "separate"),
          ("shared", "lmc"), ("separate", "lmc"), ("fb_shared", "lmc"), ("fb_separate", "lmc"),
          ("ip", "shared"), ("ip", "lmc_square")]
ROUTE_IDS = [f"{iv}-{k}" for iv, k in ROUTES]


def _pair(iv_kind, k_kind):
    n = LATENTS[k_kind]
    return (_iv(gpflow_tpu, iv_kind, n), _kernel(gpflow_tpu, k_kind)), (_iv(gpflow_tpu_torch, iv_kind, n),
                                                                         _kernel(gpflow_tpu_torch, k_kind))


def _lower(rng, R, m):
    Lq = np.tril(0.2 * rng.randn(R, m, m), k=-1)
    Lq[:, np.arange(m), np.arange(m)] = 0.5 + rng.rand(R, m)
    return Lq


def _variational(iv_kind, k_kind, q, seed):
    """q_mu and q_sqrt (None, diagonal or full) of the route: [M, L] and
    [M, L] / [L, M, M], or over the flattened [MP] vector on the fully
    correlated route."""
    rng = np.random.RandomState(seed)
    m, r = (M * P, 1) if iv_kind == "ip" else (M, LATENTS[k_kind])
    q_sqrt = {"none": None, "diag": 0.5 + rng.rand(m, r), "full": _lower(rng, r, m)}[q]
    return rng.randn(m, r), q_sqrt


# ---------------------------------------------------------------------------
# kernels


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("full_cov,full_output_cov", COV)
@pytest.mark.parametrize("kind", ["shared", "separate", "lmc"])
def test_multioutput_kernel_calls_match_jax(kind, full_cov, full_output_cov, batch):
    jk, pk = _kernel(gpflow_tpu, kind), _kernel(gpflow_tpu_torch, kind)
    Xin = XB if batch else X
    with torch.no_grad():
        _close(pk(_t(Xin), full_cov=full_cov, full_output_cov=full_output_cov),
               jk(Xin, full_cov=full_cov, full_output_cov=full_output_cov))
        if full_cov:
            _close(pk.K(_t(Xin), _t(X2), full_output_cov=full_output_cov),
                   jk.K(Xin, X2, full_output_cov=full_output_cov))
        else:
            _close(pk.K_diag(_t(Xin), full_output_cov=full_output_cov), jk.K_diag(Xin, full_output_cov=full_output_cov))


@pytest.mark.parametrize("kind", ["shared", "separate", "lmc"])
def test_multioutput_kernel_defaults_and_structure(kind):
    """``__call__`` defaults to full_output_cov=True, ``K_diag`` of a
    SeparateIndependent to False; ``nn.Module.__init__`` ran once and the
    children sit in an ``nn.ModuleList``."""
    jk, pk = _kernel(gpflow_tpu, kind), _kernel(gpflow_tpu_torch, kind)
    with torch.no_grad():
        _close(pk(_t(X)), jk(X))
        _close(pk(_t(X), full_cov=True), jk(X, full_cov=True))
        _close(pk.K(_t(X)), jk.K(X))
        _close(pk.K_diag(_t(X)), jk.K_diag(X))
    assert pk.num_latent_gps == jk.num_latent_gps == LATENTS[kind]
    assert len(pk.latent_kernels) == len(jk.latent_kernels)
    if kind == "shared":
        assert not isinstance(pk, gpflow_tpu_torch.kernels.Combination)
        assert isinstance(pk.kernel, gpflow_tpu_torch.kernels.SquaredExponential)
    else:
        assert isinstance(pk.kernels, torch.nn.ModuleList)
    names = [n for n, _ in pk.named_modules()]
    assert len(names) == len(set(names))
    assert sorted(parameter_dict(pk)) == sorted(jax_parameter_dict(jk))


def test_multioutput_call_rejects_x2_without_full_cov():
    with pytest.raises(ValueError, match="Ambiguous inputs"):
        _kernel(gpflow_tpu_torch, "shared")(_t(X), _t(X2))


# ---------------------------------------------------------------------------
# covariances

KU_GRID = [("ip", "shared"), ("ip", "separate"), ("ip", "lmc"), ("fb_shared", "shared"), ("fb_shared", "separate"),
           ("fb_shared", "lmc"), ("fb_separate", "shared"), ("fb_separate", "separate"), ("fb_separate", "lmc"),
           ("shared", "shared"), ("shared", "separate"), ("shared", "lmc"), ("separate", "shared"),
           ("separate", "separate"), ("separate", "lmc")]


@pytest.mark.parametrize("iv_kind,k_kind", KU_GRID, ids=[f"{a}-{b}" for a, b in KU_GRID])
def test_kuu_and_kuf_registrations_match_jax(iv_kind, k_kind):
    (jiv, jk), (piv, pk) = _pair(iv_kind, k_kind)
    jfn = gpflow_tpu.covariances.Kuu.dispatch(type(jiv), type(jk))
    pfn = covariances.Kuu.dispatch(type(piv), type(pk))
    assert pfn.__name__ == jfn.__name__
    with torch.no_grad():
        _close(covariances.Kuu(piv, pk, jitter=1e-3), gpflow_tpu.covariances.Kuu(jiv, jk, jitter=1e-3))
        jfn = gpflow_tpu.covariances.Kuf.dispatch(type(jiv), type(jk), object)
        if jfn is None:  # the fallback inducing variables with a kernel that is no IndependentLatent
            assert covariances.Kuf.dispatch(type(piv), type(pk), object) is None
            return
        assert covariances.Kuf.dispatch(type(piv), type(pk), object).__name__ == jfn.__name__
        _close(covariances.Kuf(piv, pk, _t(X)), gpflow_tpu.covariances.Kuf(jiv, jk, X))


def test_kuu_exports_keep_the_typo():
    from gpflow_tpu_torch.covariances.multioutput import kufs, kuus

    assert kuus.Kuu_fallbace_separate is kuus.Kuu_fallback_separate
    assert sorted(kuus.__all__) == sorted(gpflow_tpu.covariances.multioutput.kuus.__all__)
    assert sorted(kufs.__all__) == sorted(gpflow_tpu.covariances.multioutput.kufs.__all__)


# ---------------------------------------------------------------------------
# dispatch over the whole grid

GRID_IVS = ["ip", "fb_shared", "fb_separate", "shared", "separate"]
GRID_KERNELS = ["se", "shared", "separate", "lmc"]


def _name(fn):
    return None if fn is None else fn.__name__


@pytest.mark.parametrize("k_kind", GRID_KERNELS)
@pytest.mark.parametrize("iv_kind", GRID_IVS)
def test_dispatch_matches_jax_over_the_grid(iv_kind, k_kind):
    """``get_posterior_class`` picks the same class, and ``conditional``,
    ``Kuu`` and ``Kuf`` the same function, as the JAX package for every
    (inducing variable, kernel) pair: the tie-breaks of the lexicographic
    MRO distance (SeparateIndependentInducingVariables subclasses the
    Fallback class, LinearCoregionalization is an IndependentLatent and a
    Combination) must come out the same."""
    n = LATENTS[k_kind]
    jtypes = (type(_iv(gpflow_tpu, iv_kind, n)), type(_kernel(gpflow_tpu, k_kind)))
    ptypes = (type(_iv(gpflow_tpu_torch, iv_kind, n)), type(_kernel(gpflow_tpu_torch, k_kind)))
    jpc = gpflow_tpu.posteriors.get_posterior_class.dispatch(jtypes[1], jtypes[0])
    ppc = posteriors.get_posterior_class.dispatch(ptypes[1], ptypes[0])
    assert _name(ppc) == _name(jpc) and ppc is not None
    assert _name(conditionals.conditional.dispatch(object, *ptypes, object)) == \
        _name(gpflow_tpu.conditionals.conditional.dispatch(object, *jtypes, object))
    assert _name(covariances.Kuu.dispatch(*ptypes)) == _name(gpflow_tpu.covariances.Kuu.dispatch(*jtypes))
    assert _name(covariances.Kuf.dispatch(*ptypes, object)) == \
        _name(gpflow_tpu.covariances.Kuf.dispatch(*jtypes, object))


# ---------------------------------------------------------------------------
# conditionals


@pytest.mark.parametrize("q", ["none", "diag", "full"])
@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("full_cov,full_output_cov", COV)
@pytest.mark.parametrize("iv_kind,k_kind", ROUTES, ids=ROUTE_IDS)
def test_conditional_routes_match_jax(iv_kind, k_kind, full_cov, full_output_cov, white, q):
    (jiv, jk), (piv, pk) = _pair(iv_kind, k_kind)
    f, q_sqrt = _variational(iv_kind, k_kind, q, seed=3 * ROUTES.index((iv_kind, k_kind)) + ["none", "diag", "full"].index(q))
    want = gpflow_tpu.conditionals.conditional(X, jiv, jk, f, full_cov=full_cov, full_output_cov=full_output_cov,
                                               q_sqrt=q_sqrt, white=white)
    with torch.no_grad():
        got = conditionals.conditional(_t(X), piv, pk, _t(f), full_cov=full_cov, full_output_cov=full_output_cov,
                                       q_sqrt=_t(q_sqrt), white=white)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("q", ["none", "diag", "full"])
def test_separate_independent_implementation_inv_solve_and_batch_match_jax(q, full_cov):
    """The batched per-output conditional on both routes (N > M takes the
    INV_SOLVE inverse), with a batch dimension in Kmns, against the JAX
    package's map of ``base_conditional`` over P."""
    rng = np.random.RandomState(11)
    jk = _kernel(gpflow_tpu, "separate")
    Xb = rng.randn(2, 8, D)  # N = 8 > M = 5
    Kmms = np.stack([np.asarray(k.K(ZS[i])) + 1e-6 * np.eye(M) for i, k in enumerate(jk.kernels)])
    Kmns = np.stack([np.asarray(k.K(ZS[i], Xb)) for i, k in enumerate(jk.kernels)])  # [P, M, 2, 8]
    Knns = np.stack([np.asarray(k.K(Xb) if full_cov else k.K_diag(Xb)) for k in jk.kernels])
    f = rng.randn(M, P)
    q_sqrt = {"none": None, "diag": 0.5 + rng.rand(M, P), "full": _lower(rng, P, M)}[q]
    for flag in (False, True):
        for white in (True, False):
            with gpflow_tpu.conditionals.util.inv_solve(flag):
                want = gpflow_tpu.conditionals.util.separate_independent_conditional_implementation(
                    Kmns, Kmms, Knns, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white)
            with putil.inv_solve(flag), torch.no_grad():
                got = putil.separate_independent_conditional_implementation(
                    _t(Kmns), _t(Kmms), _t(Knns), _t(f), full_cov=full_cov, q_sqrt=_t(q_sqrt), white=white)
            for g, w in zip(got, want):
                _close(g, w)


# ---------------------------------------------------------------------------
# posteriors


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("full_cov,full_output_cov", COV)
@pytest.mark.parametrize("iv_kind,k_kind", ROUTES, ids=ROUTE_IDS)
def test_cached_and_fused_posteriors_match_jax(iv_kind, k_kind, full_cov, full_output_cov, whiten):
    (jiv, jk), (piv, pk) = _pair(iv_kind, k_kind)
    q_mu, q_sqrt = _variational(iv_kind, k_kind, "full", seed=5)
    jp = gpflow_tpu.posteriors.create_posterior(jk, jiv, q_mu, q_sqrt, whiten,
                                                precompute_cache=gpflow_tpu.posteriors.PrecomputeCacheType.TENSOR)
    with torch.no_grad():
        pp = posteriors.create_posterior(pk, piv, _t(q_mu), _t(q_sqrt), whiten)
        assert type(pp).__name__ == type(jp).__name__
        for a, b in zip(pp.cache, jp.cache):
            _close(a, b)
        cached = pp.predict_f(_t(X), full_cov=full_cov, full_output_cov=full_output_cov)
        fused = pp.fused_predict_f(_t(X), full_cov=full_cov, full_output_cov=full_output_cov)
        mean = pp.predict_mean(_t(X))
    for got, want in zip(cached, jp.predict_f(X, full_cov=full_cov, full_output_cov=full_output_cov)):
        _close(got, want)
    for got, want in zip(fused, jp.fused_predict_f(X, full_cov=full_cov, full_output_cov=full_output_cov)):
        _close(got, want)
    _close(mean, jp.predict_mean(X))


@pytest.mark.parametrize("q", ["none", "diag"])
@pytest.mark.parametrize("iv_kind,k_kind", [("separate", "lmc"), ("fb_separate", "lmc"), ("ip", "shared")])
def test_posterior_cache_without_full_q_sqrt_matches_jax(iv_kind, k_kind, q):
    """The cache with q_sqrt None (the delta distribution, its identity
    broadcast over [L, M, M]) and diagonal."""
    (jiv, jk), (piv, pk) = _pair(iv_kind, k_kind)
    q_mu, q_sqrt = _variational(iv_kind, k_kind, q, seed=6)
    for whiten in (True, False):
        jp = gpflow_tpu.posteriors.create_posterior(jk, jiv, q_mu, q_sqrt, whiten)
        with torch.no_grad():
            pp = posteriors.create_posterior(pk, piv, _t(q_mu), _t(q_sqrt), whiten)
            for a, b in zip(pp.cache, jp.cache):
                _close(a, b)
            for got, want in zip(pp.predict_f(_t(X)), jp.predict_f(X)):
                _close(got, want)


def test_base_case_posterior_serves_any_inducing_variables():
    """The single-output posterior is registered on (Kernel,
    InducingVariables), as in the JAX package: an SVGP on Multiscale
    inducing variables has a posterior class."""
    from gpflow_tpu_torch.inducing_variables import InducingVariables, Multiscale

    assert posteriors.get_posterior_class.dispatch(gpflow_tpu_torch.kernels.Kernel, InducingVariables) is not None
    cls = posteriors.get_posterior_class(_kernel(gpflow_tpu_torch, "se"), Multiscale(ZS[0], 0.3 + ZS[1] ** 2))
    assert cls is posteriors.IndependentPosteriorSingleOutput


# ---------------------------------------------------------------------------
# SVGP on every route


def _svgp(pkg, iv_kind, k_kind, whiten, seed):
    rng = np.random.RandomState(seed)
    Xd = rng.randn(12, D)
    Y = np.sin(Xd @ rng.randn(D, P)) + 0.1 * rng.randn(12, P)
    n = LATENTS[k_kind]
    q_mu, q_sqrt = _variational(iv_kind, k_kind, "full", seed + 1)
    model = pkg.models.SVGP(_kernel(pkg, k_kind), pkg.likelihoods.Gaussian(0.3), _iv(pkg, iv_kind, n),
                            num_latent_gps=q_mu.shape[1], q_mu=q_mu, q_sqrt=q_sqrt, whiten=whiten, num_data=40)
    return model, (Xd, Y)


@functools.lru_cache(maxsize=None)
def _jax_svgp(iv_kind, k_kind, whiten):
    """The JAX package's SVGP of a route, its data, its trainable paths and,
    from one jitted program, its ELBO's value and gradients, its prior KL,
    ``predict_y`` at X and ``predict_log_density``: computed once per route
    for the module (the INV_SOLVE tests reuse the solve route's)."""
    jm, data = _svgp(gpflow_tpu, iv_kind, k_kind, whiten, seed=21)
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    loss = jax.value_and_grad(functionalize(lambda: jm.training_loss(data), [jparams[p] for p in paths]))
    outputs = reference_jit(lambda u: (loss(u), jm.prior_kl(), jm.predict_y(X), jm.predict_log_density(data)))(
        tuple(jparams[p].unconstrained_variable for p in paths))
    return jm, data, paths, outputs


def _value_and_grads_against_jax(iv_kind, k_kind, whiten):
    """The SVGP ELBO and the gradient in every trainable parameter, the
    port's after ``load_jax_values`` of the JAX model's values, against the
    JAX package's. Returns the JAX model's other outputs, the port's model
    and the data."""
    jm, data, paths, ((jv, jg), *others) = _jax_svgp(iv_kind, k_kind, whiten)
    pm, _ = _svgp(gpflow_tpu_torch, iv_kind, k_kind, whiten, seed=22)  # other values, replaced by the load
    load_jax_values(pm, read_values(jm))
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    assert sorted(params) == paths
    pdata = tuple(_t(a) for a in data)
    pv = pm.training_loss(pdata)
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths])
    _close(pv.detach(), jv)
    for path, g, w in zip(paths, pg, jg):
        _close(g, w)
    return others, pm, pdata


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("iv_kind,k_kind", ROUTES, ids=ROUTE_IDS)
def test_svgp_elbo_and_gradients_match_jax_after_load(iv_kind, k_kind, whiten):
    (kl, (mean, var), density), pm, pdata = _value_and_grads_against_jax(iv_kind, k_kind, whiten)
    with torch.no_grad():
        _close(pm.prior_kl(), kl)
        for got, want in zip(pm.predict_y(_t(X)), (mean, var)):
            _close(got, want)
        _close(pm.predict_log_density(pdata), density)


INV_SOLVE_ROUTES = [("shared", "shared"), ("separate", "separate"), ("separate", "lmc")]


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("iv_kind,k_kind", INV_SOLVE_ROUTES, ids=[f"{iv}-{k}" for iv, k in INV_SOLVE_ROUTES])
def test_svgp_gradients_on_inv_solve_match_jax(iv_kind, k_kind, whiten):
    """The port's INV_SOLVE route (the batch of 12 points is wider than
    M = 5, so the conditional takes ``chol_and_inverse`` of the [M, M] or
    batched [L, M, M] Kmm) differentiated through that inverse's backward,
    against the JAX package's solve route: the same ELBO and gradients."""
    with putil.inv_solve(True):
        _value_and_grads_against_jax(iv_kind, k_kind, whiten)


def test_parameter_paths_of_list_held_children():
    """The paths of the slice's list-held children read as the JAX
    package's ``read_values`` keys."""
    jm, _ = _svgp(gpflow_tpu, "separate", "lmc", True, seed=23)
    pm, _ = _svgp(gpflow_tpu_torch, "separate", "lmc", True, seed=23)
    keys = sorted(parameter_dict(pm))
    assert keys == sorted(read_values(jm))
    for path in (".kernel.W", ".kernel.kernels[1].lengthscales", ".inducing_variable.inducing_variable_list[1].Z"):
        assert path in keys
    for iv_kind, k_kind, path in (("shared", "shared", ".kernel.kernel.variance"),
                                  ("fb_shared", "lmc", ".inducing_variable.inducing_variable.Z")):
        jm, _ = _svgp(gpflow_tpu, iv_kind, k_kind, True, seed=24)
        pm, _ = _svgp(gpflow_tpu_torch, iv_kind, k_kind, True, seed=24)
        assert path in parameter_dict(pm) and sorted(parameter_dict(pm)) == sorted(read_values(jm))


# ---------------------------------------------------------------------------
# KL, latent counts and helpers


@pytest.mark.parametrize("q", ["diag", "full"])
def test_fully_correlated_prior_kl_matches_jax(q):
    (jiv, jk), (piv, pk) = _pair("ip", "shared")
    q_mu, q_sqrt = _variational("ip", "shared", q, seed=7)
    want = gpflow_tpu.kullback_leiblers.prior_kl(jiv, jk, q_mu, q_sqrt, whiten=False)
    with torch.no_grad():
        _close(kullback_leiblers.prior_kl(piv, pk, _t(q_mu), _t(q_sqrt), whiten=False), want)


def test_gauss_kl_takes_a_batched_k_matches_jax():
    rng = np.random.RandomState(8)
    K = np.stack([np.asarray(gpflow_tpu.kernels.SquaredExponential(lengthscales=0.5 + i).K(ZS[i])) + 1e-3 * np.eye(M)
                  for i in range(L)])
    q_mu, q_sqrt = rng.randn(M, L), _lower(rng, L, M)
    _close(kullback_leiblers.gauss_kl(_t(q_mu), _t(q_sqrt), _t(K)), gpflow_tpu.kullback_leiblers.gauss_kl(q_mu, q_sqrt, K))


@pytest.mark.parametrize("k_kind", GRID_KERNELS)
@pytest.mark.parametrize("lik", ["Gaussian", "Switched"])
def test_calc_num_latent_gps_matches_jax(k_kind, lik):
    def make(pkg):
        likelihood = pkg.likelihoods.Gaussian() if lik == "Gaussian" else \
            pkg.likelihoods.SwitchedLikelihood([pkg.likelihoods.Gaussian(), pkg.likelihoods.Gaussian()])
        return _kernel(pkg, k_kind), likelihood

    want = gpflow_tpu.models.GPModel.calc_num_latent_gps(*make(gpflow_tpu), 4)
    assert gpflow_tpu_torch.models.GPModel.calc_num_latent_gps(*make(gpflow_tpu_torch), 4) == want
    assert want == (LATENTS[k_kind] if k_kind != "se" else (4 if lik == "Gaussian" else 3))


@pytest.mark.parametrize("batch", [False, True])
@pytest.mark.parametrize("full_cov,full_output_cov", COV)
def test_mix_latent_gp_matches_jax(full_cov, full_output_cov, batch):
    rng = np.random.RandomState(12)
    lead = (2,) if batch else ()
    g_mean = rng.randn(*lead, N, L)
    g_var = rng.rand(L, *lead, N, N) if full_cov else rng.rand(*lead, N, L)
    want = gpflow_tpu.conditionals.util.mix_latent_gp(W_LMC, g_mean, g_var, full_cov, full_output_cov)
    got = putil.mix_latent_gp(_t(W_LMC), _t(g_mean), _t(g_var), full_cov, full_output_cov)
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("rolls", [1, 2, 3])
def test_rollaxis_matches_jax(rolls):
    A = np.random.RandomState(13).randn(2, 3, 4, 5)
    for fn in ("rollaxis_left", "rollaxis_right"):
        _close(getattr(putil, fn)(_t(A), rolls), getattr(gpflow_tpu.conditionals.util, fn)(A, rolls))


@pytest.mark.parametrize("perm", [[..., -1, -2], [..., -3, -1, -2], [..., -4, -2, -3, -1], [..., -2, -1, -3]],
                         ids=str)
def test_leading_transpose_matches_jax(perm):
    A = np.random.RandomState(13).randn(2, 3, 4, 5)
    _close(leading_transpose(_t(A), perm), gpflow_tpu.utilities.ops.leading_transpose(A, perm))


@pytest.mark.parametrize("iv_kind,k_kind", [("separate", "lmc"), ("shared", "shared"), ("fb_separate", "lmc"),
                                            ("ip", "shared")])
def test_routes_pass_their_shape_contracts(iv_kind, k_kind):
    """The JAX package's contracts, switched on in the port, hold on the
    fused and cached routes at every (full_cov, full_output_cov)."""
    _, (piv, pk) = _pair(iv_kind, k_kind)
    q_mu, q_sqrt = _variational(iv_kind, k_kind, "full", seed=14)
    set_enable_check_shapes(True)
    try:
        with torch.no_grad():
            post = posteriors.create_posterior(pk, piv, _t(q_mu), _t(q_sqrt), True)
            for full_cov, full_output_cov in COV:
                post.fused_predict_f(_t(X), full_cov=full_cov, full_output_cov=full_output_cov)
                post.predict_f(_t(X), full_cov=full_cov, full_output_cov=full_output_cov)
    finally:
        set_enable_check_shapes(False)
