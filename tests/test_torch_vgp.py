"""VGP, VGP_deprecated, VGPOpperArchambeau, update_vgp_data, VGPPosterior,
conditionals.conditional, SVGP_deprecated and the model helpers of
``models.util`` in gpflow_tpu_torch against gpflow_tpu, on the CPU, on the
same seeded numpy inputs and values. In float64 the ELBOs, their gradients
with respect to every trainable parameter and the predictions agree to
1e-10 relative to the largest entry. Also: one natural-gradient step takes
the VGP to the GPR's marginal likelihood (rtol 1e-7, the JAX package's own
identity), the float32 VGP agrees with float64 within a limit scaled by the
conditioning, and the parameter paths of every model of the earlier slices
are unchanged."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, conditionals, models, posteriors
from gpflow_tpu_torch.optimizers import NaturalGradient
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
N, D, NEW = 30, 2, 7


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _data(kind, seed=0, P=1):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, D) * 3.0
    F = np.sin(2.0 * X[:, :1]) + 0.3 * np.cos(X[:, 1:])
    if kind == "classification":
        Y = (F + 0.3 * rng.randn(N, P) > 0).astype(float)
    else:
        Y = F + 0.1 * rng.randn(N, P)
    return X, Y, rng.rand(NEW, D) * 3.0


def _parts(pkg, kernel, likelihood, mean):
    k = {"SE + Linear": lambda: pkg.kernels.SquaredExponential(lengthscales=[0.8, 1.3]) + pkg.kernels.Linear(0.3),
         "Matern52": lambda: pkg.kernels.Matern52(variance=1.2, lengthscales=0.9),
         "Periodic": lambda: pkg.kernels.Periodic(pkg.kernels.SquaredExponential(), period=1.7)}[kernel]()
    lik = {"Gaussian": lambda: pkg.likelihoods.Gaussian(0.2), "Bernoulli": pkg.likelihoods.Bernoulli}[likelihood]()
    mf = {"Zero": lambda: None, "Constant": lambda: pkg.functions.Constant(np.array([0.3])),
          "Linear": lambda: pkg.functions.Linear(A=np.array([[0.2], [-0.1]]), b=np.array([0.05]))}[mean]()
    return k, lik, mf


def _random_variational(jm, seed):
    """Assigns q_mu / q_sqrt (or q_alpha / q_lambda) away from their start."""
    rng = np.random.RandomState(seed)
    if hasattr(jm, "q_alpha"):
        jm.q_alpha.assign(0.3 * rng.randn(*jm.q_alpha.shape))
        jm.q_lambda.assign(0.5 + rng.rand(*jm.q_lambda.shape))
        return
    L = np.tril(0.1 * rng.randn(*jm.q_sqrt.shape), k=-1)
    idx = np.arange(L.shape[-1])
    L[..., idx, idx] = 0.4 + 0.6 * rng.rand(*L.shape[:-1])
    jm.q_mu.assign(0.5 * rng.randn(*jm.q_mu.shape))
    jm.q_sqrt.assign(L)


def _models(cls, kernel="SE + Linear", likelihood="Gaussian", mean="Zero", kind="regression", seed=0, P=1):
    X, Y, Xnew = _data(kind, seed, P)
    jk, jl, jmf = _parts(gpflow_tpu, kernel, likelihood, mean)
    pk, pl, pmf = _parts(gpflow_tpu_torch, kernel, likelihood, mean)
    jm = getattr(gpflow_tpu.models, cls)((X, Y), kernel=jk, likelihood=jl, mean_function=jmf)
    pm = getattr(models, cls)((X, Y), kernel=pk, likelihood=pl, mean_function=pmf)
    _random_variational(jm, seed + 100)
    load_jax_values(pm, read_values(jm))
    return jm, pm, X, Y, Xnew


def _value_and_grads(jm, pm, jfn, pfn):
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    jv, jg = reference_jit(jax.value_and_grad(functionalize(jfn, [jparams[p] for p in paths])))(
        tuple(jparams[p].unconstrained_variable for p in paths)
    )
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    assert sorted(params) == paths
    pv = pfn()
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths])
    return (jv, dict(zip(paths, jg))), (pv.detach(), dict(zip(paths, pg)))


def _check_value_and_grads(jm, pm, jfn, pfn, rtol=RTOL):
    (jv, jg), (pv, pg) = _value_and_grads(jm, pm, jfn, pfn)
    _close(pv, jv, rtol)
    for path in jg:
        _close(pg[path], jg[path], rtol)


CASES = [
    ("VGP", "SE + Linear", "Gaussian", "Zero", "regression", 1),
    ("VGP", "SE + Linear", "Bernoulli", "Constant", "classification", 1),
    ("VGP_deprecated", "Matern52", "Gaussian", "Linear", "regression", 2),
    ("VGPOpperArchambeau", "Periodic", "Gaussian", "Constant", "regression", 2),
    ("VGPOpperArchambeau", "Matern52", "Bernoulli", "Zero", "classification", 1),
]


@pytest.mark.parametrize("cls,kernel,likelihood,mean,kind,P", CASES)
def test_elbo_and_gradient_match_jax_f64(cls, kernel, likelihood, mean, kind, P):
    jm, pm, *_ = _models(cls, kernel, likelihood, mean, kind, P=P)
    _check_value_and_grads(jm, pm, jm.training_loss, pm.training_loss)
    elbo, objective = reference_jit(lambda: (jm.elbo(), jm.maximum_log_likelihood_objective()))()
    with torch.no_grad():
        _close(pm.elbo(), elbo)
        _close(pm.maximum_log_likelihood_objective(), objective)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("cls,kernel,likelihood,mean,kind,P", CASES)
def test_predictions_match_jax_f64(cls, kernel, likelihood, mean, kind, P, full_cov):
    jm, pm, X, Y, Xnew = _models(cls, kernel, likelihood, mean, kind, seed=1, P=P)
    want_f, want_y, want_density = reference_jit(lambda: (
        jm.predict_f(Xnew, full_cov=full_cov),
        None if full_cov else jm.predict_y(Xnew),
        None if full_cov else jm.predict_log_density((X[:9], Y[:9]))))()
    with torch.no_grad():
        for got, want in zip(pm.predict_f(_t(Xnew), full_cov=full_cov), want_f):
            _close(got, want)
        if not full_cov:
            for got, want in zip(pm.predict_y(_t(Xnew)), want_y):
                _close(got, want)
            _close(pm.predict_log_density((_t(X[:9]), _t(Y[:9]))), want_density)


@pytest.mark.parametrize("cache", ["tensor", "variable", "nocache", None])
@pytest.mark.parametrize("full_cov", [False, True])
def test_vgp_posterior_every_cache_type_matches_jax_f64(cache, full_cov):
    jm, pm, X, _, Xnew = _models("VGP", "SE + Linear", "Bernoulli", "Constant", "classification", seed=2)
    jp = jm.posterior(gpflow_tpu.posteriors.PrecomputeCacheType.TENSOR)
    with torch.no_grad():
        post = pm.posterior(posteriors.PrecomputeCacheType(cache) if cache else None)
        assert isinstance(post, posteriors.VGPPosterior)
        want = jp.predict_f(Xnew, full_cov=full_cov)
        for got, w in zip(post.fused_predict_f(_t(Xnew), full_cov=full_cov), want):
            _close(got, w)
        if cache in ("tensor", "variable"):
            (Lm,) = post.cache
            _close(Lm, jp.cache[0])
            for got, w in zip(post.predict_f(_t(Xnew), full_cov=full_cov), want):
                _close(got, w)
            _close(post.predict_mean(_t(Xnew)), want[0])
        else:
            assert post.cache is None
            with pytest.raises(ValueError, match="Cache has not been precomputed"):
                post.predict_f(_t(Xnew))
            post.update_cache(posteriors.PrecomputeCacheType.TENSOR)
            for got, w in zip(post.predict_f(_t(Xnew), full_cov=full_cov), want):
                _close(got, w)
        with pytest.raises(NotImplementedError, match="full_output_cov"):
            post.predict_f(_t(Xnew), full_output_cov=True) if post.cache else None


def _lower(rng, R, M):
    L = np.tril(0.2 * rng.randn(R, M, M), k=-1)
    L[:, np.arange(M), np.arange(M)] = 0.5 + rng.rand(R, M)
    return L


@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("q", ["full", "diag", "none"])
@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("registration", ["dense", "sparse"])
def test_conditional_both_registrations_match_jax_f64(registration, full_cov, q, white):
    rng = np.random.RandomState(3)
    M, R = 9, 2
    X, Xnew = rng.rand(M, D) * 2.0, rng.rand(NEW, D) * 2.0
    f = rng.randn(M, R)
    q_sqrt = {"full": _lower(rng, R, M), "diag": 0.5 + rng.rand(M, R), "none": None}[q]
    jk = gpflow_tpu.kernels.Matern32(lengthscales=[0.7, 1.1]) + gpflow_tpu.kernels.White(0.01)
    pk = gpflow_tpu_torch.kernels.Matern32(lengthscales=[0.7, 1.1]) + gpflow_tpu_torch.kernels.White(0.01)
    jz = X if registration == "dense" else gpflow_tpu.inducing_variables.InducingPoints(X)
    pz = _t(X) if registration == "dense" else gpflow_tpu_torch.inducing_variables.InducingPoints(X)
    want = gpflow_tpu.conditionals.conditional(Xnew, jz, jk, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white)
    with torch.no_grad():
        got = conditionals.conditional(_t(Xnew), pz, pk, _t(f), full_cov=full_cov,
                                       q_sqrt=None if q_sqrt is None else _t(q_sqrt), white=white)
    for g, w in zip(got, want):
        _close(g, w)


def test_update_vgp_data_matches_jax_and_replaces_the_parameters():
    """The refit solves against chol(K(X2) + 1e-6 I): its float64 rounding
    grows as cond(K(X2) + 1e-6 I) * eps64, so the new q_mu and q_sqrt, and
    what follows from them, agree within 10 * cond * eps64 (measured)."""
    jm, pm, X, Y, Xnew = _models("VGP", "SE + Linear", "Gaussian", "Constant", seed=4)
    rng = np.random.RandomState(5)
    X2 = np.concatenate([X, rng.rand(6, D) * 3.0])
    Y2 = np.concatenate([Y, rng.randn(6, 1)])
    old_q_mu, old_q_sqrt = pm.q_mu, pm.q_sqrt
    gpflow_tpu.models.update_vgp_data(jm, (X2, Y2))
    models.update_vgp_data(pm, (X2, Y2))
    assert pm.q_mu is not old_q_mu and pm.q_sqrt is not old_q_sqrt
    assert pm.num_data == N + 6 and tuple(pm.q_sqrt.shape) == (1, N + 6, N + 6)
    assert pm.q_mu in pm.trainable_variables and old_q_mu not in pm.trainable_variables
    assert set(parameter_dict(pm)) == set(read_values(jm))
    eig = np.linalg.eigvalsh(np.asarray(jm.kernel(X2)) + 1e-6 * np.eye(len(X2)))
    tol = max(RTOL, 10 * eig[-1] / eig[0] * np.finfo(np.float64).eps)
    _close(pm.q_mu.value, jm.q_mu.value, tol)
    _close(pm.q_sqrt.value, jm.q_sqrt.value, tol)
    _check_value_and_grads(jm, pm, jm.training_loss, pm.training_loss, tol)
    with torch.no_grad():
        for got, want in zip(pm.predict_f(_t(Xnew)), jm.predict_f(Xnew)):
            _close(got, want, tol)


def _svgp(pkg, cls, Z, q_diag, whiten):
    k = pkg.kernels.SquaredExponential(lengthscales=[0.9, 1.2]) + pkg.kernels.Linear(0.2)
    return getattr(pkg.models, cls)(k, pkg.likelihoods.Bernoulli(), Z, mean_function=pkg.functions.Constant(),
                                    q_diag=q_diag, whiten=whiten, num_data=3 * N)


@pytest.mark.parametrize("q_diag,whiten", [(False, True), (True, False)])
def test_svgp_deprecated_equals_svgp_and_matches_jax_f64(q_diag, whiten):
    X, Y, Xnew = _data("classification", 6)
    Z = X[::3].copy()
    jm = _svgp(gpflow_tpu, "SVGP_deprecated", Z, q_diag, whiten)
    rng = np.random.RandomState(7)
    jm.q_mu.assign(0.4 * rng.randn(*jm.q_mu.shape))
    jm.q_sqrt.assign(0.5 + rng.rand(*jm.q_sqrt.shape) if q_diag else _lower(rng, 1, Z.shape[0]))
    values = read_values(jm)
    dep, new = (_svgp(gpflow_tpu_torch, cls, Z, q_diag, whiten) for cls in ("SVGP_deprecated", "SVGP"))
    assert isinstance(new, models.SVGP_with_posterior) and isinstance(new, models.SVGP_deprecated)
    for pm in (dep, new):
        load_jax_values(pm, values)
        _check_value_and_grads(jm, pm, lambda: jm.training_loss((X, Y)), lambda: pm.training_loss((_t(X), _t(Y))))
        with torch.no_grad():
            for full_cov in (False, True):
                for got, want in zip(pm.predict_f(_t(Xnew), full_cov=full_cov), jm.predict_f(Xnew, full_cov=full_cov)):
                    _close(got, want)
    with torch.no_grad():
        for got, want in zip(new.posterior().predict_f(_t(Xnew)), dep.predict_f(_t(Xnew))):
            _close(got, want, 1e-8)  # the (alpha, Qinv) cache's explicit inverse


def test_model_util_helpers_match_the_models():
    jm, pm, X, Y, _ = _models("VGP", "Matern52", "Gaussian", "Constant", seed=8)
    data = (_t(X), _t(Y))
    closure = models.training_loss_closure(pm, data)
    with torch.no_grad():
        _close(closure(), jm.training_loss())
        _close(models.training_loss(pm, data), gpflow_tpu.models.training_loss(jm, (X, Y)))
        _close(models.maximum_log_likelihood_objective(pm, data),
               gpflow_tpu.models.maximum_log_likelihood_objective(jm, (X, Y)))
    svgp = _svgp(gpflow_tpu_torch, "SVGP", X[::4].copy(), False, True)
    jsvgp = _svgp(gpflow_tpu, "SVGP", X[::4].copy(), False, True)
    load_jax_values(svgp, read_values(jsvgp))
    Yc = (Y > 0).astype(float)
    with torch.no_grad():
        _close(models.training_loss_closure(svgp, (_t(X), _t(Yc)))(),
               gpflow_tpu.models.training_loss_closure(jsvgp, (X, Yc))())
        half = N // 2
        batches = iter([(_t(X[:half]), _t(Yc[:half])), (_t(X[half:]), _t(Yc[half:]))])
        step = models.training_loss_closure(svgp, batches)
        _close(step(), jsvgp.training_loss((X[:half], Yc[:half])))
        _close(step(), jsvgp.training_loss((X[half:], Yc[half:])))
        _close(models.maximum_log_likelihood_objective(svgp, (_t(X), _t(Yc))), jsvgp.elbo((X, Yc)))


def test_trainable_variables_cover_every_term():
    _, pm, *_ = _models("VGP", "SE + Linear", "Bernoulli", "Constant", "classification")
    paths = {id(p): path for path, p in parameter_dict(pm).items()}
    assert sorted(paths[id(p)] for p in pm.trainable_variables) == [
        ".kernel.kernels[0].lengthscales", ".kernel.kernels[0].variance", ".kernel.kernels[1].variance",
        ".mean_function.c", ".q_mu", ".q_sqrt",
    ]


def test_natural_gradient_step_takes_vgp_to_gpr_f64():
    """One natural-gradient step of gamma = 1 on a whitened VGP with a
    Gaussian likelihood reaches the exact posterior: the ELBO equals the
    GPR's log marginal likelihood (the JAX package's identity,
    tests/integration/test_method_equivalence.py, with its jitter 1e-10)."""
    X, Y, Xnew = _data("regression", 9)
    kern = lambda: gpflow_tpu_torch.kernels.SquaredExponential(variance=1.2, lengthscales=0.6)  # noqa: E731
    with config.as_context(config.Config(float=torch.float64, device="cpu", jitter=1e-10)):
        vgp = models.VGP((X, Y), kern(), gpflow_tpu_torch.likelihoods.Gaussian(0.05))
        gpr = models.GPR((X, Y), kern(), noise_variance=0.05)
        NaturalGradient(gamma=1.0).minimize(vgp.training_loss, [(vgp.q_mu, vgp.q_sqrt)])
        with torch.no_grad():
            np.testing.assert_allclose(float(vgp.elbo()), float(gpr.log_marginal_likelihood()), rtol=1e-7)
            for got, want in zip(vgp.predict_f(_t(Xnew)), gpr.predict_f(_t(Xnew))):
                np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_float32_vgp_agrees_with_float64_within_its_conditioning():
    """The float32 VGP's ELBO, gradient and predictions against the same
    values in float64, both with the float32 jitter 1e-4. The whitened
    solves carry about cond(K + jitter I) * eps32, then sums over N terms:
    the limit is sqrt(N) * cond * eps32, cond measured here in float64."""
    jm, _, X, Y, Xnew = _models("VGP", "SE + Linear", "Bernoulli", "Constant", "classification", seed=10)
    values = read_values(jm)
    out = {}
    for dtype in (torch.float32, torch.float64):
        with config.as_context(config.Config(float=dtype, device="cpu", jitter=1e-4)):
            k, lik, mf = _parts(gpflow_tpu_torch, "SE + Linear", "Bernoulli", "Constant")
            pm = models.VGP((X, Y), k, lik, mean_function=mf).to(dtype=dtype)  # mf's c was given in float64
            np_dtype = np.float32 if dtype == torch.float32 else np.float64
            load_jax_values(pm, {p: v.astype(np_dtype) for p, v in values.items()})
            params = [p.unconstrained for p in pm.trainable_variables]
            loss = pm.training_loss()
            grads = torch.autograd.grad(loss, params)
            with torch.no_grad():
                mean, var = pm.predict_f(_t(Xnew).to(dtype))
                K = pm.kernel(_t(X).to(dtype))
            out[dtype] = (loss.detach(), grads, mean, var, K)
    eig = torch.linalg.eigvalsh(out[torch.float64][4] + 1e-4 * torch.eye(N, dtype=torch.float64))
    tol = np.sqrt(N) * float(eig[-1] / eig[0]) * float(np.finfo(np.float32).eps)
    (l32, g32, m32, v32, _), (l64, g64, m64, v64, _) = out[torch.float32], out[torch.float64]
    assert l32.dtype == torch.float32 and m32.dtype == torch.float32
    _close(l32.double(), l64, tol)
    for a, b in zip(g32, g64):
        _close(a.double(), b, tol)
    _close(m32.double(), m64, tol)
    _close(v32.double(), v64, tol)


def _earlier_models(pkg, X, Y, Z):
    k = lambda: pkg.kernels.SquaredExponential(lengthscales=[1.0, 1.0])  # noqa: E731
    return {
        "GPR": pkg.models.GPR((X, Y), k(), noise_variance=0.1),
        "SGPR": pkg.models.SGPR((X, Y), k(), Z, noise_variance=0.1),
        "GPRFITC": pkg.models.GPRFITC((X, Y), k(), Z, noise_variance=0.1),
        "CGLB": pkg.models.CGLB((X, Y), k(), Z, noise_variance=0.1),
        "SVGP": pkg.models.SVGP(k(), pkg.likelihoods.Gaussian(0.1), Z),
        "SVGP q_diag": pkg.models.SVGP(k(), pkg.likelihoods.Bernoulli(), Z, q_diag=True, num_data=N),
    }


def test_parameter_paths_of_the_earlier_slices_are_unchanged():
    """The paths of every model ported before VGP (and of VGP) are the JAX
    package's, so ``load_jax_values`` still takes their ``read_values``."""
    X, Y, _ = _data("regression", 11)
    Z = X[::5].copy()
    jms, pms = _earlier_models(gpflow_tpu, X, Y, Z), _earlier_models(gpflow_tpu_torch, X, Y, Z)
    for name in jms:
        values = read_values(jms[name])
        assert sorted(parameter_dict(pms[name])) == sorted(values), name
        assert not any(".mean_function" in p for p in values), name
        load_jax_values(pms[name], values)
