"""The modules of gpflow_tpu_torch against their gpflow_tpu counterparts, in
float64 on the CPU, on the same numpy inputs. Unless a test states
otherwise the tolerance is 1e-10 relative; entries that are zero in exact
arithmetic (the diagonal of a distance matrix, the upper triangle of an
inverse) get an absolute tolerance of 1e-12 times the largest entry."""
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch as gt
from gpflow_tpu import posteriors as jax_posteriors
from gpflow_tpu.conditionals import util as jax_cond
from gpflow_tpu.ops import linalg as jax_linalg
from gpflow_tpu.utilities import ops as jax_ops
from gpflow_tpu_torch import posteriors
from gpflow_tpu_torch.conditionals import util as cond
from gpflow_tpu_torch.ops import linalg
from .test_torch_environment import one_thread  # noqa: F401

gt.config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = want.detach().numpy() if isinstance(want, torch.Tensor) else want
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * max(np.max(np.abs(want)), 1.0))


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _spd(rng, M):
    A = rng.randn(M, M)
    return A @ A.T + M * np.eye(M)


def _lower(rng, *shape):
    L = np.tril(0.3 * rng.randn(*shape))
    idx = np.arange(shape[-1])
    L[..., idx, idx] = 0.5 + rng.rand(*shape[:-1])
    return L


# --- utilities/ops.py ---------------------------------------------------------


@pytest.mark.parametrize("xshape,x2shape", [((20, 3), None), ((20, 3), (15, 3)),
                                            ((2, 7, 4), (5, 4)), ((6, 1), (3, 2, 1))])
def test_square_distance(xshape, x2shape):
    rng = np.random.RandomState(0)
    X = rng.randn(*xshape)
    X2 = None if x2shape is None else rng.randn(*x2shape)
    _close(gt.utilities.square_distance(_t(X), None if X2 is None else _t(X2)),
           jax_ops.square_distance(X, X2))


# --- bijectors.py, base.py, config --------------------------------------------


def test_softplus_and_shift_match_jax_bijectors():
    x = np.linspace(-30.0, 30.0, 61)
    jax_b = gpflow_tpu.bijectors.positive(lower=1e-6)
    b = gt.bijectors.positive(lower=1e-6)
    _close(b.forward(_t(x)), jax_b.forward(x))
    y = np.linspace(1e-3, 40.0, 50)
    _close(b.inverse(_t(y)), jax_b.inverse(y))


def test_triangular_mask_reads_lower_triangle():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 5)
    _close(gt.bijectors.triangular().forward(_t(x)), gpflow_tpu.bijectors.triangular().forward(x))


def test_parameter_constrained_round_trip_and_dtype():
    p = gt.Parameter(0.5, transform=gt.bijectors.positive(), name="v")
    assert p.dtype == torch.float64 and p.shape == ()
    assert abs(float(p.value) - 0.5) < 1e-15
    p32 = gt.Parameter(np.ones(3, np.float32), name="w")
    assert p32.dtype == torch.float32
    p.assign(2.0)
    assert abs(float(p.value) - 2.0) < 1e-15
    assert isinstance(p.unconstrained, torch.nn.Parameter)


@pytest.mark.parametrize("bad,match", [(np.ones(2), "shape"), (np.nan, "NaN"), (-1.0, "NaN")])
def test_parameter_assign_rejects_and_keeps_value(bad, match):
    p = gt.Parameter(0.5, transform=gt.bijectors.positive(), name="v")
    with pytest.raises(ValueError, match=match):
        p.assign(bad)
    assert abs(float(p.value) - 0.5) < 1e-15


def test_config_jitter_follows_the_float_type():
    from gpflow_tpu_torch import config

    with config.as_context():
        assert config.default_float() == torch.float64 and config.default_jitter() == 1e-6
        config.set_default_float(np.float32)
        assert config.default_float() == torch.float32 and config.default_jitter() == 1e-4
        config.set_default_float(torch.float64)
        assert config.default_jitter() == 1e-6
        config.set_default_jitter(1e-3)
        config.set_default_float(torch.float32)
        assert config.default_jitter() == 1e-3
    assert config.default_jitter() == 1e-6
    assert config.Config(float=torch.float32).jitter == 1e-4
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


# --- ops/linalg.py ----------------------------------------------------------------


@pytest.mark.parametrize("batch", [(), (3,)])
def test_chol_and_inverse(batch):
    rng = np.random.RandomState(2)
    K = np.stack([_spd(rng, 12) for _ in range(int(np.prod(batch)))]).reshape(batch + (12, 12))
    L, Linv = linalg.chol_and_inverse(_t(K))
    jL, jLinv = jax_linalg.chol_and_inverse(K)
    _close(L, jL)
    _close(Linv, jLinv)


def test_triangular_inverse():
    L = _lower(np.random.RandomState(3), 2, 10, 10)
    _close(linalg.triangular_inverse(_t(L)), jax_linalg.triangular_inverse(L))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_sym_jitter(dtype):
    A = np.random.RandomState(4).randn(2, 6, 6).astype(dtype)
    got = linalg.sym_jitter(_t(A))
    rtol = RTOL if dtype == np.float64 else 1e-6  # f32: one rounding per entry
    _close(got, jax_linalg.sym_jitter(A), rtol=rtol)


# --- kernels, inducing variables, covariances ---------------------------------


def _kernels(rng, n_lengthscales, active_dims=None):
    ls = 0.5 + rng.rand(n_lengthscales)
    kw = {} if active_dims is None else {"active_dims": active_dims}
    return (gpflow_tpu.kernels.SquaredExponential(variance=1.3, lengthscales=ls, **kw),
            gt.kernels.SquaredExponential(variance=1.3, lengthscales=ls, **kw))


@pytest.mark.parametrize("active_dims", [None, [0, 2], slice(1, 3)])
def test_squared_exponential_call(active_dims):
    rng = np.random.RandomState(5)
    X, X2 = rng.randn(15, 3), rng.randn(11, 3)
    jk, k = _kernels(rng, 3 if active_dims is None else 2, active_dims)
    _close(k(_t(X)), jk(X))
    _close(k(_t(X), _t(X2)), jk(X, X2))
    _close(k(_t(X), full_cov=False), jk(X, full_cov=False))


def test_ard_active_dims_mismatch_raises():
    with pytest.raises(ValueError, match="active_dims"):
        gt.kernels.SquaredExponential(lengthscales=np.ones(3), active_dims=[0, 1])


@pytest.mark.parametrize("M,N,D", [(16, 24, 1), (40, 60, 3), (64, 100, 5)])
def test_kuu_and_kuf(M, N, D):
    rng = np.random.RandomState(M)
    Z, X = rng.rand(M, D) * 4, rng.rand(N, D) * 4
    jk, k = _kernels(rng, D)
    jiv, iv = gpflow_tpu.inducing_variables.InducingPoints(Z), gt.inducing_variables.InducingPoints(Z)
    _close(gt.covariances.Kuu(iv, k, jitter=1e-6), gpflow_tpu.covariances.Kuu(jiv, jk, jitter=1e-6))
    _close(gt.covariances.Kuf(iv, k, _t(X)), gpflow_tpu.covariances.Kuf(jiv, jk, X))


def test_kuu_dispatch_on_unregistered_types_raises():
    with pytest.raises(NotImplementedError, match="Kuu"):
        gt.covariances.Kuu(object(), object())


# --- conditionals/util.py ----------------------------------------------------------


def _q_sqrt(rng, kind, M, R):
    if kind == "none":
        return None
    if kind == "diag":
        return 0.5 + rng.rand(M, R)
    return _lower(rng, R, M, M)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("white", [True, False])
@pytest.mark.parametrize("q_kind", ["none", "diag", "full"])
@pytest.mark.parametrize("use_inv", [False, True])
def test_base_conditional(use_inv, q_kind, white, full_cov):
    rng = np.random.RandomState(6)
    M, N, R, D = 20, 30, 2, 2  # N > M, so INV_SOLVE takes effect
    Z, X = rng.rand(M, D) * 3, rng.rand(N, D) * 3
    jk, k = _kernels(rng, D)
    Kmm = np.asarray(jk(Z)) + 1e-6 * np.eye(M)
    Kmn = np.asarray(jk(Z, X))
    Knn = np.asarray(jk(X, full_cov=full_cov))
    f = rng.randn(M, R)
    q_sqrt = _q_sqrt(rng, q_kind, M, R)
    with jax_cond.inv_solve(use_inv), cond.inv_solve(use_inv):
        jm, jv = jax_cond.base_conditional(Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white)
        m, v = cond.base_conditional(_t(Kmn), _t(Kmm), _t(Knn), _t(f), full_cov=full_cov,
                                     q_sqrt=None if q_sqrt is None else _t(q_sqrt), white=white)
    _close(m, jm)
    _close(v, jv)


def test_base_conditional_with_leading_dims():
    rng = np.random.RandomState(7)
    M, N, R = 8, 5, 1
    Kmm = _spd(rng, M)
    Kmn = rng.randn(M, 3, N)
    Knn = 10.0 + rng.rand(3, N)
    f, q_sqrt = rng.randn(M, R), _lower(rng, R, M, M)
    jm, jv = jax_cond.base_conditional(Kmn, Kmm, Knn, f, q_sqrt=q_sqrt, white=True)
    m, v = cond.base_conditional(_t(Kmn), _t(Kmm), _t(Knn), _t(f), q_sqrt=_t(q_sqrt), white=True)
    _close(m, jm)
    _close(v, jv)


def test_inv_solve_switch_and_context():
    assert not cond._use_inv_solve()
    with cond.inv_solve():
        assert cond._use_inv_solve()
        with cond.inv_solve(False):
            assert not cond._use_inv_solve()
        assert cond._use_inv_solve()
    assert not cond._use_inv_solve()
    cond.set_inv_solve(True)
    assert cond._use_inv_solve()
    cond.set_inv_solve(None)
    assert not cond._use_inv_solve()


@pytest.mark.parametrize("full_cov,full_output_cov", [(False, True), (True, True), (True, False)])
def test_expand_independent_outputs(full_cov, full_output_cov):
    rng = np.random.RandomState(8)
    fvar = rng.rand(3, 4, 4) if full_cov else rng.rand(4, 3)
    _close(cond.expand_independent_outputs(_t(fvar), full_cov, full_output_cov),
           jax_cond.expand_independent_outputs(fvar, full_cov, full_output_cov))


# --- posteriors.py --------------------------------------------------------------------


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("q_kind", ["none", "diag", "full"])
def test_precompute_alpha_and_qinv(q_kind, whiten):
    rng = np.random.RandomState(9)
    M, D, L = 24, 3, 2
    Z = rng.rand(M, D) * 4
    jk, k = _kernels(rng, D)
    q_mu, q_sqrt = rng.randn(M, L), _q_sqrt(rng, q_kind, M, L)
    jpost = jax_posteriors.create_posterior(
        jk, gpflow_tpu.inducing_variables.InducingPoints(Z), q_mu, q_sqrt, whiten=whiten)
    post = posteriors.create_posterior(
        k, gt.inducing_variables.InducingPoints(Z), _t(q_mu), None if q_sqrt is None else _t(q_sqrt),
        whiten=whiten)
    assert type(post).__name__ == type(jpost).__name__ == "IndependentPosteriorSingleOutput"
    for got, want in zip(post.cache, jpost.cache):
        _close(got, want)


def test_predict_before_cache_raises_and_nocache_uses_fused_route():
    rng = np.random.RandomState(10)
    _, k = _kernels(rng, 2)
    post = posteriors.create_posterior(
        k, gt.inducing_variables.InducingPoints(rng.rand(10, 2)), _t(rng.randn(10, 1)), None,
        whiten=True, precompute_cache=posteriors.PrecomputeCacheType.NOCACHE)
    X = _t(rng.rand(12, 2))
    with pytest.raises(ValueError, match="Cache has not been precomputed"):
        post.predict_f(X)
    mean = post.predict_mean(X)
    post.update_cache(posteriors.PrecomputeCacheType.TENSOR)
    _close(mean, post.predict_mean(X))


@pytest.mark.parametrize("name", ["SGPRPosterior", "VGPPosterior",
                                  "IndependentPosteriorMultiOutput", "FullyCorrelatedPosterior",
                                  "LinearCoregionalizationPosterior", "FallbackIndependentLatentPosterior"])
def test_unported_posteriors_name_the_roadmap(name):
    # Every posterior of the JAX package is ported now and no stub class is
    # left: tests/test_torch_sgpr.py and tests/test_torch_vgp.py hold SGPR's
    # and VGP's, tests/test_torch_multioutput.py the four multioutput ones,
    # to the JAX package.
    assert not hasattr(posteriors, "_NotPortedPosterior")
    cls = getattr(posteriors, name)
    assert issubclass(cls, posteriors.AbstractPosterior) and not cls.__abstractmethods__


# --- likelihoods, functions -----------------------------------------------------------


def test_gaussian_predict_mean_and_var():
    rng = np.random.RandomState(11)
    X, Fmu, Fvar = rng.randn(7, 2), rng.randn(7, 1), rng.rand(7, 1)
    jm, jv = gpflow_tpu.likelihoods.Gaussian(0.3).predict_mean_and_var(X, Fmu, Fvar)
    m, v = gt.likelihoods.Gaussian(0.3).predict_mean_and_var(_t(X), _t(Fmu), _t(Fvar))
    _close(m, jm)
    _close(v, jv)


def test_gaussian_variance_lower_bound():
    with pytest.raises(ValueError):
        gt.likelihoods.Gaussian(1e-7)  # below the default 1e-6 bound
    lik = gt.likelihoods.Gaussian(0.5, variance_lower_bound=0.1)
    assert abs(float(lik.variance.value) - 0.5) < 1e-15


def test_zero_mean_function():
    X = torch.zeros(4, 3, dtype=torch.float32)
    out = gt.functions.Zero(output_dim=2)(X)
    assert out.shape == (4, 2) and out.dtype == torch.float32 and not out.any()
