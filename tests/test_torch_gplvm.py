"""``models.GPLVM``, ``models.BayesianGPLVM``, ``utilities.ops.pca_reduce``
and the psi2 projection of gpflow_tpu_torch against gpflow_tpu, on the CPU,
on the same seeded numpy inputs and, after ``load_jax_values``, the same
parameter values. In float64 the objectives, their gradients with respect to
every trainable parameter (the GPLVM's latent X at ``.data[0]`` among them)
and the predictions agree to 1e-10 relative to the largest entry. The
float32 psi2 projection is held against float64 at a stated tolerance.
Also: sampling without a generator draws anew on every call (F1 in
ROADMAP.md). The JAX side runs under ``jax.jit``."""
import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
import gpflow_tpu_torch
from gpflow_tpu.base import functionalize
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config
from gpflow_tpu_torch.models import GPLVM, BayesianGPLVM
from gpflow_tpu_torch.models.gplvm import _psi2_projection
from gpflow_tpu_torch.optimizers import Scipy
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict
from gpflow_tpu_torch.utilities.ops import pca_reduce
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10
N, P, Q, M, NEW = 16, 5, 2, 6, 4

rng = np.random.RandomState(13)
_t = rng.randn(N, Q)
Y = np.tanh(_t @ rng.randn(Q, P)) + 0.05 * rng.randn(N, P)  # a smooth manifold in P dimensions
XNEW = rng.randn(NEW, Q)


def _close(got, want, rtol=RTOL):
    got, want = (a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in (got, want))
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _value_and_grads(jm, pm, jfn, pfn):
    """The objective and its gradient with respect to every trainable
    parameter's unconstrained value, keyed by path, in both packages."""
    jparams = {p: v for p, v in jax_parameter_dict(jm).items() if v.trainable}
    paths = sorted(jparams)
    jv, jg = reference_jit(jax.value_and_grad(functionalize(jfn, [jparams[p] for p in paths])))(
        tuple(jparams[p].unconstrained_variable for p in paths))
    params = {p: v for p, v in parameter_dict(pm).items() if v.trainable}
    assert sorted(params) == paths
    pv = pfn()
    pg = torch.autograd.grad(pv, [params[p].unconstrained for p in paths])
    return (jv, dict(zip(paths, jg))), (pv.detach(), dict(zip(paths, pg)))


def _check_value_and_grads(jm, pm, jfn, pfn):
    (jv, jg), (pv, pg) = _value_and_grads(jm, pm, jfn, pfn)
    _close(pv, jv)
    for path in jg:
        _close(pg[path], jg[path])
    return jg


@pytest.mark.parametrize("latent_dim", [1, 2, 4])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_pca_reduce_matches_jax(latent_dim, as_tensor):
    want = gpflow_tpu.utilities.ops.pca_reduce(Y, latent_dim)
    got = pca_reduce(torch.from_numpy(Y) if as_tensor else Y, latent_dim)
    assert got.dtype == torch.float64
    _close(got, want)


def test_pca_reduce_rejects_more_latent_dimensions_than_observed():
    with pytest.raises(ValueError, match="more latent dimensions"):
        pca_reduce(Y, P + 1)


def _kernel(pkg, name):
    if name == "SquaredExponential":
        return pkg.kernels.SquaredExponential(variance=1.2, lengthscales=[0.8, 1.3])
    return pkg.kernels.Matern52(variance=0.9, lengthscales=[1.1, 0.7])


def _gplvms(kernel, mean_function=False, pca=False):
    jmf = gpflow_tpu.functions.Linear(rng.randn(Q, P), rng.randn(P)) if mean_function else None
    X0 = None if pca else np.random.RandomState(3).randn(N, Q)
    jm = gpflow_tpu.models.GPLVM(Y, latent_dim=Q, X_data_mean=X0, kernel=_kernel(gpflow_tpu, kernel),
                                 mean_function=jmf)
    jm.likelihood.variance.assign(0.3)
    pmf = gpflow_tpu_torch.functions.Linear(np.zeros((Q, P)), np.zeros(P)) if mean_function else None
    pm = GPLVM(Y, latent_dim=Q, X_data_mean=None if pca else np.zeros((N, Q)), kernel=_kernel(gpflow_tpu_torch, kernel),
               mean_function=pmf)
    return jm, pm


@pytest.mark.parametrize("mean_function", [False, True])
@pytest.mark.parametrize("kernel", ["SquaredExponential", "Matern52"])
def test_gplvm_objective_and_gradients_match_jax(kernel, mean_function):
    jm, pm = _gplvms(kernel, mean_function)
    values = read_values(jm)
    assert ".data[0]" in values and ".data[0]" in parameter_dict(pm)
    load_jax_values(pm, values)
    _close(pm.data[0].value, values[".data[0]"], 0.0)
    jg = _check_value_and_grads(jm, pm, lambda: jm.training_loss(), lambda: pm.training_loss())
    assert float(np.max(np.abs(jg[".data[0]"]))) > 0.0  # X is trainable and the loss moves with it
    _close(pm.log_marginal_likelihood(), reference_jit(lambda: jm.log_marginal_likelihood())())


@pytest.mark.parametrize("full_cov", [False, True])
def test_gplvm_predictions_match_jax(full_cov):
    jm, pm = _gplvms("SquaredExponential")
    load_jax_values(pm, read_values(jm))
    want = reference_jit(lambda: jm.predict_f(XNEW, full_cov=full_cov))()
    got = pm.predict_f(torch.from_numpy(XNEW), full_cov=full_cov)
    _close(got[0], want[0])
    _close(got[1], want[1])
    post = pm.posterior()
    _close(post.predict_f(torch.from_numpy(XNEW), full_cov=full_cov)[0], want[0])


def test_gplvm_starts_from_the_same_pca():
    jm, pm = _gplvms("SquaredExponential", pca=True)
    _close(pm.data[0].value, jm.data[0].value)
    assert pm.data[0].name == "X_data_mean" and pm.data[0].trainable
    X, Y_ = pm.data
    assert X is pm.data[0] and torch.equal(Y_, torch.from_numpy(Y)) and len(pm.data) == 2


def test_gplvm_latent_x_is_trainable_and_moves():
    pm = GPLVM(Y, latent_dim=Q)
    assert any(p is pm.data[0] for p in pm.trainable_parameters)
    before = pm.data[0].numpy()
    Scipy().minimize(pm.training_loss, pm.trainable_variables, options={"maxiter": 3})
    assert not np.allclose(before, pm.data[0].numpy())


def test_gplvm_construction_errors():
    with pytest.raises(ValueError, match="does not match"):
        GPLVM(Y, latent_dim=1, X_data_mean=np.zeros((N, Q)))
    with pytest.raises(ValueError, match="More latent dimensions than observed"):
        GPLVM(Y[:, :1], latent_dim=Q, X_data_mean=np.zeros((N, Q)))


def _bayesian_gplvms(kernel="SquaredExponential", inducing="num", seed=21):
    r = np.random.RandomState(seed)
    X_mean, X_var = r.randn(N, Q), 0.1 + 0.3 * r.rand(N, Q)
    prior = {"X_prior_mean": 0.1 * r.randn(N, Q), "X_prior_var": 0.5 + r.rand(N, Q)}
    spec = {"num_inducing_variables": M} if inducing == "num" else {"inducing_variable": r.randn(M, Q)}
    models = []
    for pkg in (gpflow_tpu, gpflow_tpu_torch):
        np.random.seed(seed)  # Z is picked from numpy's global generator in both
        kern = _kernel(pkg, kernel)
        if kernel == "Sum":
            kern = pkg.kernels.SquaredExponential(lengthscales=[0.9, 1.2]) + pkg.kernels.Linear(variance=0.4)
        models.append(pkg.models.BayesianGPLVM(Y, X_mean, X_var, kern, **spec, **prior))
    jm, pm = models
    _close(pm.inducing_variable.Z.value, jm.inducing_variable.Z.value, 0.0)
    jm.likelihood.variance.assign(0.2)
    load_jax_values(pm, read_values(jm))
    return jm, pm


@pytest.mark.parametrize("inducing", ["num", "given"])
@pytest.mark.parametrize("kernel", ["SquaredExponential", "Sum"])
def test_bayesian_gplvm_elbo_and_gradients_match_jax(kernel, inducing):
    jm, pm = _bayesian_gplvms(kernel, inducing)
    assert {".X_data_mean", ".X_data_var", ".inducing_variable.Z", ".likelihood.variance"} <= set(parameter_dict(pm))
    _check_value_and_grads(jm, pm, lambda: jm.training_loss(), lambda: pm.training_loss())
    _close(pm.elbo(), reference_jit(lambda: jm.elbo())())


@pytest.mark.parametrize("full_cov", [False, True])
def test_bayesian_gplvm_predict_f_matches_jax(full_cov):
    jm, pm = _bayesian_gplvms()
    want = reference_jit(lambda: jm.predict_f(XNEW, full_cov=full_cov))()
    got = pm.predict_f(torch.from_numpy(XNEW), full_cov=full_cov)
    _close(got[0], want[0])
    _close(got[1], want[1])
    with pytest.raises(NotImplementedError):
        pm.predict_log_density((torch.from_numpy(XNEW), torch.zeros(NEW, P, dtype=torch.float64)))


def test_bayesian_gplvm_training_in_float64_raises_the_bound():
    _, pm = _bayesian_gplvms()
    before = float(pm.elbo().detach())
    Scipy().minimize(pm.training_loss, pm.trainable_variables, options={"maxiter": 20})
    assert float(pm.elbo().detach()) > before + 1.0


def test_bayesian_gplvm_construction_errors():
    X_mean, X_var = np.zeros((N, Q)), np.ones((N, Q))
    kern = gpflow_tpu_torch.kernels.SquaredExponential()
    with pytest.raises(ValueError, match="exactly one"):
        BayesianGPLVM(Y, X_mean, X_var, kern)
    with pytest.raises(ValueError, match="exactly one"):
        BayesianGPLVM(Y, X_mean, X_var, kern, num_inducing_variables=M, inducing_variable=np.zeros((M, Q)))
    with pytest.raises(ValueError, match="X_prior_var"):
        BayesianGPLVM(Y, X_mean, X_var, kern, num_inducing_variables=M, X_prior_var=np.array([0.5, 0.5]))
    with pytest.raises(ValueError, match="X_prior_mean"):
        BayesianGPLVM(Y, X_mean, X_var, kern, num_inducing_variables=M, X_prior_mean=np.zeros(Q))
    m = BayesianGPLVM(Y, X_mean, X_var, kern, num_inducing_variables=M,
                      X_prior_mean=np.zeros((N, Q)), X_prior_var=0.5 * np.ones((N, Q)))
    assert np.isfinite(float(m.elbo().detach()))


# The float32 projection against float64 on the same psi2 and L: its value
# comes from psi2's eigenvalues clipped at 0 and differs from the float64
# solves by float32's rounding times cond(Kuu) (the JAX package's docstring:
# ~1e-3 relative); the limit is 1e-3 of the largest entry.
PROJECTION_F32_RTOL = 1e-3


def _projection_inputs():
    _, pm = _bayesian_gplvms(seed=4)
    pX = gpflow_tpu_torch.probability_distributions.DiagonalGaussian(pm.X_data_mean.value, pm.X_data_var.value)
    with torch.no_grad():
        _, psi2 = pm._psi_statistics(pX)
        L = torch.linalg.cholesky(gpflow_tpu_torch.covariances.Kuu(pm.inducing_variable, pm.kernel, jitter=1e-6))
    return psi2, L


def test_psi2_projection_float32_value_and_gradient():
    psi2, L = _projection_inputs()
    want = torch.linalg.solve_triangular(L, torch.linalg.solve_triangular(L, psi2, upper=False).mT, upper=False)
    _close(_psi2_projection(L, psi2), want, 0.0)  # float64: the two solves, unchanged
    psi2_32 = psi2.float().requires_grad_()
    got = _psi2_projection(L.float(), psi2_32)
    assert got.dtype == torch.float32
    _close(got.double(), want, PROJECTION_F32_RTOL)
    eye = torch.eye(M, dtype=torch.float32)
    assert torch.all(torch.isfinite(torch.linalg.cholesky_ex(got.detach() / 0.2 + eye)[0]))
    # the gradient is that of the two solves
    W = torch.from_numpy(np.random.RandomState(2).randn(M, M).astype(np.float32))
    (grad,) = torch.autograd.grad(torch.sum(W * got), [psi2_32])
    solves = torch.linalg.solve_triangular(L.float(), torch.linalg.solve_triangular(
        L.float(), psi2_32, upper=False).mT, upper=False)
    (want_grad,) = torch.autograd.grad(torch.sum(W * solves), [psi2_32])
    _close(grad, want_grad, 0.0)
    # and the JAX package's float32 projection agrees within the same limit
    from gpflow_tpu.models.gplvm import _psi2_projection as jax_projection

    jax_got = reference_jit(jax_projection)(L.float().numpy(), psi2.float().numpy())
    _close(got, np.asarray(jax_got), PROJECTION_F32_RTOL)


def test_bayesian_gplvm_float32_bound_close_to_float64():
    jm, pm = _bayesian_gplvms(seed=6)
    values = read_values(jm)
    with config.as_context(config.Config(float=torch.float32, device="cpu")):
        np.random.seed(6)
        m32 = BayesianGPLVM(Y.astype(np.float32), pm.X_data_mean.numpy().astype(np.float32),
                            pm.X_data_var.numpy().astype(np.float32),
                            gpflow_tpu_torch.kernels.SquaredExponential(lengthscales=[1.0, 1.0]),
                            inducing_variable=pm.inducing_variable.Z.numpy().astype(np.float32),
                            X_prior_mean=pm.X_prior_mean.numpy(), X_prior_var=pm.X_prior_var.numpy())
        load_jax_values(m32, values)
        loss32 = m32.training_loss()
        grads = torch.autograd.grad(loss32, [p.unconstrained for p in m32.trainable_parameters])
    loss64 = float(pm.training_loss())
    assert loss32.dtype == torch.float32 and np.isfinite(float(loss32))
    # the jitters differ (1e-4 against 1e-6) as well as the precision
    assert abs(float(loss32) - loss64) / abs(loss64) < 0.05
    assert all(bool(torch.all(torch.isfinite(g))) for g in grads)


# --- F1: sampling without a generator draws anew on every call


def test_predict_f_samples_draw_anew_without_a_generator():
    jm, pm = _gplvms("SquaredExponential")
    load_jax_values(pm, read_values(jm))
    Xnew = torch.from_numpy(XNEW)
    first = pm.predict_f_samples(Xnew, num_samples=3)
    second = pm.predict_f_samples(Xnew, num_samples=3)
    assert first.shape == second.shape == (3, NEW, P)
    assert not torch.equal(first, second)
    seeded = [pm.predict_f_samples(Xnew, num_samples=3, generator=torch.Generator().manual_seed(9)) for _ in range(2)]
    assert torch.equal(seeded[0], seeded[1])
    # and the JAX package's two calls without a key differ too
    assert not np.array_equal(np.asarray(jm.predict_f_samples(XNEW, num_samples=3)),
                              np.asarray(jm.predict_f_samples(XNEW, num_samples=3)))


def test_sample_conditional_draws_anew_without_a_generator():
    from gpflow_tpu_torch.conditionals import sample_conditional

    r = np.random.RandomState(5)
    iv = gpflow_tpu_torch.inducing_variables.InducingPoints(r.randn(M, Q))
    k = gpflow_tpu_torch.kernels.SquaredExponential()
    q_mu, q_sqrt = torch.from_numpy(r.randn(M, 2)), torch.from_numpy(np.tril(r.randn(2, M, M)))
    draws = [sample_conditional(torch.from_numpy(XNEW), iv, k, q_mu, q_sqrt=q_sqrt, num_samples=2)[0]
             for _ in range(2)]
    assert not torch.equal(draws[0], draws[1])
