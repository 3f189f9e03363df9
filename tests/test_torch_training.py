"""The training slice of gpflow_tpu_torch against gpflow_tpu on the CPU: the
matmul-only linalg backwards, the Cholesky failure contract, the kernel
classes, the KL and likelihood terms, the SVGP ELBO and its gradient, and the
trainer, each on the same numpy inputs in both packages. Unless a test states
otherwise the tolerance is 1e-10 relative, with 1e-10 times the largest entry
as an absolute floor for entries that cancel towards zero."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpflow_tpu
from gpflow_tpu import kullback_leiblers as jax_kl
from gpflow_tpu import logdensities as jax_logdensities
from gpflow_tpu.base import functionalize
from gpflow_tpu.conditionals import util as jax_cond
from gpflow_tpu.conditionals.util import inv_solve as jax_inv_solve
from gpflow_tpu.models import SVGP as JaxSVGP
from gpflow_tpu.ops import linalg as jax_linalg
from gpflow_tpu.parallel import DataParallelTrainer as JaxTrainer
from gpflow_tpu.parallel import make_mesh
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, kullback_leiblers, likelihoods, logdensities
from gpflow_tpu_torch.conditionals import inv_solve
from gpflow_tpu_torch.conditionals import util as cond
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.ops import linalg
from gpflow_tpu_torch.parallel import DataParallelTrainer, adam
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict, set_trainable
from gpflow_tpu_torch.utilities import read_values as port_read_values

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), requires_grad=requires_grad)


def _lower(rng, *shape):
    L = np.tril(0.3 * rng.randn(*shape))
    idx = np.arange(shape[-1])
    L[..., idx, idx] = 0.5 + rng.rand(*shape[:-1])
    return L


def _spd(rng, *shape):
    A = rng.randn(*shape)
    return A @ np.swapaxes(A, -1, -2) + shape[-1] * np.eye(shape[-1])


# --- ops/linalg.py: the matmul-only backwards ---------------------------------


@pytest.mark.parametrize("batch", [(), (3,)])
def test_triangular_inverse_backward_matches_jax_vjp(batch):
    rng = np.random.RandomState(0)
    L = _lower(rng, *batch, 6, 6)
    dLinv = rng.randn(*batch, 6, 6)
    _, vjp = jax.vjp(jax_linalg.triangular_inverse, jnp.asarray(L))
    Lt = _t(L, True)
    linalg.triangular_inverse(Lt).backward(_t(dLinv))
    _close(Lt.grad, vjp(jnp.asarray(dLinv))[0])
    assert torch.autograd.gradcheck(linalg.triangular_inverse, (_t(L, True),))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_chol_and_inverse_backward_matches_jax_vjp(batch):
    rng = np.random.RandomState(1)
    K = _spd(rng, *batch, 6, 6)
    dL, dLinv = rng.randn(*batch, 6, 6), rng.randn(*batch, 6, 6)
    _, vjp = jax.vjp(jax_linalg.chol_and_inverse, jnp.asarray(K))
    Kt = _t(K, True)
    L, Linv = linalg.chol_and_inverse(Kt)
    torch.autograd.backward((L, Linv), (_t(dL), _t(dLinv)))
    _close(Kt.grad, vjp((jnp.asarray(dL), jnp.asarray(dLinv)))[0])
    # gradcheck through a symmetric positive-definite parametrisation: the
    # pullback returns the symmetric gradient, which a finite difference of
    # one upper entry alone would not see
    A = _t(rng.randn(*batch, 5, 5), True)
    assert torch.autograd.gradcheck(
        lambda A: linalg.chol_and_inverse(A @ A.mT + 5 * torch.eye(5, dtype=A.dtype)), (A,)
    )


def test_chol_and_inverse_one_output_used():
    rng = np.random.RandomState(2)
    K = _spd(rng, 5, 5)
    Kt = _t(K, True)
    linalg.chol_and_inverse(Kt)[1].sum().backward()
    _, vjp = jax.vjp(jax_linalg.chol_and_inverse, jnp.asarray(K))
    _close(Kt.grad, vjp((jnp.zeros((5, 5)), jnp.ones((5, 5))))[0])


# --- the Cholesky failure contract --------------------------------------------


def _indefinite(M=8):
    rng = np.random.RandomState(3)
    Q, _ = np.linalg.qr(rng.randn(M, M))
    return Q @ np.diag(np.linspace(-1.0, 2.0, M)) @ Q.T


@pytest.mark.parametrize("use_inv", [False, True])
def test_base_conditional_on_indefinite_kmm_gives_nan_in_both_packages(use_inv):
    rng = np.random.RandomState(4)
    M, N = 8, 12  # N > M, so INV_SOLVE takes effect
    Kmm, Kmn, Knn, f = _indefinite(M), rng.randn(M, N), rng.rand(N) + 2.0, rng.randn(M, 1)
    with jax_inv_solve(use_inv):
        want = jax_cond.base_conditional(Kmn, Kmm, Knn, f, white=True)
    with inv_solve(use_inv):
        got = cond.base_conditional(_t(Kmn), _t(Kmm), _t(Knn), _t(f), white=True)
    for g, w in zip(got, want):
        assert np.all(np.isnan(np.asarray(w)))
        assert g.shape == w.shape and torch.isnan(g).all()


def test_cholesky_nan_only_for_the_failing_matrices_of_a_batch():
    rng = np.random.RandomState(5)
    K = np.stack([_spd(rng, 8, 8), _indefinite(8)])
    L = linalg.cholesky(_t(K))
    want = np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))
    _close(L[0], want[0])
    np.testing.assert_array_equal(L[1].numpy(), want[1])  # NaN below the diagonal, 0 above
    assert all(torch.isnan(torch.diagonal(x[1])).all() for x in linalg.chol_and_inverse(_t(K)))


# --- kernels/stationaries.py --------------------------------------------------

KERNEL_CLASSES = ["SquaredExponential", "RationalQuadratic", "Exponential", "Matern12", "Matern32", "Matern52"]


@pytest.mark.parametrize("name", KERNEL_CLASSES)
@pytest.mark.parametrize("same", [True, False])
def test_kernel_classes_match_jax_f64(name, same):
    rng = np.random.RandomState(6)
    X, X2 = rng.randn(15, 3), rng.randn(9, 3)
    kw = {"variance": 1.3, "lengthscales": np.array([0.5, 1.0, 2.0])}
    if name == "RationalQuadratic":
        kw["alpha"] = 0.7
    jk = getattr(gpflow_tpu.kernels, name)(**kw)
    pk = getattr(kernels, name)(**kw)
    args = (X,) if same else (X, X2)
    _close(pk(*map(_t, args)), jk(*args))
    _close(pk(_t(X), full_cov=False), jk(X, full_cov=False))


# --- kullback_leiblers.py ------------------------------------------------------


def _kl_inputs(rng, q_diag, K_kind, M=7, L=2):
    q_mu = rng.randn(M, L)
    q_sqrt = 0.5 + rng.rand(M, L) if q_diag else _lower(rng, L, M, M)
    K = {"white": None, "single": _spd(rng, M, M), "batched": _spd(rng, L, M, M)}[K_kind]
    return q_mu, q_sqrt, K


@pytest.mark.parametrize("K_kind,use_cholesky", [("white", False), ("single", False), ("batched", False),
                                                  ("single", True), ("batched", True)])
@pytest.mark.parametrize("q_diag", [True, False])
def test_gauss_kl_value_and_gradient_match_jax(q_diag, K_kind, use_cholesky):
    rng = np.random.RandomState(7)
    q_mu, q_sqrt, K = _kl_inputs(rng, q_diag, K_kind)
    args = [q_mu, q_sqrt] + ([] if K is None else [np.linalg.cholesky(K) if use_cholesky else K])
    key = "K_cholesky" if use_cholesky else "K"

    def jax_fn(*a):
        return jax_kl.gauss_kl(a[0], a[1], **({key: a[2]} if len(a) == 3 else {}))

    want, want_grads = jax.value_and_grad(jax_fn, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
    leaves = [_t(a, True) for a in args]
    got = kullback_leiblers.gauss_kl(leaves[0], leaves[1], **({key: leaves[2]} if len(leaves) == 3 else {}))
    got.backward()
    _close(got, want)
    for t, w in zip(leaves, want_grads):
        if use_cholesky and t is leaves[2]:
            w = np.tril(np.asarray(w))  # a solve reads only the lower triangle of K_cholesky
            _close(torch.tril(t.grad), w)
            continue
        _close(t.grad, w)


def test_gauss_kl_rejects_k_and_k_cholesky_together():
    q_mu, q_sqrt, K = _kl_inputs(np.random.RandomState(8), False, "single")
    with pytest.raises(ValueError, match="Ambiguous"):
        kullback_leiblers.gauss_kl(_t(q_mu), _t(q_sqrt), _t(K), K_cholesky=_t(K))


@pytest.mark.parametrize("whiten", [True, False])
def test_prior_kl_dispatch_matches_jax(whiten):
    rng = np.random.RandomState(9)
    Z, q_mu, q_sqrt = rng.randn(6, 2), rng.randn(6, 1), _lower(rng, 1, 6, 6)
    jk = gpflow_tpu.kernels.Matern32(lengthscales=np.array([0.8, 1.2]))
    pk = kernels.Matern32(lengthscales=np.array([0.8, 1.2]))
    want = jax_kl.prior_kl(gpflow_tpu.inducing_variables.InducingPoints(Z), jk, q_mu, q_sqrt, whiten=whiten)
    from gpflow_tpu_torch.inducing_variables import InducingPoints

    got = kullback_leiblers.prior_kl(InducingPoints(Z), pk, _t(q_mu), _t(q_sqrt), whiten=whiten)
    _close(got, want)


# --- logdensities.py and the Gaussian likelihood ------------------------------


def _lik_inputs(rng, N=11, P=2):
    return rng.randn(N, 3), rng.randn(N, P), rng.rand(N, P) + 0.1, rng.randn(N, P)


def test_logdensities_gaussian_matches_jax():
    rng = np.random.RandomState(10)
    x, mu, var = rng.randn(5, 3), rng.randn(5, 3), rng.rand(5, 3) + 0.2
    _close(logdensities.gaussian(_t(x), _t(mu), _t(var)), jax_logdensities.gaussian(x, mu, var))


@pytest.mark.parametrize("method", ["variational_expectations", "predict_log_density", "log_prob"])
def test_gaussian_likelihood_statistics_match_jax(method):
    rng = np.random.RandomState(11)
    X, Fmu, Fvar, Y = _lik_inputs(rng)
    noise = 0.3
    jl = gpflow_tpu.likelihoods.Gaussian(noise)
    args = (Fmu, Y) if method == "log_prob" else (Fmu, Fvar, Y)

    def jax_fn(noise, *a):
        jl.variance._unconstrained = jl.variance.transform.inverse(noise)
        return jnp.sum(getattr(jl, method)(X, *a))

    want, want_grads = jax.value_and_grad(jax_fn, argnums=tuple(range(len(args) + 1)))(
        jnp.asarray(noise), *map(jnp.asarray, args))
    pl = likelihoods.Gaussian(noise)
    leaves = [_t(a, True) for a in args]
    got = torch.sum(getattr(pl, method)(_t(X), *leaves))
    got.backward()
    _close(got, want)
    # the noise gradient, with respect to its constrained value
    u = pl.variance.unconstrained
    _close(u.grad / torch.sigmoid(u.detach()), want_grads[0])
    for t, w in zip(leaves, want_grads[1:]):
        _close(t.grad, w)


# --- the SVGP ELBO --------------------------------------------------------------

M, N, D = 12, 40, 3


def _svgp_values(rng, q_diag, dtype=np.float64):
    q_sqrt = 0.2 + 0.5 * rng.rand(M, 1) if q_diag else _lower(rng, 1, M, M)
    return {
        ".inducing_variable.Z": (rng.rand(M, D) * 4).astype(dtype),
        ".kernel.lengthscales": (0.8 + 0.6 * rng.rand(D)).astype(dtype),
        ".kernel.variance": np.asarray(1.4, dtype),
        ".likelihood.variance": np.asarray(0.1, dtype),
        ".q_mu": rng.randn(M, 1).astype(dtype),
        ".q_sqrt": q_sqrt.astype(dtype),
    }


def _data(rng, n=N, dtype=np.float64):
    X = (rng.rand(n, D) * 4).astype(dtype)
    Y = (np.sin(X @ np.array([1.0, -0.5, 0.3])) [:, None] + 0.1 * rng.randn(n, 1)).astype(dtype)
    return X, Y


def _models(kernel, whiten, q_diag, seed=0, num_data=1000, dtype=np.float64):
    rng = np.random.RandomState(seed)
    values = _svgp_values(rng, q_diag, dtype)
    kw = dict(inducing_variable=np.zeros((M, D), dtype), whiten=whiten, q_diag=q_diag, num_data=num_data)
    jm = JaxSVGP(kernel=getattr(gpflow_tpu.kernels, kernel)(lengthscales=np.ones(D, dtype)),
                 likelihood=gpflow_tpu.likelihoods.Gaussian(0.5), **kw)
    gpflow_tpu.utilities.multiple_assign(jm, values)
    pm = SVGP(kernel=getattr(kernels, kernel)(lengthscales=np.ones(D, dtype)),
              likelihood=likelihoods.Gaussian(0.5), **kw)
    load_jax_values(pm, read_values(jm))
    return jm, pm, rng


def _jax_elbo_and_grads(jm, data):
    params = jax_parameter_dict(jm)
    paths = [k for k, p in params.items() if p.trainable]
    fn = functionalize(lambda: jm.elbo(data), [params[k] for k in paths])
    value, grads = jax.value_and_grad(fn)([params[k].unconstrained_variable for k in paths])
    return value, dict(zip(paths, grads))


@pytest.mark.parametrize("q_diag", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("route", ["solve", "inv_solve"])
@pytest.mark.parametrize("kernel", ["SquaredExponential", "Matern52"])
def test_elbo_and_gradient_match_jax_f64(kernel, route, whiten, q_diag):
    # the same f64 arithmetic by two routes (XLA autodiff and the port's
    # custom backwards): 1e-8 relative, 1e-8 of the largest entry absolute
    jm, pm, rng = _models(kernel, whiten, q_diag)
    X, Y = _data(rng)
    with jax_inv_solve(route == "inv_solve"):
        want, want_grads = _jax_elbo_and_grads(jm, (X, Y))
    with inv_solve(route == "inv_solve"):
        got = pm.elbo((_t(X), _t(Y)))
    got.backward()
    _close(got, want, rtol=1e-8)
    port_params = parameter_dict(pm)
    assert sorted(want_grads) == sorted(port_params)
    for path, w in want_grads.items():
        _close(port_params[path].unconstrained.grad, w, rtol=1e-8)


def test_training_loss_and_closures():
    jm, pm, rng = _models("Matern52", True, False)
    X, Y = map(_t, _data(rng))
    want = -pm.elbo((X, Y))
    _close(pm.training_loss((X, Y)), want, rtol=1e-14)
    _close(pm.maximum_log_likelihood_objective((X, Y)), -want, rtol=1e-14)
    _close(pm.log_posterior_density((X, Y)), -want, rtol=1e-14)
    _close(pm.training_loss_closure((X, Y))(), want, rtol=1e-14)
    _close(pm.training_loss_closure([X, Y], compile=False)(), want, rtol=1e-14)
    batches = iter([(X[:20], Y[:20]), (X[20:], Y[20:])])
    closure = pm.training_loss_closure(batches)
    _close(closure(), pm.training_loss((X[:20], Y[:20])), rtol=1e-14)
    _close(closure(), pm.training_loss((X[20:], Y[20:])), rtol=1e-14)


# --- the trainer ----------------------------------------------------------------


def _stacked(rng, K=5, B=16):
    X, Y = _data(rng, n=K * B)
    return X.reshape(K, B, D), Y.reshape(K, B, 1)


@pytest.mark.parametrize("kernel", ["SquaredExponential", "Matern52"])
def test_trainer_run_steps_matches_jax_trainer_f64(kernel):
    # Adam is the same formula in both packages, with its operations in a
    # different order: ulp-level differences that five steps carry to about
    # 1e-10, so 1e-7 relative (of the largest entry, absolute) is ample
    jm, pm, rng = _models(kernel, True, False)
    batches = _stacked(rng)
    jt = JaxTrainer(jm, optimizer=optax.adam(1e-2), mesh=make_mesh(num_devices=1))
    want_losses = np.asarray(jt.run_steps(batches))
    jt.finalize()
    pt = DataParallelTrainer(pm)
    got_losses = pt.run_steps(tuple(map(torch.from_numpy, batches)))
    pt.finalize()
    assert got_losses.shape == (5,)
    _close(got_losses, want_losses, rtol=1e-7)
    want, got = read_values(jm), port_read_values(pm)
    assert sorted(want) == sorted(got)
    for k in want:
        _close(got[k], want[k], rtol=1e-7)


def test_trainer_step_and_loss():
    _, pm, rng = _models("SquaredExponential", True, True)
    X, Y = _data(rng)
    pt = DataParallelTrainer(pm, optimizer=adam(1e-2))
    before = pt.loss((X, Y))
    _close(before, pm.training_loss((_t(X), _t(Y))), rtol=1e-14)
    assert pm.q_mu.unconstrained.grad is None  # loss takes no gradient
    _close(pt.step((X, Y)), before, rtol=1e-14)
    assert pt.loss((X, Y)) < before


def test_run_steps_sampled_is_deterministic_per_generator():
    losses, values = [], []
    for _ in range(2):
        _, pm, rng = _models("Matern52", True, False)
        pt = DataParallelTrainer(pm)
        pt.stage_data(_data(rng, n=200))
        out = pt.run_steps_sampled(4, 16, generator=torch.Generator().manual_seed(3))
        assert out.shape == (4,) and torch.isfinite(out).all()
        losses.append(out)
        values.append(port_read_values(pm))
    np.testing.assert_array_equal(losses[0].numpy(), losses[1].numpy())
    for k in values[0]:
        np.testing.assert_array_equal(values[0][k], values[1][k])
    with pytest.raises(ValueError, match="stage_data"):
        DataParallelTrainer(_models("Matern52", True, False)[1]).run_steps_sampled(1, 4)


def test_set_trainable_freezes_parameters():
    _, pm, rng = _models("SquaredExponential", True, False)
    set_trainable(pm.kernel, False)
    set_trainable([pm.inducing_variable.Z], False)
    assert not pm.kernel.lengthscales.trainable and not pm.kernel.lengthscales.unconstrained.requires_grad
    frozen = {k: v for k, v in port_read_values(pm).items() if k.startswith((".kernel", ".inducing"))}
    trainable = {p for p in pm.trainable_parameters}
    assert trainable == {pm.likelihood.variance, pm.q_mu, pm.q_sqrt}
    DataParallelTrainer(pm).run_steps(_stacked(rng, K=2))
    after = port_read_values(pm)
    for k, v in frozen.items():
        np.testing.assert_array_equal(after[k], v)
    set_trainable(pm, False)
    with pytest.raises(ValueError, match="no trainable parameters"):
        DataParallelTrainer(pm)


@pytest.mark.parametrize("kwargs", [{"mesh": object()}, {"natgrad_gamma": 0.1}, {"natgrad_fused": True},
                                    {"latent_axis": "latent"}])
def test_trainer_mesh_and_natgrad_raise(kwargs):
    # a mesh must be a DeviceMesh (tests/test_torch_parallel.py drives real
    # ones), and a latent axis needs a mesh that has it, as in the JAX
    # package; a gamma builds a trainer, and fusing without one raises the
    # JAX package's ValueError
    _, pm, _ = _models("SquaredExponential", True, False)
    if "natgrad_gamma" in kwargs:
        trainer = DataParallelTrainer(pm, **kwargs)
        assert trainer.natgrad_gamma == 0.1 and trainer.natgrad_rejections == 0
    elif "natgrad_fused" in kwargs:
        with pytest.raises(ValueError, match="requires natgrad_gamma"):
            DataParallelTrainer(pm, **kwargs)
    elif "mesh" in kwargs:
        with pytest.raises(TypeError, match="DeviceMesh"):
            DataParallelTrainer(pm, **kwargs)
    else:
        with pytest.raises(ValueError, match="not an axis of the mesh"):
            DataParallelTrainer(pm, **kwargs)
