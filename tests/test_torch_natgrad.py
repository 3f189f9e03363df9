"""Natural gradients in gpflow_tpu_torch against gpflow_tpu on the CPU: the
six Gaussian parameter conversions, ``NaturalGradient`` steps in both xi
parameterizations, the step rejection, the Bernoulli SVGP's ELBO, and the
trainer's fused and sequential natural-gradient modes, each on the same numpy
inputs in both packages, in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.base import functionalize
from gpflow_tpu.models import SGPR as JaxSGPR
from gpflow_tpu.models import SVGP as JaxSVGP
from gpflow_tpu.optimizers import natgrad as jax_natgrad
from gpflow_tpu.parallel import DataParallelTrainer as JaxTrainer
from gpflow_tpu.parallel import make_mesh
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch.bijectors import Identity, triangular
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.optimizers import NaturalGradient, XiNat, natgrad
from gpflow_tpu_torch.parallel import DataParallelTrainer
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict, set_trainable
from gpflow_tpu_torch.utilities import read_values as port_read_values
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _lower(rng, *shape):
    L = np.tril(0.3 * rng.randn(*shape))
    idx = np.arange(shape[-1])
    L[..., idx, idx] = 0.5 + rng.rand(*shape[:-1])
    return L


# --- the six conversions ------------------------------------------------------

CONVERSIONS = ["meanvarsqrt_to_natural", "natural_to_meanvarsqrt", "meanvarsqrt_to_expectation",
               "expectation_to_meanvarsqrt", "natural_to_expectation", "expectation_to_natural"]
INVERSE = {"meanvarsqrt_to_natural": "natural_to_meanvarsqrt", "natural_to_meanvarsqrt": "meanvarsqrt_to_natural",
           "meanvarsqrt_to_expectation": "expectation_to_meanvarsqrt",
           "expectation_to_meanvarsqrt": "meanvarsqrt_to_expectation",
           "natural_to_expectation": "expectation_to_natural", "expectation_to_natural": "natural_to_expectation"}


def _inputs(name, rng, N=6, D=2):
    """Valid inputs of conversion ``name`` in the [N, D] layout: built from
    a mean and a lower-triangular square root of the covariance."""
    mu, L = rng.randn(N, D), _lower(rng, D, N, N)
    if name.startswith("meanvarsqrt"):
        return mu, L
    convert = jax_natgrad.meanvarsqrt_to_natural if name.startswith("natural") else \
        jax_natgrad.meanvarsqrt_to_expectation
    return tuple(np.array(a) for a in convert(mu, L))


@pytest.mark.parametrize("swap", [True, False])
@pytest.mark.parametrize("name", CONVERSIONS)
def test_conversion_matches_jax_and_round_trips_f64(name, swap):
    a, b = _inputs(name, np.random.RandomState(CONVERSIONS.index(name)))
    if not swap:
        a = a.T[:, :, None]
    want = getattr(jax_natgrad, name)(a, b, swap=swap)
    got = getattr(natgrad, name)(torch.from_numpy(a), torch.from_numpy(b), swap=swap)
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-10)
    back = getattr(natgrad, INVERSE[name])(*got, swap=swap)
    _close(back[0], a, rtol=1e-10)
    _close(back[1], b, rtol=1e-10)


# --- the models -------------------------------------------------------------------

N, D, M = 60, 2, 10
_rng = np.random.RandomState(0)
X = _rng.randn(N, D)
Y = np.sin(X[:, :1]) + 0.1 * _rng.randn(N, 1)
Yb = (Y > 0).astype(float)
Z = X[:M].copy()


def _models(likelihood="Gaussian", whiten=True, values=None, num_data=N):
    """A JAX SVGP and its port with the same values: Z = X[:M],
    lengthscales 0.8, and for the Gaussian noise 0.1."""
    jl = gpflow_tpu.likelihoods.Gaussian(0.1) if likelihood == "Gaussian" else gpflow_tpu.likelihoods.Bernoulli()
    pl = likelihoods.Gaussian(0.1) if likelihood == "Gaussian" else likelihoods.Bernoulli()
    jm = JaxSVGP(kernel=gpflow_tpu.kernels.SquaredExponential(lengthscales=0.8), likelihood=jl,
                 inducing_variable=Z.copy(), whiten=whiten, num_data=num_data)
    if values is not None:
        gpflow_tpu.utilities.multiple_assign(jm, values)
    pm = SVGP(kernel=kernels.SquaredExponential(lengthscales=0.8), likelihood=pl,
              inducing_variable=Z.copy(), whiten=whiten, num_data=num_data)
    load_jax_values(pm, read_values(jm))
    return jm, pm


def _q_values(seed):
    rng = np.random.RandomState(seed)
    return {".q_mu": 0.5 * rng.randn(M, 1), ".q_sqrt": _lower(rng, 1, M, M)}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _collapsed_bound(y):
    return float(JaxSGPR((X, y), kernel=gpflow_tpu.kernels.SquaredExponential(lengthscales=0.8),
                         inducing_variable=Z.copy(), noise_variance=0.1).elbo())


def _elbo(pm, y):
    with torch.no_grad():
        return float(pm.elbo((_t(X), _t(y))))


# --- NaturalGradient ----------------------------------------------------------------


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("xi", ["XiNat", "XiSqrtMeanVar"])
def test_natural_gradient_step_matches_jax(xi, whiten):
    # one step on the Bernoulli ELBO (quadrature): the same float64 gradient,
    # conversions and Choleskys in both packages, 1e-8
    jm, pm = _models("Bernoulli", whiten, _q_values(1))
    jax_natgrad.NaturalGradient(0.3, xi_transform=getattr(jax_natgrad, xi)()).minimize(
        lambda: jm.training_loss((X, Yb)), [(jm.q_mu, jm.q_sqrt)])
    NaturalGradient(0.3, xi_transform=getattr(natgrad, xi)()).minimize(
        lambda: pm.training_loss((_t(X), _t(Yb))), [(pm.q_mu, pm.q_sqrt)])
    want, got = read_values(jm), port_read_values(pm)
    for path in (".q_mu", ".q_sqrt"):
        _close(got[path], want[path], rtol=1e-8)
    assert pm.q_mu.unconstrained.grad is None and pm.kernel.variance.unconstrained.grad is None


@pytest.mark.parametrize("tiny_q_sqrt", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
def test_gamma_one_gaussian_reaches_collapsed_bound(whiten, tiny_q_sqrt):
    # tests/gpflow_tpu/test_natural_gradients.py:35 and :95: with a Gaussian
    # likelihood one step of gamma = 1 lands on SGPR's collapsed bound, and
    # a second step is a no-op
    _, pm = _models("Gaussian", whiten)
    if tiny_q_sqrt:
        pm.q_sqrt.assign(1e-5 * np.eye(M)[None])
    optimal = _collapsed_bound(Y)
    before = _elbo(pm, Y)
    for _ in range(2):
        NaturalGradient(gamma=1.0).minimize(lambda: pm.training_loss((_t(X), _t(Y))), [(pm.q_mu, pm.q_sqrt)])
        np.testing.assert_allclose(_elbo(pm, Y), optimal, rtol=1e-8)
    assert optimal > before


def test_minimize_multiple_variational_pairs():
    _, m1 = _models()
    _, m2 = _models()
    Y2 = np.cos(X[:, :1]) + 0.1 * np.random.RandomState(5).randn(N, 1)
    NaturalGradient(gamma=1.0).minimize(
        lambda: m1.training_loss((_t(X), _t(Y))) + m2.training_loss((_t(X), _t(Y2))),
        [(m1.q_mu, m1.q_sqrt), (m2.q_mu, m2.q_sqrt, XiNat())])
    for m, y in ((m1, Y), (m2, Y2)):
        np.testing.assert_allclose(_elbo(m, y), _collapsed_bound(y), rtol=1e-8)


def test_gamma_annealing_is_honoured():
    _, pm = _models()
    optimal = _collapsed_bound(Y)
    opt = NaturalGradient(gamma=0.01)
    loss = lambda: pm.training_loss((_t(X), _t(Y)))  # noqa: E731
    opt.minimize(loss, [(pm.q_mu, pm.q_sqrt)])
    assert abs(_elbo(pm, Y) - optimal) > 1.0  # a small step: far off
    opt.gamma = 1.0
    opt.minimize(loss, [(pm.q_mu, pm.q_sqrt)])
    np.testing.assert_allclose(_elbo(pm, Y), optimal, rtol=1e-8)


@pytest.mark.parametrize("xi", ["XiNat", "XiSqrtMeanVar"])
def test_xi_transforms_agree_to_second_order(xi):
    # any two xi parameterizations take the same step up to O(gamma^2)
    def step(gamma, xi_name):
        _, pm = _models()
        NaturalGradient(gamma, xi_transform=getattr(natgrad, xi_name)()).minimize(
            lambda: pm.training_loss((_t(X), _t(Y))), [(pm.q_mu, pm.q_sqrt)])
        return pm.q_mu.numpy()

    other = "XiSqrtMeanVar" if xi == "XiNat" else "XiNat"
    d3 = np.abs(step(1e-3, xi) - step(1e-3, other)).max()
    d4 = np.abs(step(1e-4, xi) - step(1e-4, other)).max()
    assert d4 < 1e-3 and d3 / d4 > 30


def _guard_values(gamma, q_sqrt_grad_scale):
    """tests/gpflow_tpu/test_natgrad_guard.py:11-22 in both packages."""
    q_mu, q_sqrt = np.zeros((4, 1)), np.eye(4)[None]
    g_mu, g_sqrt = np.ones((4, 1)), q_sqrt_grad_scale * np.eye(4)[None]
    jng = jax_natgrad.NaturalGradient(gamma=gamma)
    want = jng._natgrad_values(jnp.asarray(g_mu), jnp.asarray(g_sqrt), jnp.asarray(q_mu), jnp.asarray(q_sqrt),
                               gpflow_tpu.bijectors.Identity(), gpflow_tpu.bijectors.triangular(), jng.xi_transform)
    png = NaturalGradient(gamma=gamma)
    got = png._natgrad_values_with_ok(_t(g_mu), _t(g_sqrt), _t(q_mu), _t(q_sqrt), Identity(), triangular(),
                                      png.xi_transform)
    return (q_mu, q_sqrt), want, got


def test_sane_step_accepted_as_in_jax():
    _, want, (mean_new, varsqrt_new, ok) = _guard_values(0.1, 0.1)
    assert bool(ok) and ok.dtype == torch.bool and ok.shape == ()
    assert float(mean_new.abs().max()) > 1e-3
    _close(mean_new, want[0], rtol=1e-10)
    _close(varsqrt_new, want[1], rtol=1e-10)


def test_cone_exit_rejected_and_state_unchanged():
    (q_mu, q_sqrt), want, (mean_new, varsqrt_new, ok) = _guard_values(1.0, -100.0)
    assert not bool(ok)
    np.testing.assert_array_equal(mean_new.numpy(), q_mu)
    np.testing.assert_array_equal(varsqrt_new.numpy(), q_sqrt)
    np.testing.assert_array_equal(np.asarray(want[0]), q_mu)
    # through minimize: the parameters keep their values
    _, pm = _models()
    before = port_read_values(pm)
    ok = NaturalGradient(1.0)._natgrad_apply_gradients(
        torch.ones(M, 1, dtype=torch.float64), -100 * torch.eye(M, dtype=torch.float64)[None], pm.q_mu, pm.q_sqrt)
    assert not bool(ok)
    for k, v in port_read_values(pm).items():
        np.testing.assert_array_equal(v, before[k])


def test_natgrad_rejects_diagonal_q_sqrt_and_reports_config():
    pm = SVGP(kernel=kernels.SquaredExponential(), likelihood=likelihoods.Gaussian(0.1),
              inducing_variable=Z.copy(), q_diag=True, num_data=N)
    opt = NaturalGradient(gamma=0.5, compile=False)
    assert opt.get_config() == {"name": "NaturalGradient", "gamma": 0.5}
    with pytest.raises(ValueError, match="full-covariance"):
        opt.minimize(lambda: pm.training_loss((_t(X), _t(Y))), [(pm.q_mu, pm.q_sqrt)])
    with pytest.raises(ValueError, match="full-covariance"):
        opt._natgrad_apply_gradients(torch.zeros(M, 1), torch.zeros(M, 1), pm.q_mu, pm.q_sqrt)
    with pytest.raises(ValueError, match="full-covariance"):
        DataParallelTrainer(pm, natgrad_gamma=0.1)


def test_compile_flag_changes_nothing():
    values = []
    for compile_ in (True, False):
        _, pm = _models("Bernoulli", True, _q_values(2))
        NaturalGradient(0.4, compile=compile_).minimize(
            lambda: pm.training_loss((_t(X), _t(Yb))), [(pm.q_mu, pm.q_sqrt)])
        values.append(port_read_values(pm))
    for k in values[0]:
        np.testing.assert_array_equal(values[0][k], values[1][k])


# --- the Bernoulli SVGP ELBO ----------------------------------------------------


def _jax_elbo_and_grads(jm, data):
    params = jax_parameter_dict(jm)
    paths = [k for k, p in params.items() if p.trainable]
    fn = functionalize(lambda: jm.elbo(data), [params[k] for k in paths])
    value, grads = reference_jit(jax.value_and_grad(fn))([params[k].unconstrained_variable for k in paths])
    return value, dict(zip(paths, grads))


@pytest.mark.parametrize("whiten", [True, False])
def test_bernoulli_elbo_and_gradient_match_jax_f64(whiten):
    # the same float64 arithmetic by XLA autodiff and by torch's: 1e-8
    jm, pm = _models("Bernoulli", whiten, _q_values(3), num_data=1000)
    want, want_grads = _jax_elbo_and_grads(jm, (X, Yb))
    got = pm.elbo((_t(X), _t(Yb)))
    got.backward()
    _close(got, want, rtol=1e-8)
    params = parameter_dict(pm)
    assert sorted(want_grads) == sorted(params)
    for path, w in want_grads.items():
        _close(params[path].unconstrained.grad, w, rtol=1e-8)


def test_bernoulli_predictions_match_jax_f64():
    jm, pm = _models("Bernoulli", True, _q_values(4))
    Xnew = np.random.RandomState(6).randn(15, D)
    with torch.no_grad():
        for got, want in zip(pm.predict_y(_t(Xnew)), jm.predict_y(Xnew)):
            _close(got, want, rtol=1e-10)
        for got, want in zip(pm.posterior().predict_f(_t(Xnew)), jm.posterior().predict_f(Xnew)):
            _close(got, want, rtol=1e-10)
        _close(pm.predict_log_density((_t(X), _t(Yb))), jm.predict_log_density((X, Yb)), rtol=1e-10)


# --- the trainer ------------------------------------------------------------------


def _batches(K=5, B=12):
    rng = np.random.RandomState(7)
    idx = rng.randint(0, N, (K, B))
    return X[idx], Yb[idx]


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("fused", [True, False])
def test_trainer_natgrad_matches_jax_trainer_f64(fused, whiten):
    # five steps of natural gradients on (q_mu, q_sqrt) and Adam on the
    # hyperparameters and Z: ulp-level differences of Adam's operation order
    # and of the conversions carried over five steps, 1e-7
    jm, pm = _models("Bernoulli", whiten, _q_values(8), num_data=1000)
    batches = _batches()
    jt = JaxTrainer(jm, optimizer=optax.adam(1e-2), mesh=make_mesh(num_devices=1), natgrad_gamma=0.1,
                    natgrad_fused=fused)
    want_losses = np.asarray(jt.run_steps(batches))
    jt.finalize()
    pt = DataParallelTrainer(pm, natgrad_gamma=0.1, natgrad_fused=fused)
    got_losses = pt.run_steps(tuple(map(torch.from_numpy, batches)))
    _close(got_losses, want_losses, rtol=1e-7)
    want, got = read_values(jm), port_read_values(pm)
    assert sorted(want) == sorted(got)
    for k in want:
        _close(got[k], want[k], rtol=1e-7)
    assert pt.natgrad_rejections == jt.natgrad_rejections == 0
    # Adam holds only the hyperparameters and Z
    held = {id(p) for group in pt.optimizer.param_groups for p in group["params"]}
    assert held == {id(p.unconstrained) for p in pm.trainable_parameters} - {
        id(pm.q_mu.unconstrained), id(pm.q_sqrt.unconstrained)}
    assert pm.q_mu.unconstrained.grad is None and pm.q_sqrt.unconstrained.grad is None


@pytest.mark.parametrize("fused", [True, False])
def test_trainer_step_loss_and_sampled_steps(fused):
    _, pm = _models("Bernoulli", True, _q_values(9))
    pt = DataParallelTrainer(pm, natgrad_gamma=0.2, natgrad_fused=fused)
    before = pt.loss((X, Yb))
    _close(before, pm.training_loss((_t(X), _t(Yb))), rtol=1e-14)
    loss = pt.step((X, Yb))
    if fused:  # the loss before the step
        _close(loss, before, rtol=1e-14)
    assert pt.loss((X, Yb)) < before
    pt.stage_data((X, Yb))
    out = pt.run_steps_sampled(4, 16, generator=torch.Generator().manual_seed(3))
    assert out.shape == (4,) and torch.isfinite(out).all()


def test_natgrad_rejections_count_as_the_jax_trainer():
    # gamma = 3 drives nat2 out of the negative-definite cone in four of the
    # five steps in both packages
    jm, pm = _models("Bernoulli", True, num_data=1000)
    rng = np.random.RandomState(0)
    Xr = rng.rand(80, D) * 4
    Yr = (np.sin(Xr @ np.array([1.0, -0.5])) > 0).astype(float)[:, None]
    batches = (Xr.reshape(5, 16, D), Yr.reshape(5, 16, 1))
    jt = JaxTrainer(jm, optimizer=optax.adam(1e-2), mesh=make_mesh(num_devices=1), natgrad_gamma=3.0,
                    natgrad_fused=True)
    jt.run_steps(batches)
    pt = DataParallelTrainer(pm, natgrad_gamma=3.0, natgrad_fused=True)
    losses = pt.run_steps(tuple(map(torch.from_numpy, batches)))
    assert pt._rejections.device == pm.q_mu.device and pt._rejections.dtype == torch.int64
    assert pt.natgrad_rejections == jt.natgrad_rejections > 0
    assert torch.isfinite(losses).all()
    assert all(np.isfinite(v).all() for v in port_read_values(pm).values())


def test_trainer_natgrad_only_variational_parameters_trainable():
    # a model whose only trainable parameters are q_mu and q_sqrt has nothing
    # for Adam, which natgrad accepts (gpflow_tpu/parallel/trainer.py:123-124)
    _, pm = _models("Bernoulli", True)
    set_trainable(pm.kernel, False)
    set_trainable(pm.inducing_variable, False)
    frozen = {k: v for k, v in port_read_values(pm).items() if not k.startswith(".q_")}
    for fused in (True, False):
        pt = DataParallelTrainer(pm, natgrad_gamma=0.5, natgrad_fused=fused)
        assert pt.optimizer is None
        start = _elbo(pm, Yb)
        pt.run_steps((X[None], Yb[None]))
        assert _elbo(pm, Yb) > start
    for k, v in frozen.items():
        np.testing.assert_array_equal(port_read_values(pm)[k], v)
    set_trainable(pm.q_mu, False)
    with pytest.raises(ValueError, match="trainable"):
        DataParallelTrainer(pm, natgrad_gamma=0.5)


def test_trainer_natgrad_value_errors():
    _, pm = _models("Bernoulli", True)
    with pytest.raises(ValueError, match="requires natgrad_gamma"):
        DataParallelTrainer(pm, natgrad_fused=True)
    kernel_only = kernels.SquaredExponential()
    kernel_only.q_mu = None
    with pytest.raises(ValueError, match="q_mu and a full-covariance q_sqrt"):
        DataParallelTrainer(kernel_only, natgrad_gamma=0.1)
