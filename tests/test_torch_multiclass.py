"""The multiclass slice of gpflow_tpu_torch against gpflow_tpu on the CPU:
``RobustMax``, ``MultiClass`` and ``Softmax`` on the same numpy inputs, and an
SVGP with C = 3 latent GPs sharing one kernel (M = 16, B = 32, D = 4) with
either likelihood, its values carried over from the JAX model by
``load_jax_values``: the ELBO and its gradient in every trainable parameter,
cached and fused requests, one fused natural-gradient step, and a run with
the shape contracts on. Both sides evaluate the same float64 formulas:
1e-10 relative (with 1e-10 of the largest entry as an absolute floor) for
values, 1e-8 for gradients, which autodiff sums in another order. Softmax's
Monte-Carlo draws are the same ``epsilon`` on both sides."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.base import functionalize
from gpflow_tpu.models import SVGP as JaxSVGP
from gpflow_tpu.parallel import DataParallelTrainer as JaxTrainer
from gpflow_tpu.parallel import make_mesh
from gpflow_tpu.quadrature import deprecated as jax_deprecated
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu.utilities import read_values
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.parallel import DataParallelTrainer
from gpflow_tpu_torch.utilities import load_jax_values, parameter_dict, set_enable_check_shapes
from gpflow_tpu_torch.utilities import read_values as port_read_values
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

REPO = Path(__file__).resolve().parents[1]
RTOL, GRAD_RTOL = 1e-10, 1e-8
M, B, D, C = 16, 32, 4, 3
S = 100  # MonteCarloLikelihood.num_monte_carlo_points

_rng = np.random.RandomState(0)
X = _rng.randn(B, D)
Y = _rng.randint(0, C, (B, 1)).astype(float)
Z = _rng.randn(M, D)
Xnew = _rng.randn(B, D)
EPS = _rng.randn(S, B, C)  # Softmax's draws, shared by both packages


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _t(a):
    return torch.from_numpy(np.array(a))


def _moments(seed, n=B):
    rng = np.random.RandomState(seed)
    return rng.randn(n, C), 0.05 + rng.rand(n, C)


# --- RobustMax and MultiClass ---------------------------------------------------


def test_robustmax_forward_matches_jax():
    jr, pr = gpflow_tpu.likelihoods.RobustMax(C, epsilon=0.02), likelihoods.RobustMax(C, epsilon=0.02)
    F = np.random.RandomState(1).randn(2, 5, C)  # leading batch dims: argmax over the last axis
    _close(pr(_t(F)), jr(F))
    _close(pr.eps_k1, jr.eps_k1)
    _close(pr.safe_sqrt(_t(np.array([-1.0, 0.0, 4.0]))), jr.safe_sqrt(jnp.array([-1.0, 0.0, 4.0])))
    assert not pr.epsilon.trainable and pr.epsilon.transform == likelihoods.multiclass.Sigmoid()


def test_prob_is_largest_matches_jax():
    jr, pr = gpflow_tpu.likelihoods.RobustMax(C), likelihoods.RobustMax(C)
    mu, var = _moments(2)
    gh_x, gh_w = np.polynomial.hermite.hermgauss(20)
    _close(pr.prob_is_largest(_t(Y), _t(mu), _t(var), gh_x, gh_w), jr.prob_is_largest(Y, mu, var, gh_x, gh_w))


MULTICLASS_METHODS = ["log_prob", "variational_expectations", "predict_mean_and_var", "predict_log_density",
                      "conditional_mean", "conditional_variance"]


def _call(lik, method, Xv, F, Fvar, Yv):
    if method == "log_prob":
        return lik.log_prob(Xv, F, Yv)
    if method in ("conditional_mean", "conditional_variance"):
        return getattr(lik, method)(Xv, F)
    if method == "predict_mean_and_var":
        return lik.predict_mean_and_var(Xv, F, Fvar)
    return getattr(lik, method)(Xv, F, Fvar, Yv)


@pytest.mark.parametrize("method", MULTICLASS_METHODS)
def test_multiclass_matches_jax(method):
    jl, pl = gpflow_tpu.likelihoods.MultiClass(C), likelihoods.MultiClass(C)
    jl.invlink.epsilon.assign(0.05)
    pl.invlink.epsilon.assign(0.05)
    mu, var = _moments(3)
    got = _call(pl, method, _t(X), _t(mu), _t(var), _t(Y))
    want = _call(jl, method, X, mu, var, Y)
    for g, w in zip(got, want) if isinstance(want, tuple) else [(got, want)]:
        _close(g, w)


def test_multiclass_variational_expectations_gradient_matches_jax():
    jl, pl = gpflow_tpu.likelihoods.MultiClass(C), likelihoods.MultiClass(C)
    mu, var = _moments(4)
    want = reference_jit(jax.grad(lambda m, v: jnp.sum(jl.variational_expectations(X, m, v, Y)),
                                  argnums=(0, 1)))(mu, var)
    m, v = _t(mu).requires_grad_(), _t(var).requires_grad_()
    pl.variational_expectations(_t(X), m, v, _t(Y)).sum().backward()
    _close(m.grad, want[0], GRAD_RTOL)
    _close(v.grad, want[1], GRAD_RTOL)


def test_multiclass_grid_is_on_the_device_per_dtype():
    pl = likelihoods.MultiClass(C)
    mu, var = _moments(5)
    pl.variational_expectations(_t(X).float(), _t(mu).float(), _t(var).float(), _t(Y))
    assert set(pl._gh._grids) == {(torch.device("cpu"), torch.float64), (torch.device("cpu"), torch.float32)}
    with pytest.raises(NotImplementedError):
        likelihoods.MultiClass(C, invlink=likelihoods.Softmax(C))


# --- Softmax ----------------------------------------------------------------------

SOFTMAX_METHODS = ["_variational_expectations", "_predict_mean_and_var", "_predict_log_density", "log_prob",
                   "conditional_mean", "conditional_variance"]


@pytest.mark.parametrize("method", SOFTMAX_METHODS)
def test_softmax_matches_jax_with_shared_epsilon(method):
    jl, pl = gpflow_tpu.likelihoods.Softmax(C), likelihoods.Softmax(C)
    mu, var = _moments(6)
    if method.startswith("_"):
        args = (X, mu, var) if method == "_predict_mean_and_var" else (X, mu, var, Y)
        got = getattr(pl, method)(*map(_t, args), epsilon=_t(EPS))
        want = getattr(jl, method)(*args, epsilon=EPS)
    else:
        got, want = _call(pl, method, _t(X), _t(mu), _t(var), _t(Y)), _call(jl, method, X, mu, var, Y)
    for g, w in zip(got, want) if isinstance(want, tuple) else [(got, want)]:
        _close(g, w)


def test_softmax_out_of_range_label_is_nan():
    pl = likelihoods.Softmax(C)
    Ybad = Y.copy()
    Ybad[0, 0], Ybad[1, 0] = -1.0, float(C)
    F = np.random.RandomState(7).randn(B, C)
    got = _np(pl.log_prob(_t(X), _t(F), _t(Ybad)))
    want = np.asarray(gpflow_tpu.likelihoods.Softmax(C).log_prob(X, F, Ybad))
    assert np.isnan(got[:2]).all() and np.isfinite(got[2:]).all()
    _close(got[2:], want[2:])
    assert np.isnan(want[:2]).all()


def test_softmax_draws_come_from_its_own_seeded_generator():
    mu, var = _moments(8)
    a = likelihoods.Softmax(C, seed=5).variational_expectations(_t(X), _t(mu), _t(var), _t(Y))
    b = likelihoods.Softmax(C, seed=5).variational_expectations(_t(X), _t(mu), _t(var), _t(Y))
    _close(a, b, 0.0)  # the same seed, the same draws
    lik = likelihoods.Softmax(C, generator=torch.Generator().manual_seed(5))
    c = lik.variational_expectations(_t(X), _t(mu), _t(var), _t(Y))
    _close(c, a, 0.0)  # the caller's generator
    d = lik.variational_expectations(_t(X), _t(mu), _t(var), _t(Y))
    assert not np.allclose(_np(c), _np(d))  # a second call draws anew


# --- the SVGP with C latent GPs -----------------------------------------------------


def _lower(rng, *shape):
    L = np.tril(0.05 * rng.randn(*shape))
    idx = np.arange(shape[-1])
    L[..., idx, idx] = 0.5 + rng.rand(*shape[:-1])
    return L


def _jax_likelihood(name):
    return gpflow_tpu.likelihoods.MultiClass(C) if name == "MultiClass" else gpflow_tpu.likelihoods.Softmax(C)


def _port_likelihood(name):
    return likelihoods.MultiClass(C) if name == "MultiClass" else likelihoods.Softmax(C)


def _models(name, whiten, seed=10, num_data=200):
    """A JAX SVGP with ``name`` over C latent GPs, its variational values
    moved off their start, and its port with the same values."""
    rng = np.random.RandomState(seed)
    jm = JaxSVGP(kernel=gpflow_tpu.kernels.SquaredExponential(lengthscales=np.full(D, 1.5)),
                 likelihood=_jax_likelihood(name), inducing_variable=Z.copy(), num_latent_gps=C, whiten=whiten,
                 num_data=num_data)
    values = read_values(jm)
    values.update({".q_mu": rng.randn(M, C), ".q_sqrt": _lower(rng, C, M, M), ".kernel.variance": np.array(1.3)})
    gpflow_tpu.utilities.multiple_assign(jm, values)
    pm = SVGP(kernel=kernels.SquaredExponential(lengthscales=np.full(D, 1.5)), likelihood=_port_likelihood(name),
              inducing_variable=Z.copy(), num_latent_gps=C, whiten=whiten, num_data=num_data)
    load_jax_values(pm, read_values(jm))
    return jm, pm


@pytest.fixture
def shared_epsilon(monkeypatch):
    """Softmax's draws set to EPS in both packages: the JAX package's
    default draw and the port likelihood's ``_mc_quadrature``."""
    monkeypatch.setattr(jax_deprecated, "_default_mc_epsilon", lambda Fmu, shape: jnp.asarray(EPS, Fmu.dtype))

    def pin(pm):
        inner = pm.likelihood._mc_quadrature

        def fixed(funcs, Fmu, Fvar, logspace=False, epsilon=None, **Ys):
            return inner(funcs, Fmu, Fvar, logspace, _t(EPS).to(Fmu.dtype), **Ys)

        monkeypatch.setattr(pm.likelihood, "_mc_quadrature", fixed)
        return pm

    return pin


def _jax_elbo_and_grads(jm, data):
    params = jax_parameter_dict(jm)
    paths = [k for k, p in params.items() if p.trainable]
    fn = functionalize(lambda: jm.elbo(data), [params[k] for k in paths])
    value, grads = reference_jit(jax.value_and_grad(fn))([params[k].unconstrained_variable for k in paths])
    return value, dict(zip(paths, grads))


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("name", ["MultiClass", "Softmax"])
def test_svgp_elbo_and_gradient_match_jax(name, whiten, shared_epsilon):
    jm, pm = _models(name, whiten)
    if name == "Softmax":
        shared_epsilon(pm)
    want, want_grads = _jax_elbo_and_grads(jm, (X, Y))
    got = pm.elbo((_t(X), _t(Y)))
    got.backward()
    _close(got, want, GRAD_RTOL)
    params = {k: p for k, p in parameter_dict(pm).items() if p.trainable}
    assert sorted(want_grads) == sorted(params)  # epsilon is not trainable in either
    # each gradient within GRAD_RTOL of the largest gradient entry: the
    # kernel variance's is a cancellation, orders below the others
    scale = max(float(np.max(np.abs(w))) for w in want_grads.values())
    for path, w in want_grads.items():
        np.testing.assert_allclose(_np(params[path].unconstrained.grad), np.asarray(w), rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * scale)
    _close(pm.prior_kl(), jm.prior_kl())


@pytest.mark.parametrize("name", ["MultiClass", "Softmax"])
def test_svgp_requests_match_jax(name, shared_epsilon):
    jm, pm = _models(name, True, seed=11)
    if name == "Softmax":
        shared_epsilon(pm)
    Xt = _t(Xnew)
    with torch.no_grad():
        for got, want in zip(pm.posterior().predict_f(Xt), jm.posterior().predict_f(Xnew)):
            _close(got, want)
        for got, want in zip(pm.predict_f(Xt), jm.predict_f(Xnew)):
            _close(got, want)
        for got, want in zip(pm.predict_y(Xt), jm.predict_y(Xnew)):
            _close(got, want)
        _close(pm.predict_log_density((Xt, _t(Y))), jm.predict_log_density((Xnew, Y)))
        p = pm.predict_y(Xt)[0]
    assert p.shape == (B, C) and bool(((p >= 0) & (p <= 1)).all())
    if name == "Softmax":
        _close(p.sum(-1), np.ones(B))  # RobustMax's class probabilities need not sum to 1


def test_svgp_multiclass_full_covariance_request_matches_jax():
    jm, pm = _models("MultiClass", False, seed=12)
    with torch.no_grad():
        mean, cov = pm.predict_f(_t(Xnew[:7]), full_cov=True)
    want_mean, want_cov = jm.predict_f(Xnew[:7], full_cov=True)
    assert cov.shape == (C, 7, 7)
    _close(mean, want_mean)
    _close(cov, want_cov)


@pytest.mark.parametrize("whiten", [True, False])
def test_fused_natural_gradient_step_matches_jax_trainer(whiten):
    # one step: natural gradients (gamma 0.1) on q_mu [M, C] and q_sqrt
    # [C, M, M], Adam on the kernel and Z, from one forward and backward pass
    # (num_data = B: at 200 the step leaves the cone in both packages)
    jm, pm = _models("MultiClass", whiten, seed=13, num_data=B)
    batches = (X[None], Y[None])
    jt = JaxTrainer(jm, optimizer=optax.adam(1e-2), mesh=make_mesh(num_devices=1), natgrad_gamma=0.1,
                    natgrad_fused=True)
    want_losses = np.asarray(jt.run_steps(batches))
    jt.finalize()
    pt = DataParallelTrainer(pm, natgrad_gamma=0.1, natgrad_fused=True)
    got_losses = pt.run_steps(tuple(map(_t, batches)))
    _close(got_losses, want_losses, GRAD_RTOL)
    want, got = read_values(jm), port_read_values(pm)
    assert sorted(want) == sorted(got)
    for k in want:
        _close(got[k], want[k], 1e-7)
    assert pt.natgrad_rejections == jt.natgrad_rejections == 0
    assert not np.allclose(got[".q_sqrt"], _models("MultiClass", whiten, seed=13, num_data=B)[1].q_sqrt.numpy())


@pytest.mark.parametrize("name", ["MultiClass", "Softmax"])
def test_slice_with_shape_checks_on(name, shared_epsilon):
    # every new module carries the JAX package's contracts: the same
    # numbers with the checks on as off
    outputs = {}
    for enabled in (False, True):
        _, pm = _models(name, True, seed=14)
        if name == "Softmax":
            shared_epsilon(pm)
        set_enable_check_shapes(enabled)
        try:
            elbo = pm.elbo((_t(X), _t(Y)))
            grads = torch.autograd.grad(elbo, [p.unconstrained for p in pm.trainable_parameters])
            with torch.no_grad():
                outputs[enabled] = [elbo.detach(), *grads, *pm.predict_y(_t(Xnew)),
                                    *pm.posterior().predict_f(_t(Xnew)),
                                    pm.predict_log_density((_t(Xnew), _t(Y)))]
        finally:
            set_enable_check_shapes(False)
    for a, b in zip(outputs[False], outputs[True]):
        _close(b, a, 0.0)


def test_shape_check_rejects_a_wrong_latent_count():
    from gpflow_tpu_torch.utilities import ShapeError

    pl = likelihoods.MultiClass(C)
    mu, var = _moments(15)
    set_enable_check_shapes(True)
    try:
        with pytest.raises(ShapeError):
            pl.invlink.prob_is_largest(_t(Y), _t(mu), _t(var[:, :2]), *np.polynomial.hermite.hermgauss(20))
        with pytest.raises(ShapeError):
            pl.predict_mean_and_var(_t(X), _t(mu), _t(var[:-1]))
    finally:
        set_enable_check_shapes(False)


# --- the package boundary --------------------------------------------------------------


def test_new_modules_leave_jax_out():
    code = (
        "import sys\n"
        "import gpflow_tpu_torch.likelihoods.multiclass, gpflow_tpu_torch.likelihoods.multilatent\n"
        "import gpflow_tpu_torch.likelihoods.misc, gpflow_tpu_torch.likelihoods.base\n"
        "import gpflow_tpu_torch.likelihoods.scalar_continuous, gpflow_tpu_torch.quadrature.deprecated\n"
        "import gpflow_tpu_torch.logdensities, gpflow_tpu_torch.bijectors, gpflow_tpu_torch.config\n"
        "from gpflow_tpu_torch.likelihoods import MultiClass, Softmax, SwitchedLikelihood, GaussianMC\n"
        "from gpflow_tpu_torch.quadrature import ndiag_mc, ndiagquad, mvnquad, hermgauss, mvhermgauss\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gpflow_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    # the imports took 5 s in the tier-1 run: a hang fails this case in about 6x that
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ), capture_output=True,
                          text=True, timeout=30)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_new_modules_build_on_the_default_device():
    assert config.default_device() == torch.device("cpu")
    assert config.default_int() == torch.int64 and config.Config().int == torch.int64
    mc, sm = likelihoods.MultiClass(C), likelihoods.Softmax(C)
    assert mc.invlink.epsilon.device == torch.device("cpu")
    assert {k[0] for k in mc._gh._grids} == {torch.device("cpu")}
    assert sm.generator("cpu").device == torch.device("cpu") and set(sm._generators) == {torch.device("cpu")}


def test_new_modules_on_the_card_need_one():
    # the card is the default: without one, building raises torch's own
    # error; nothing falls back to the CPU
    import dataclasses

    with config.as_context(dataclasses.replace(config.config(), device="cuda")):
        if torch.cuda.is_available():
            lik = likelihoods.MultiClass(C)
            assert lik.invlink.epsilon.device.type == "cuda"
            assert likelihoods.Softmax(C).generator("cuda").device.type == "cuda"
        else:
            for build in (lambda: likelihoods.MultiClass(C), lambda: likelihoods.Softmax(C),
                          lambda: likelihoods.StudentT()):
                with pytest.raises((RuntimeError, AssertionError)):
                    build()
