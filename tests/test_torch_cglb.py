"""CGLB of gpflow_tpu_torch against gpflow_tpu on the CPU, in float64:
``logdet_term``, ``quad_term`` at a fixed v with its gradient, the
conjugate gradient's v from the same start (one and two right-hand sides,
a restart inside the run), the ELBO with the CG and its warm start of v,
the dense mode against the matrix-free one (a chunk that does not divide
N), the one-sided clamps under an adversarial v, and the predictions.
Unless a test states otherwise, the port agrees to 1e-10 relative to the
largest entry."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.base import functionalize
from gpflow_tpu.models.cglb import NystromPreconditioner as JaxNystromPreconditioner
from gpflow_tpu.models.cglb import cglb_conjugate_gradient as jax_cglb_conjugate_gradient
from gpflow_tpu.utilities import parameter_dict as jax_parameter_dict
from gpflow_tpu_torch import config, kernels
from gpflow_tpu_torch.models import CGLB, NystromPreconditioner, cglb_conjugate_gradient
from gpflow_tpu_torch.models import cglb as cglb_module
from gpflow_tpu_torch.optimizers import Scipy
from gpflow_tpu_torch.utilities import parameter_dict
from .test_torch_environment import one_thread, reference_jit  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

N, M, D, NEW, CHUNK = 200, 20, 2, 30, 64  # 64 does not divide 200
MODES = {"dense": {}, "matrix-free": {"matrix_free_chunk": CHUNK}}
RTOL = 1e-10


def _data(seed=0, P=1):
    rng = np.random.RandomState(seed)
    X = rng.rand(N, D) * 3.0
    Y = np.sin(3.0 * X[:, :1]) + 0.1 * rng.randn(N, P)
    Z = X[rng.permutation(N)[:M]].copy()
    Xnew = rng.rand(NEW, D) * 3.0
    return X, Y, Z, Xnew


def _models(seed=0, P=1, noise=0.1, **kwargs):
    X, Y, Z, Xnew = _data(seed, P)
    args = dict(inducing_variable=Z, noise_variance=noise, **kwargs)
    jm = gpflow_tpu.models.CGLB(
        (X, Y), kernel=gpflow_tpu.kernels.SquaredExponential(variance=1.3, lengthscales=[0.7, 1.2]), **args
    )
    pm = CGLB((X, Y), kernel=kernels.SquaredExponential(variance=1.3, lengthscales=[0.7, 1.2]), **args)
    return jm, pm, Xnew


def _set_v(jm, pm, v):
    jm.aux_vec.assign(v)
    pm.aux_vec.assign(v)


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=rtol * max(np.max(np.abs(want)), 1e-300))


def _port_value_and_grads(pm):
    params = {path: p for path, p in parameter_dict(pm).items() if p.trainable}
    value = pm.training_loss()
    grads = torch.autograd.grad(value, [p.unconstrained for p in params.values()])
    return value.detach(), dict(zip(params, grads))


def test_logdet_term_matches_jax_f64():
    jm, pm, _ = _models()
    with torch.no_grad():
        got = pm.logdet_term(pm._common_calculation())
    _close(got, jm.logdet_term(jm._common_calculation()))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_quad_term_and_gradient_at_a_fixed_v_match_jax_f64(mode):
    jm, pm, _ = _models(seed=1, v_grad_optimization=True, **MODES[mode])
    _set_v(jm, pm, np.random.RandomState(1).randn(1, N))
    with torch.no_grad():
        _close(pm.quad_term(pm._common_calculation()), jm.quad_term(jm._common_calculation()))
    paths = sorted(p for p, v in jax_parameter_dict(jm).items() if v.trainable)
    params = [jax_parameter_dict(jm)[p] for p in paths]
    want_value, want = reference_jit(jax.value_and_grad(functionalize(jm.training_loss, params)))(
        tuple(p.unconstrained_variable for p in params)
    )
    got_value, got = _port_value_and_grads(pm)
    assert sorted(got) == paths and "._v" in got
    _close(got_value, want_value)
    for path, g in zip(paths, want):
        _close(got[path], g)


@pytest.mark.parametrize("R", [1, 2])
def test_conjugate_gradient_matches_jax_f64(R):
    # 7 iterations with a restart every 3 (after iterations 3 and 6), from a
    # nonzero start, on R right-hand sides with a step size each
    jm, pm, _ = _models(seed=2, P=R)
    X, Y, _, _ = _data(2, R)
    initial = 0.1 * np.random.RandomState(2).randn(R, N)
    jc = jm._common_calculation()
    want = jax_cglb_conjugate_gradient(
        jm._kmat_operator(), np.asarray(Y).T, initial, JaxNystromPreconditioner(jc.A, jc.LB, 0.1), 1e-12, 7, 3
    )
    with torch.no_grad():
        pc = pm._common_calculation()
        precond = NystromPreconditioner(pc.A, pc.LB, pm.likelihood.variance.value)
        K = pm._kmat_operator()
        got = cglb_conjugate_gradient(K, torch.from_numpy(Y.T), torch.from_numpy(initial), precond, 1e-12, 7, 3)
        calls = []

        def mv(v):
            calls.append(1)
            return v @ K

        v, iters = cglb_module._cglb_conjugate_gradient(mv, torch.from_numpy(Y.T), torch.from_numpy(initial),
                                                        precond, 1e-12, 7, 3)
    assert not got.requires_grad and got.shape == (R, N)
    _close(got, want)
    _close(v, want)
    assert iters == 7 and len(calls) == 1 + 7 + 2  # the initial residual, one a step, one a restart


def test_conjugate_gradient_stops_at_the_tolerance_and_builds_no_graph():
    _, pm, _ = _models(seed=3, P=2)
    X, Y, _, _ = _data(3, 2)
    pc = pm._common_calculation()  # with autograd: the CG must not extend the graph
    precond = NystromPreconditioner(pc.A, pc.LB, pm.likelihood.variance.value)
    b = torch.from_numpy(Y.T)
    v, iters = cglb_module._cglb_conjugate_gradient(pm._kmat_operator(), b, torch.zeros_like(b), precond,
                                                    1e-6, 100, 40)
    assert not v.requires_grad and v.grad_fn is None
    with torch.no_grad():
        r = b - v @ pm._kmat_operator()
        _, rz = precond(r)
    assert 0 < iters < 100 and float(0.5 * rz.max()) <= 1e-6


@pytest.mark.parametrize("mode,P", [("dense", 1), ("matrix-free", 2)])
def test_elbo_with_the_cg_and_its_warm_start_match_jax_f64(mode, P):
    # the JAX package writes v back when it runs eagerly, as the port always does
    jm, pm, _ = _models(seed=4, P=P, **MODES[mode])
    for _ in range(2):  # from v = 0, then warm-started from the v written back
        with torch.no_grad():
            got = pm.elbo()
        _close(got, jm.elbo())
        _close(pm.aux_vec.value, jm.aux_vec.value)
    assert pm.cg_iterations is not None and not pm.aux_vec.trainable


def test_dense_and_matrix_free_agree_f64():
    models = {}
    for mode, kwargs in MODES.items():
        _, models[mode], _ = _models(seed=5, v_grad_optimization=True, **kwargs)
        models[mode].aux_vec.assign(np.random.RandomState(5).randn(1, N))
    (vd, gd), (vm, gm) = (_port_value_and_grads(models[mode]) for mode in ("dense", "matrix-free"))
    _close(vm, vd)
    for path in gd:
        _close(gm[path], gd[path])
    # with the CG: the same v and bound
    for mode, kwargs in MODES.items():
        _, models[mode], _ = _models(seed=5, cg_tolerance=1e-8, **kwargs)
        with torch.no_grad():
            models[mode].training_loss()
    _close(models["matrix-free"].aux_vec.value, models["dense"].aux_vec.value, rtol=1e-8)


def test_matrix_free_builds_chunks_and_rebuilds_them_in_the_backward(monkeypatch):
    _, pm, _ = _models(seed=6, v_grad_optimization=True, matrix_free_chunk=CHUNK)
    shapes = []
    original = type(pm.kernel).K

    def recording_K(self, X, X2=None):
        out = original(self, X, X2)
        shapes.append(tuple(out.shape))
        return out

    monkeypatch.setattr(type(pm.kernel), "K", recording_K)
    loss = pm.training_loss()
    forward = list(shapes)
    loss.backward()
    blocks = [(N, CHUNK), (N, CHUNK), (N, CHUNK), (N, N % CHUNK)]
    assert [s for s in forward if s[0] == N] == blocks  # never [N, N]
    assert sorted(shapes[len(forward):]) == sorted(blocks)  # each block again, for its gradient


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_bound_stays_valid_under_adversarial_aux_vector(mode, dtype):
    # tests/gpflow_tpu/models/test_cglb.py:95-126 on the port, also in
    # float32: v = s * 1 gives a finite bound below the float64 Titsias upper
    # bound, which dominates the evidence, and a huge v a very loose one
    rng = np.random.RandomState(4)
    n = 256
    X = rng.randn(n, 2)
    Y = np.sin(X[:, :1]) + 0.1 * rng.randn(n, 1)
    upper = None
    for dt in (torch.float64, dtype):
        with config.as_context(dataclasses.replace(config.config(), float=dt)):
            model = CGLB((X, Y), kernel=kernels.SquaredExponential(), inducing_variable=X[:12].copy(),
                         noise_variance=1e-4, v_grad_optimization=True, **MODES[mode]).to(dt)
        with torch.no_grad():
            if upper is None:
                upper = float(model.upper_bound())
                continue
            bounds = []
            for scale in (0.0, 1.0, 1e4, -1e4):
                model.aux_vec.assign(np.full((1, n), scale))
                bounds.append(float(model.elbo()))
    assert all(np.isfinite(b) and b <= upper + 1e-6 * abs(upper) for b in bounds), (bounds, upper)
    assert bounds[2] < -1e3 and bounds[3] < -1e3


def test_v_is_written_back_and_kept_where_the_new_one_is_not_finite(monkeypatch):
    _, pm, _ = _models(seed=7, matrix_free_chunk=CHUNK)
    with torch.no_grad():
        pm.training_loss()
    v = pm.aux_vec.numpy()
    assert np.abs(v).max() > 0 and pm.cg_iterations > 0
    monkeypatch.setattr(cglb_module, "_cglb_conjugate_gradient",
                        lambda K, b, initial, *args: (torch.full_like(initial, float("nan")), 3))
    loss = pm.training_loss()  # a non-finite v neither raises nor reaches aux_vec
    assert not bool(torch.isfinite(loss)) and pm.cg_iterations == 3
    np.testing.assert_array_equal(pm.aux_vec.numpy(), v)


@pytest.mark.parametrize("mode,cg_tolerance", [("dense", None), ("matrix-free", 1e-3)])
def test_predictions_match_jax_f64(mode, cg_tolerance):
    jm, pm, Xnew = _models(seed=8, **MODES[mode])
    _set_v(jm, pm, 0.5 * np.random.RandomState(8).randn(1, N))
    Ynew = np.sin(3.0 * Xnew[:, :1])
    x, y = torch.from_numpy(Xnew), torch.from_numpy(Ynew)
    with torch.no_grad():
        got = [pm.predict_f(x, cg_tolerance=cg_tolerance), pm.predict_f(x, full_cov=True, cg_tolerance=cg_tolerance),
               pm.predict_y(x, cg_tolerance=cg_tolerance), (pm.predict_log_density((x, y), cg_tolerance=cg_tolerance),)]
    want = [jm.predict_f(Xnew, cg_tolerance=cg_tolerance), jm.predict_f(Xnew, full_cov=True, cg_tolerance=cg_tolerance),
            jm.predict_y(Xnew, cg_tolerance=cg_tolerance),
            (jm.predict_log_density((Xnew, Ynew), cg_tolerance=cg_tolerance),)]
    for g, w in zip(got, want):
        for gt, wt in zip(g, w):
            _close(gt, wt)
    _close(pm.aux_vec.value, jm.aux_vec.value)  # a prediction does not write v


def test_scipy_trains_a_matrix_free_cglb():
    _, pm, _ = _models(seed=9, matrix_free_chunk=CHUNK)
    with torch.no_grad():
        start = float(pm.training_loss())
    res = Scipy().minimize(pm.training_loss_closure(), pm.trainable_variables, options={"maxiter": 5},
                           nonfinite_penalty=1e15)
    assert np.isfinite(res.fun) and res.fun < start
    assert [p.name for p in pm.trainable_variables] == ["variance", "lengthscales", "variance", "Z"]
