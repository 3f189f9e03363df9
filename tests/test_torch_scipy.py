"""``optimizers.Scipy`` of gpflow_tpu_torch on the CPU: the cases of
``tests/gpflow_tpu/optimizers/test_scipy.py`` that need no ``Monitor``,
L-BFGS on a port GPR against the JAX package's on the same data, the packed
layout of TriangularMask parameters, and the restore of the best finite
point with its gradient."""
import pickle

import numpy as np
import pytest
import torch

import gpflow_tpu
from gpflow_tpu.optimizers import Scipy as JaxScipy
from gpflow_tpu_torch import Parameter, config, kernels, likelihoods
from gpflow_tpu_torch.models import GPR, SVGP
from gpflow_tpu_torch.optimizers import Scipy

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

rng = np.random.RandomState(41)
N = 30
X = rng.rand(N, 1) * 5
Y = np.sin(X) + 0.1 * rng.randn(N, 1)


def _model():
    return GPR((X, Y), kernel=kernels.SquaredExponential(), noise_variance=0.5)


def _loss(m):
    return m.training_loss().item()


def test_minimize_reduces_loss_and_reports_iterations():
    m = _model()
    before = _loss(m)
    res = Scipy().minimize(m.training_loss, m.trainable_variables, options={"maxiter": 50})
    after = _loss(m)
    assert after < before - 1.0
    assert res.nit > 1
    np.testing.assert_allclose(float(res.fun), after, rtol=1e-10)


def test_reaches_the_jax_optimum_f64():
    # the same data, start and L-BFGS-B options in both packages: the
    # converged NLMLs agree within 1e-6 relative
    data_rng = np.random.RandomState(3)
    Xg = data_rng.rand(80, 2)
    Yg = np.sin(3.0 * Xg[:, :1]) + 0.1 * data_rng.randn(80, 1)
    jm = gpflow_tpu.models.GPR((Xg, Yg), gpflow_tpu.kernels.SquaredExponential(lengthscales=np.ones(2)),
                               noise_variance=0.1)
    pm = GPR((Xg, Yg), kernels.SquaredExponential(lengthscales=np.ones(2)), noise_variance=0.1)
    want = JaxScipy().minimize(jm.training_loss, jm.trainable_variables, options={"maxiter": 100})
    got = Scipy().minimize(pm.training_loss, pm.trainable_variables, options={"maxiter": 100})
    assert got.success and want.success
    np.testing.assert_allclose(float(got.fun), float(want.fun), rtol=1e-6)
    np.testing.assert_allclose(_loss(pm), float(jm.training_loss()), rtol=1e-6)


def test_step_callback_sees_every_iteration():
    m = _model()
    steps, values_log = [], []

    def cb(step, variables, values):
        steps.append(step)
        assert len(variables) == len(values) == len(m.trainable_variables)
        values_log.append([np.asarray(v).copy() for v in values])
        # the current iterate is assigned before the callback runs
        for v, val in zip(variables, values):
            np.testing.assert_array_equal(v.unconstrained.detach().numpy(), val)

    res = Scipy().minimize(m.training_loss, m.trainable_variables, step_callback=cb, options={"maxiter": 10})
    assert steps == list(range(len(steps)))
    assert len(steps) == res.nit
    assert not all(np.allclose(a, b) for a, b in zip(values_log[0], values_log[-1]))


def test_track_loss_history():
    m = _model()
    res = Scipy().minimize(m.training_loss, m.trainable_variables, track_loss_history=True,
                           options={"maxiter": 25})
    hist = res["loss_history"]
    assert len(hist) == res.nit
    assert float(hist[-1]) <= float(hist[0])
    np.testing.assert_allclose(float(hist[-1]), float(res.fun), rtol=1e-8)


def test_track_loss_history_chains_with_step_callback():
    m = _model()
    steps = []
    res = Scipy().minimize(m.training_loss, m.trainable_variables, step_callback=lambda s, v, vals: steps.append(s),
                           track_loss_history=True, options={"maxiter": 10})
    assert len(steps) == len(res["loss_history"]) == res.nit


def test_step_callback_and_raw_callback_conflict():
    m = _model()
    with pytest.raises(ValueError, match="Callback passed both"):
        Scipy().minimize(m.training_loss, m.trainable_variables, step_callback=lambda s, v, vals: None,
                         callback=lambda x: None)


@pytest.mark.parametrize("compile_", [True, False])
def test_compile_modes_agree(compile_):
    m = _model()
    Scipy().minimize(m.training_loss, m.trainable_variables, compile=compile_, options={"maxiter": 40})
    assert _loss(m) < -10


def test_optimizes_only_given_subset():
    m = _model()
    ls_before = m.kernel.lengthscales.value.item()
    noise_before = m.likelihood.variance.value.item()
    Scipy().minimize(m.training_loss, (m.kernel.variance,), options={"maxiter": 20})
    assert m.kernel.lengthscales.value.item() == ls_before
    assert m.likelihood.variance.value.item() == noise_before
    assert m.kernel.variance.value.item() != 1.0


def test_optimizes_a_non_trainable_parameter_it_is_given():
    # as in the JAX package, the given variables are optimized whatever their
    # ``trainable`` flag, which is restored afterwards
    m = _model()
    m.kernel.variance.trainable = False
    Scipy().minimize(m.training_loss, (m.kernel.variance,), options={"maxiter": 20})
    assert float(m.kernel.variance.value) != 1.0 and not m.kernel.variance.trainable


def test_unused_variable_raises_unless_allowed():
    m = _model()
    extra = Parameter(1.0, name="unused")
    with pytest.raises(ValueError, match="unused"):
        Scipy().minimize(m.training_loss, tuple(m.trainable_variables) + (extra,), options={"maxiter": 2})
    with pytest.warns(UserWarning, match="unused"):
        res = Scipy().minimize(m.training_loss, tuple(m.trainable_variables) + (extra,),
                               allow_unused_variables=True, options={"maxiter": 5})
    assert np.isfinite(float(res.fun))
    np.testing.assert_allclose(float(extra.value), 1.0, rtol=1e-12)


def test_input_validation():
    m = _model()
    with pytest.raises(TypeError, match="callable"):
        Scipy().minimize(1.0, m.trainable_variables)
    with pytest.raises(TypeError, match="Parameters"):
        Scipy().minimize(m.training_loss, [np.zeros(2)])


def test_detach_only_variable_detected_as_unused():
    # a variable read only through .detach() gets no gradient, as one read
    # through jax.lax.stop_gradient in the JAX package
    m = _model()
    shadow = Parameter(2.0, name="shadow")

    def closure():
        return m.training_loss() + shadow.value.detach() * 0.0

    with pytest.raises(ValueError, match="shadow"):
        Scipy().minimize(closure, tuple(m.trainable_variables) + (shadow,), options={"maxiter": 2})


def test_compile_cache_reuses_the_function():
    m = _model()
    calls = [0]

    def closure():
        calls[0] += 1
        return m.training_loss()

    opt = Scipy()
    opt.minimize(closure, m.trainable_variables, options={"maxiter": 3})
    (fn, _), = opt.compile_cache.values()
    opt.minimize(closure, m.trainable_variables, options={"maxiter": 3})
    assert len(opt.compile_cache) == 1 and next(iter(opt.compile_cache.values()))[0] is fn
    assert calls[0] > 0


def test_compile_cache_bound_method_closures_hit():
    m = _model()
    opt = Scipy()
    opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 3})
    opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 3})
    assert len(opt.compile_cache) == 1


def test_compile_cache_keeps_the_unused_check():
    m = _model()
    extra = Parameter(1.0, name="unused")
    opt = Scipy()
    variables = tuple(m.trainable_variables) + (extra,)
    with pytest.warns(UserWarning):
        opt.minimize(m.training_loss, variables, allow_unused_variables=True, options={"maxiter": 2})
    with pytest.raises(ValueError, match="unused"):
        opt.minimize(m.training_loss, variables, options={"maxiter": 2})


def test_compile_cache_eviction_and_disable():
    m1, m2, m3 = _model(), _model(), _model()
    opt = Scipy(compile_cache_size=2)
    for m in (m1, m2, m3):
        opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 2})
    assert len(opt.compile_cache) == 2

    opt0 = Scipy(compile_cache_size=0)
    opt0.minimize(m1.training_loss, m1.trainable_variables, options={"maxiter": 2})
    assert len(opt0.compile_cache) == 0

    with pytest.raises(ValueError, match="non-negative"):
        Scipy(compile_cache_size=-1)


def test_scipy_picklable_without_cache():
    m = _model()
    opt = Scipy()
    opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 2})
    assert len(opt.compile_cache) == 1
    restored = pickle.loads(pickle.dumps(opt))
    assert len(restored.compile_cache) == 0
    assert restored.compile_cache_size == opt.compile_cache_size


def test_triangular_parameter_is_packed_and_trained_in_float32():
    # an SVGP with a full q_sqrt (TriangularMask): scipy sees only its lower
    # triangle; the model is float32 and the iterate stays float64 on the host
    data_rng = np.random.RandomState(0)
    Xs = data_rng.rand(40, 2) * 3
    Ys = np.sin(Xs[:, :1]) + 0.05 * data_rng.randn(40, 1)
    with config.as_context(config.Config(float=torch.float32, device="cpu")):
        m = SVGP(kernel=kernels.SquaredExponential(), likelihood=likelihoods.Gaussian(),
                 inducing_variable=Xs[:8].astype(np.float32))
    assert m.q_sqrt.shape == (1, 8, 8) and m.q_sqrt.dtype == torch.float32
    data = (torch.from_numpy(Xs).float(), torch.from_numpy(Ys).float())
    opt = Scipy()
    x0 = opt.initial_parameters(m.trainable_variables)
    full = sum(int(np.prod(v.shape)) for v in m.trainable_variables)
    assert x0.dtype == np.float64 and x0.size == full - 8 * 7 // 2
    before = m.training_loss(data).item()
    res = opt.minimize(m.training_loss_closure(data), m.trainable_variables, options={"maxiter": 25})
    after = m.training_loss(data).item()
    assert np.isfinite(after) and after < before - 0.5
    assert np.asarray(res.x).dtype == np.float64 and res.x.size == x0.size
    assert bool((torch.triu(m.q_sqrt.unconstrained, diagonal=1) == 0).all())


def test_pack_and_unpack_tensors_round_trip():
    with config.as_context(config.Config(float=torch.float32, device="cpu")):
        m = SVGP(kernel=kernels.SquaredExponential(), likelihood=likelihoods.Gaussian(),
                 inducing_variable=np.random.RandomState(1).rand(5, 2).astype(np.float32))
    m.q_sqrt.assign(np.tril(np.random.RandomState(2).randn(1, 5, 5)) + 2.0 * np.eye(5))
    variables = m.trainable_variables
    flat = Scipy.pack_tensors(variables)
    assert np.array_equal(flat, Scipy().initial_parameters(variables))
    values = Scipy.unpack_tensors(variables, flat)
    for v, val in zip(variables, values):
        assert val.dtype == np.float32
        np.testing.assert_array_equal(val, v.unconstrained.detach().numpy())
    Scipy.assign_tensors(variables, [2.0 * val for val in values])
    np.testing.assert_allclose(Scipy.pack_tensors(variables), 2.0 * flat, rtol=1e-6)
    with pytest.raises(ValueError, match="same length"):
        Scipy.assign_tensors(variables, values[:1])


def _nan_region_problem(scale=1.0, start=4.0):
    """Loss NaN for theta < 0, with its unconstrained minimum at theta = -3:
    the line search must probe the NaN region on its way to the boundary."""
    theta = Parameter(np.array([start]), name="theta")

    def loss():
        t = theta.value
        clean = scale * torch.sum((t + 3.0) ** 2)
        return torch.where(torch.any(t < 0), torch.tensor(float("nan"), dtype=t.dtype), clean)

    return theta, loss


def test_nonfinite_penalty_recovers_from_nan_region():
    theta, loss = _nan_region_problem()
    res_plain = Scipy().minimize(loss, [theta], options={"maxiter": 50})
    assert not np.isfinite(res_plain.fun)

    theta, loss = _nan_region_problem()
    res = Scipy().minimize(loss, [theta], options={"maxiter": 50}, nonfinite_penalty=1e15)
    assert np.isfinite(res.fun)
    assert res.n_nonfinite_evals > 0
    final = float(theta.value[0])
    assert 0.0 <= final < 0.5, final
    np.testing.assert_allclose(float(res.fun), (final + 3.0) ** 2, rtol=1e-6)


def test_nonfinite_penalty_raises_on_broken_initial_point():
    theta, loss = _nan_region_problem(start=-4.0)
    with pytest.raises(FloatingPointError, match="initial"):
        Scipy().minimize(loss, [theta], options={"maxiter": 10}, nonfinite_penalty=1e15)


def test_nonfinite_penalty_scales_above_large_finite_losses():
    theta, loss = _nan_region_problem(scale=1e16)
    res = Scipy().minimize(loss, [theta], options={"maxiter": 60}, nonfinite_penalty=1e15)
    final = float(theta.value[0])
    assert not (bool(res.success) and res.fun >= 1e15)
    assert np.isfinite(res.fun) and res.fun <= 1e16 * (4.0 + 3.0) ** 2
    assert final >= 0.0, final
    assert np.isfinite(loss().item())
    np.testing.assert_allclose(float(res.fun), 1e16 * (final + 3.0) ** 2, rtol=1e-6)


def test_restored_best_point_carries_its_own_gradient():
    # where scipy ends on a penalized iterate, x, fun and jac all come from
    # the best finite evaluation (the JAX package restores x and fun only)
    theta, loss = _nan_region_problem(scale=1e16)
    res = Scipy().minimize(loss, [theta], options={"maxiter": 60}, nonfinite_penalty=1e15)
    assert res.n_nonfinite_evals > 0
    t = torch.tensor(np.asarray(res.x), requires_grad=True)
    with torch.no_grad():
        theta.unconstrained.copy_(t)
    theta.unconstrained.grad = None
    loss().backward()
    np.testing.assert_allclose(np.asarray(res.jac), theta.unconstrained.grad.numpy(), rtol=1e-12)
    np.testing.assert_allclose(float(res.fun), loss().item(), rtol=1e-12)
