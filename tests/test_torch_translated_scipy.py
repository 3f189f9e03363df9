"""The JAX package's ``tests/gpflow_tpu/optimizers/test_scipy.py``, translated onto
the port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Scipy optimizer behavior (pattern from reference
``tests/gpflow/optimizers/test_scipy.py``): step callbacks, compile modes,
variable subsets, unused-variable handling, and input validation.
"""
import os

import numpy as np
import pytest
import torch

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch import kernels
from gpflow_tpu_torch.models import GPR
from gpflow_tpu_torch.optimizers import Scipy
from .test_torch_translated_support import DEVICE, deviation, translated_test_environment  # noqa: F401

rng = np.random.RandomState(41)
N = 30
X = rng.rand(N, 1) * 5
Y = np.sin(X) + 0.1 * rng.randn(N, 1)


def _model():
    return GPR((X, Y), kernel=kernels.SquaredExponential(), noise_variance=0.5)


def test_minimize_reduces_loss_and_reports_iterations():
    m = _model()
    before = float(m.training_loss())
    res = Scipy().minimize(m.training_loss, m.trainable_variables, options={"maxiter": 50})
    after = float(m.training_loss())
    assert after < before - 1.0
    assert res.nit > 1
    np.testing.assert_allclose(float(res.fun), after, rtol=1e-10)


def test_step_callback_sees_every_iteration():
    m = _model()
    steps = []
    values_log = []

    def cb(step, variables, values):
        steps.append(step)
        assert len(variables) == len(values) == len(m.trainable_variables)
        values_log.append([np.asarray(v).copy() for v in values])

    res = Scipy().minimize(
        m.training_loss, m.trainable_variables, step_callback=cb,
        options={"maxiter": 10},
    )
    assert steps == list(range(len(steps)))
    # per-ITERATION semantics (reference scipy.py:256-273): the callback rides
    # scipy's `callback`, called once per iteration, not per function eval
    assert len(steps) == res.nit
    # values must change over the optimization
    assert not all(
        np.allclose(a, b) for a, b in zip(values_log[0], values_log[-1])
    )


def test_track_loss_history():
    m = _model()
    res = Scipy().minimize(
        m.training_loss, m.trainable_variables, track_loss_history=True,
        options={"maxiter": 25},
    )
    hist = res["loss_history"]
    assert len(hist) == res.nit
    # monotone-ish decrease: the last recorded loss is the best and matches
    # the converged objective
    assert float(hist[-1]) <= float(hist[0])
    np.testing.assert_allclose(float(hist[-1]), float(res.fun), rtol=1e-8)


def test_track_loss_history_chains_with_step_callback():
    m = _model()
    steps = []
    res = Scipy().minimize(
        m.training_loss, m.trainable_variables,
        step_callback=lambda s, v, vals: steps.append(s),
        track_loss_history=True,
        options={"maxiter": 10},
    )
    assert len(steps) == len(res["loss_history"]) == res.nit


def test_monitor_as_step_callback():
    from gpflow_tpu_torch.monitor import ExecuteCallback, Monitor, MonitorTaskGroup

    m = _model()
    seen = []
    monitor = Monitor(MonitorTaskGroup(ExecuteCallback(lambda: seen.append(1)), period=1))
    res = Scipy().minimize(
        m.training_loss, m.trainable_variables, step_callback=monitor,
        options={"maxiter": 10},
    )
    assert len(seen) == res.nit


def test_step_callback_and_raw_callback_conflict():
    m = _model()
    with pytest.raises(ValueError, match="Callback passed both"):
        Scipy().minimize(
            m.training_loss, m.trainable_variables,
            step_callback=lambda s, v, vals: None,
            callback=lambda x: None,
        )


@pytest.mark.parametrize("compile_", [True, False])
def test_compile_modes_agree(compile_):
    m = _model()
    Scipy().minimize(
        m.training_loss, m.trainable_variables, compile=compile_,
        options={"maxiter": 40},
    )
    # both modes should land at (nearly) the same optimum
    assert float(m.training_loss()) < -10


def test_optimizes_only_given_subset():
    m = _model()
    ls_before = float(m.kernel.lengthscales.value)
    noise_before = float(m.likelihood.variance.value)
    Scipy().minimize(
        m.training_loss, (m.kernel.variance,), options={"maxiter": 20}
    )
    assert float(m.kernel.lengthscales.value) == ls_before
    assert float(m.likelihood.variance.value) == noise_before
    assert float(m.kernel.variance.value) != 1.0


def test_unused_variable_raises_unless_allowed():
    m = _model()
    extra = gpf.Parameter(1.0, name="unused")
    with pytest.raises(ValueError, match="unused|gradient"):
        Scipy().minimize(
            m.training_loss, tuple(m.trainable_variables) + (extra,),
            options={"maxiter": 2},
        )
    res = Scipy().minimize(
        m.training_loss, tuple(m.trainable_variables) + (extra,),
        allow_unused_variables=True, options={"maxiter": 5},
    )
    assert np.isfinite(float(res.fun))
    np.testing.assert_allclose(float(extra.value), 1.0, rtol=1e-12)


def test_input_validation():
    m = _model()
    with pytest.raises(TypeError, match="callable"):
        Scipy().minimize(1.0, m.trainable_variables)
    with pytest.raises(TypeError, match="Parameters"):
        Scipy().minimize(m.training_loss, [np.zeros(2)])


def test_stop_gradient_only_variable_detected_as_unused():
    """A variable consumed ONLY through stop_gradient has identically-zero
    gradients; the unconnected check must catch it (the reference's
    gradient-based check does, ref scipy.py:229-253)."""
    m = _model()
    shadow = gpf.Parameter(2.0, name="shadow")

    def closure():
        return m.training_loss() + shadow.value.detach() * 0.0

    with pytest.raises(ValueError, match="shadow"):
        Scipy().minimize(
            closure, tuple(m.trainable_variables) + (shadow,), options={"maxiter": 2}
        )


def test_compile_cache_reuses_traced_function():
    """Repeated minimize with the same closure/variables must not re-trace
    (reference scipy.py:47-70, 214-219)."""
    m = _model()
    traces = [0]

    def closure():
        traces[0] += 1  # incremented only at TRACE time under jit
        return m.training_loss()

    opt = Scipy()
    opt.minimize(closure, m.trainable_variables, options={"maxiter": 3})
    n_after_first = traces[0]
    assert len(opt.compile_cache) == 1
    opt.minimize(closure, m.trainable_variables, options={"maxiter": 3})
    # second call: cache hit -> no new traces (jit re-traces only on new
    # shapes/dtypes, which don't change here)
    assert traces[0] == n_after_first
    assert len(opt.compile_cache) == 1


def test_compile_cache_bound_method_closures_hit():
    # m.training_loss creates a fresh bound method each access; bound methods
    # compare equal, so the cache must still hit
    m = _model()
    opt = Scipy()
    opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 3})
    opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 3})
    assert len(opt.compile_cache) == 1


def test_compile_cache_eviction_and_disable():
    m1, m2, m3 = _model(), _model(), _model()
    opt = Scipy(compile_cache_size=2)
    for m in (m1, m2, m3):
        opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 2})
    assert len(opt.compile_cache) == 2  # oldest evicted

    opt0 = Scipy(compile_cache_size=0)
    opt0.minimize(m1.training_loss, m1.trainable_variables, options={"maxiter": 2})
    assert len(opt0.compile_cache) == 0

    with pytest.raises(ValueError, match="non-negative"):
        Scipy(compile_cache_size=-1)


def test_scipy_picklable_without_cache():
    import pickle

    m = _model()
    opt = Scipy()
    opt.minimize(m.training_loss, m.trainable_variables, options={"maxiter": 2})
    assert len(opt.compile_cache) == 1
    restored = pickle.loads(pickle.dumps(opt))
    assert len(restored.compile_cache) == 0
    assert restored.compile_cache_size == opt.compile_cache_size


@deviation("the matmul tiers")
def test_fused_path_under_disabled_x64_with_tril_parameter():
    """GPFLOW_TPU_DISABLE_X64=1 (reduced-precision mode): scipy hands the
    fused flat_value_and_grad a float64 iterate which is downcast to float32
    at the single jnp.asarray boundary (scipy.py flat eval). Pins that the
    fused path still optimizes an SVGP (tril q_sqrt parameter included) and
    returns float64 (loss, grad) to scipy, so the rounding point moving
    device-side stays behavioral-equivalent."""
    import subprocess
    import sys
    import textwrap

    prog = textwrap.dedent(
        f"""
        import os
        os.environ["GPFLOW_TPU_DISABLE_X64"] = "1"
        import numpy as np
        import torch
        import gpflow_tpu_torch as gpf
        gpf.config.set_default_device({DEVICE.type!r})

        # x64 disabled: jax stores every leaf as float32 regardless of the
        # requested dtype
        assert torch.as_tensor(np.asarray(1.0)).dtype == torch.float32
        rng = np.random.RandomState(0)
        X = rng.rand(40, 2) * 3
        Y = np.sin(X[:, :1]) + 0.05 * rng.randn(40, 1)
        Z = X[:8].copy()
        m = gpf.models.SVGP(
            kernel=gpf.kernels.SquaredExponential(),
            likelihood=gpf.likelihoods.Gaussian(),
            inducing_variable=Z,
        )
        # host-resident leaves keep their declared f64 dtype; the DEVICE
        # computation is what drops to float32 under disabled x64
        assert m.training_loss((X, Y)).dtype == torch.float32
        assert m.q_sqrt.shape == (1, 8, 8)  # tril parameter in the flat vector
        before = float(m.training_loss((X, Y)))
        opt = gpf.optimizers.Scipy()
        res = opt.minimize(
            m.training_loss_closure((X, Y)),
            m.trainable_variables,
            options={{"maxiter": 25}},
        )
        after = float(m.training_loss((X, Y)))
        assert np.isfinite(after), after
        assert after < before - 0.5, (before, after)
        # scipy's L-BFGS iterate stays float64 on the host even though the
        # device computed in f32
        assert np.asarray(res.x).dtype == np.float64
        print("OK", before, after)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "GPFLOW_TPU_DISABLE_X64"}
    proc = subprocess.run(
        [sys.executable, "-c", prog], capture_output=True, text=True, env=env
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "OK" in proc.stdout


def test_nonfinite_penalty_recovers_from_nan_region():
    """nonfinite_penalty turns a NaN evaluation into a rejected trial point
    (zero grad + huge loss -> Armijo backtracks) where stock L-BFGS-B
    aborts the whole run with fun=NaN. Loss is NaN for theta < 0 with the
    masked optimum at theta=-3, so the line search MUST probe the NaN
    region on its way to the accessible minimum near the boundary."""
    from gpflow_tpu_torch.base import Parameter

    def make():
        theta = Parameter(np.array([4.0]), name="theta")

        def loss():
            t = theta.value
            clean = torch.sum((t + 3.0) ** 2)
            return torch.where(torch.any(t < 0), torch.nan, clean)

        return theta, loss

    # without the guard: scipy hits NaN and gives up at a NaN objective
    theta, loss = make()
    res_plain = Scipy().minimize(loss, [theta], options={"maxiter": 50})
    assert not np.isfinite(res_plain.fun)

    # with the guard: converges to the boundary of the finite region
    theta, loss = make()
    res = Scipy().minimize(
        loss, [theta], options={"maxiter": 50}, nonfinite_penalty=1e15
    )
    assert np.isfinite(res.fun)
    assert res.n_nonfinite_evals > 0
    final = float(np.asarray(theta.value)[0])
    assert 0.0 <= final < 0.5, final
    np.testing.assert_allclose(float(res.fun), (final + 3.0) ** 2, rtol=1e-6)


def test_nonfinite_penalty_raises_on_broken_initial_point():
    """A non-finite FIRST evaluation is a broken model, not a line-search
    trial: returning (penalty, zero-grad) there would let L-BFGS-B declare
    instant success at the unusable starting parameters."""
    from gpflow_tpu_torch.base import Parameter

    theta = Parameter(np.array([-4.0]), name="theta")

    def loss():
        t = theta.value
        return torch.where(torch.any(t < 0), torch.nan, torch.sum(t**2))

    with pytest.raises(FloatingPointError, match="initial"):
        Scipy().minimize(loss, [theta], options={"maxiter": 10},
                         nonfinite_penalty=1e15)


def test_nonfinite_penalty_scales_above_large_finite_losses():
    """The penalty must dominate every finite loss seen: with losses ~1e16
    and a fixed 1e15 penalty, a NaN trial would otherwise read as an
    IMPROVEMENT (lower f, zero slope), be accepted, and L-BFGS-B would
    declare success inside the NaN region."""
    from gpflow_tpu_torch.base import Parameter

    theta = Parameter(np.array([4.0]), name="theta")

    def loss():
        t = theta.value
        clean = 1e16 * torch.sum((t + 3.0) ** 2)
        return torch.where(torch.any(t < 0), torch.nan, clean)

    res = Scipy().minimize(
        loss, [theta], options={"maxiter": 60}, nonfinite_penalty=1e15
    )
    final = float(np.asarray(theta.value)[0])
    # never a fake success at a penalized/NaN point ...
    assert not (bool(res.success) and res.fun >= 1e15)
    # ... and the assigned parameters are the best FINITE point evaluated
    # (scipy's abnormal exit may internally end on a penalized iterate)
    assert np.isfinite(res.fun) and res.fun <= 1e16 * (4.0 + 3.0) ** 2
    assert final >= 0.0, final
    assert np.isfinite(float(loss())), "assigned parameters must be usable"
    np.testing.assert_allclose(float(res.fun), 1e16 * (final + 3.0) ** 2,
                               rtol=1e-6)
