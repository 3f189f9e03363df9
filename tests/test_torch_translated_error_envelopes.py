"""The JAX package's ``tests/gpflow_tpu/test_error_envelopes.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Condition-number-sweep property tests for the documented fast-path error
envelopes (VERDICT r3 #9).

Each fast path states a numeric envelope in its docstring; these tests sweep
the conditioning knob and assert (a) the envelope holds and (b) the
documented fallbacks engage. The FAST_MATMUL precision tiers only exist on
TPU hardware (CPU matmuls ignore the precision hint) — those claims are
asserted on the real chip by ``tools/envelope_fuzz.py`` via
``tests/tpu/test_tpu_envelopes.py``.
"""
import numpy as np
import pytest
import torch

import gpflow_tpu_torch
from gpflow_tpu_torch import kernels
from gpflow_tpu_torch.conditionals.util import base_conditional, inv_solve
from gpflow_tpu_torch.ops import pallas_distance
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)


def _spd_with_cond(m: int, cond: float) -> np.ndarray:
    """Random SPD [m, m] matrix with condition number ~cond."""
    Q, _ = np.linalg.qr(rng.randn(m, m))
    eigs = np.logspace(0, -np.log10(cond), m)
    return (Q * eigs) @ Q.T


# ---------------------------------------------------------------------------
# 1. INV_SOLVE: the inverse-based projection must track the solve-based one
#    with error growing at most ~cond(Kuu) * eps (one explicit triangular
#    inverse), across a conditioning sweep.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6, 1e8])
def test_inv_solve_envelope_f64(cond):
    M, N, R = 64, 256, 2
    Kmm = asarray(_spd_with_cond(M, cond))
    Kmn = asarray(rng.randn(M, N))
    Knn = asarray(np.abs(rng.randn(N)) + 1.0)
    f = asarray(rng.randn(M, R))
    q_sqrt = asarray(np.tril(rng.randn(R, M, M)) * 0.1)

    with inv_solve(False):
        mean_s, var_s = base_conditional(Kmn, Kmm, Knn, f, q_sqrt=q_sqrt)
    with inv_solve(True):
        mean_i, var_i = base_conditional(Kmn, Kmm, Knn, f, q_sqrt=q_sqrt)

    eps = np.finfo(np.float64).eps
    # one explicit L^-1 costs ~cond(L) * eps = ~sqrt(cond(K)) * eps per
    # application; the quadratic form squares it -> envelope cond(K) * eps.
    envelope = max(1e-12, cond * eps * 50)
    scale = float(torch.max(torch.abs(var_s))) + 1.0
    assert float(torch.max(torch.abs(mean_i - mean_s))) < envelope * (
        float(torch.max(torch.abs(mean_s))) + 1.0
    )
    assert float(torch.max(torch.abs(var_i - var_s))) < envelope * scale


def test_inv_solve_only_engages_when_wide():
    """The fast path is documented for N > M only; at N <= M the solve path
    must be used even with the flag on (same math either way — this pins the
    gating so a regression cannot silently invert for narrow RHS)."""
    M, N = 32, 16
    Kmm = asarray(_spd_with_cond(M, 1e3))
    Kmn = asarray(rng.randn(M, N))
    Knn = asarray(np.abs(rng.randn(N)) + 1.0)
    f = asarray(rng.randn(M, 1))
    with inv_solve(True):
        mean, var = base_conditional(Kmn, Kmm, Knn, f)
    with inv_solve(False):
        mean2, var2 = base_conditional(Kmn, Kmm, Knn, f)
    # N <= M: both calls take the identical solve route -> bitwise equal
    np.testing.assert_array_equal(np.asarray(mean), np.asarray(mean2))
    np.testing.assert_array_equal(np.asarray(var), np.asarray(var2))


# ---------------------------------------------------------------------------
# 2. Pallas routing: float64 must NEVER route to the Pallas kernel (it
#    computes in f32 internally), regardless of any force-enable.
# ---------------------------------------------------------------------------


def test_pallas_never_available_for_f64():
    try:
        pallas_distance.set_pallas_enabled(True)  # force-enable
        assert not pallas_distance.pallas_available(torch.float64)
        assert not pallas_distance.pallas_available(np.float64)
        # ...and the f32/bf16 gate still consults the platform, not just the
        # flag (on CPU it may legitimately be False; it must not crash)
        pallas_distance.pallas_available(torch.float32)
    finally:
        pallas_distance.set_pallas_enabled(None)


def test_f64_kernel_matrix_matches_numpy_exactly():
    """End-to-end: an f64 SquaredExponential K matrix must be the XLA (not
    Pallas-f32) result — pinned by agreeing with NumPy at f64 precision."""
    X = rng.randn(64, 3)
    k = kernels.SquaredExponential(variance=1.7, lengthscales=[0.5, 1.0, 2.0])
    try:
        pallas_distance.set_pallas_enabled(True)
        K = np.asarray(k(X))
    finally:
        pallas_distance.set_pallas_enabled(None)
    d = (X[:, None, :] - X[None, :, :]) / np.array([0.5, 1.0, 2.0])
    K_np = 1.7 * np.exp(-0.5 * np.sum(d * d, -1))
    np.testing.assert_allclose(K, K_np, rtol=1e-12, atol=1e-12)


# ---------------------------------------------------------------------------
# 3. Cached-Qinv posterior: variance error vs the fused pipeline grows
#    ~cond(Kuu)^2 * eps (posteriors.py module docstring), with the two
#    anchor points the docstring states: < 1e-10 at cond ~1e3, and a
#    usable-but-drifting ~<=1e-3 at cond ~1e7.
# ---------------------------------------------------------------------------


def _svgp_posterior_errors(spread: float):
    """SVGP with 1-D inducing points clustered by ``spread``; returns
    (cond(Kuu), max |cached_var - fused_var|)."""
    M = 32
    Z = np.linspace(0, spread, M)[:, None]
    X = rng.rand(128, 1) * max(spread, 1.0)
    model = gpflow_tpu_torch.models.SVGP(
        kernel=kernels.SquaredExponential(),
        likelihood=gpflow_tpu_torch.likelihoods.Gaussian(0.1),
        inducing_variable=Z,
        num_data=len(X),
    )
    model.q_mu.assign(rng.randn(M, 1) * 0.3)
    model.q_sqrt.assign(np.tril(rng.randn(1, M, M)) * 0.05 + np.eye(M) * 0.3)

    from gpflow_tpu_torch.covariances import Kuu

    K = np.asarray(Kuu(model.inducing_variable, model.kernel,
                       jitter=gpflow_tpu_torch.default_jitter()))
    cond = float(np.linalg.cond(K))

    posterior = model.posterior()  # cached (alpha, Qinv)
    mean_c, var_c = posterior.predict_f(X)
    mean_f, var_f = posterior.fused_predict_f(X)
    err = float(np.max(np.abs(np.asarray(var_c) - np.asarray(var_f))))
    return cond, err


def test_cached_qinv_error_scales_with_cond_squared():
    # spread 30 -> cond ~1e2; spread <= 0.035 saturates at the jitter floor
    # cond ~ M/jitter ~ 3e7 (measured anchors in the commit that added this)
    results = [_svgp_posterior_errors(s) for s in (30.0, 10.0, 1.0, 0.035)]
    conds = np.array([c for c, _ in results])
    errs = np.array([e for _, e in results])
    eps = np.finfo(np.float64).eps
    # envelope: err <= C * cond^2 * eps with a generous constant
    assert np.all(errs <= 1e3 * conds**2 * eps + 1e-14), (conds, errs)
    # docstring anchor 1: well-conditioned (cond <~ 1e3) -> error < 1e-10
    well = errs[conds < 2e3]
    assert well.size > 0 and np.all(well < 1e-10), (conds, errs)
    # docstring anchor 2 (f64): even at the jitter-floor conditioning ~3e7
    # the drift stays tiny; the documented ~1e-3 ceiling is the f32 regime
    # (asserted on the real chip by tools/envelope_fuzz.py)
    assert np.all(errs < 1e-7), (conds, errs)
    # and the sweep really covered a wide conditioning range
    assert conds.max() / conds.min() > 1e4, conds
