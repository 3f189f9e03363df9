"""The JAX package's ``tests/gpflow_tpu/test_pallas_ops.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

The JAX file calls the private back-compat aliases of
``gpflow_tpu/ops/pallas_distance.py``, which the port does not have; each
maps to the port's routed function (the map's note on each row):

* ``_rbf_pallas_forward(X, Z, var, interpret=True)`` and
  ``_stationary_pallas_forward(family, ..., interpret=True)`` are
  ``stationary_forward(family, ...)``, and ``_stationary_pallas_wgrad(...,
  interpret=True)`` is ``stationary_wgrad(...)``: on the CPU they route to
  the plain versions, as interpret mode stands in for the kernels in the JAX
  package; with float32 tensors on the card they launch K1 and K2;
* ``_rbf_scaled_bwd((Xs, Zs, var, K), g)`` is the alias's body,
  ``_stationary_bwd_from_w`` with W = -g K / 2, and ``_rq_bwd(res, g)`` the
  backward of ``_RationalQuadratic`` on the same saved tensors; the port's
  ``_stationary_bwd_from_w`` takes which gradients to form first.

Pallas covariance-kernel tests (interpret mode on CPU; the real-TPU path is
exercised by bench.py / verification drives).
"""
import types

import numpy as np
import pytest
import torch

from gpflow_tpu_torch.ops.pallas_distance import (
    pallas_available,
    set_pallas_enabled,
    stationary_forward,
)
from .test_torch_translated_support import DEVICE, asarray, translated_test_environment, vjp  # noqa: F401

rng = np.random.RandomState(0)


def _rbf_scaled_bwd(res, g):
    """``_rbf_scaled_bwd`` of the JAX package (``pallas_distance.py:350``)."""
    Xs, Zs, variance, K = res
    W = -0.5 * (g * K)
    return _stationary_bwd_from_w(Xs, Zs, variance, K, W, g)


def _rq_bwd(res, g):
    """``_rq_bwd`` (``pallas_distance.py:279``): the port's rq backward on
    the same saved tensors."""
    ctx = types.SimpleNamespace(saved_tensors=res, needs_input_grad=(True,) * 4)
    return _RationalQuadratic.backward(ctx, g)


@pytest.mark.parametrize("N,M,D", [(16, 24, 3), (100, 130, 5), (8, 8, 1)])
def test_pallas_rbf_forward_matches_xla(N, M, D):
    X = asarray(rng.randn(N, D), torch.float32)
    Z = asarray(rng.randn(M, D), torch.float32)
    var = asarray(1.7, torch.float32)
    K = np.asarray(stationary_forward("rbf", X, Z, var))
    d2 = np.sum((np.asarray(X)[:, None, :] - np.asarray(Z)[None, :, :]) ** 2, -1)
    expected = 1.7 * np.exp(-0.5 * d2)
    np.testing.assert_allclose(K, expected, rtol=1e-5, atol=1e-6)


def test_pallas_rbf_custom_vjp_matches_autodiff():
    N, M, D = 12, 10, 3
    Xs = asarray(rng.randn(N, D), torch.float32)
    Zs = asarray(rng.randn(M, D), torch.float32)
    var = asarray(1.3, torch.float32)
    g = asarray(rng.randn(N, M), torch.float32)

    # reference function in plain XLA
    def ref(Xs, Zs, var):
        d2 = torch.sum((Xs[:, None, :] - Zs[None, :, :]) ** 2, -1)
        return var * torch.exp(-0.5 * d2)

    _, ref_vjp = vjp(ref, Xs, Zs, var)
    dX_ref, dZ_ref, dv_ref = ref_vjp(g)

    K, res = (None, None)  # the JAX alias _rbf_scaled_fwd has no __wrapped__
    # compute residuals using the XLA forward (identical math) to test the bwd formulas
    Kx = ref(Xs, Zs, var)
    dX, dZ, dv = _rbf_scaled_bwd((Xs, Zs, var, Kx), g)
    np.testing.assert_allclose(np.asarray(dX), np.asarray(dX_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dZ), np.asarray(dZ_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dv_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.skipif(DEVICE.type != "cpu", reason="the JAX test's premise: the tests run on the CPU")
def test_pallas_disabled_on_cpu_by_default():
    # tests run on CPU: auto mode must not select the pallas path
    assert not pallas_available(torch.float64)
    assert not pallas_available(torch.float32)


def test_set_pallas_enabled_override():
    set_pallas_enabled(True)
    try:
        assert pallas_available(torch.float32)
        # f64 must never route through the f32 kernel, even when forced
        assert not pallas_available(torch.float64)
    finally:
        set_pallas_enabled(None)


def test_squared_exponential_uses_pallas_when_forced():
    """Force-enable: SquaredExponential.K must agree with the XLA path
    (pallas interpret mode is used transparently on CPU? No — forcing on CPU
    runs the compiled pallas path via interpret fallback only if requested,
    so here we compare the module-level kernel fn in interpret mode)."""
    from gpflow_tpu_torch import kernels

    X = rng.randn(20, 2).astype(np.float32)
    k = kernels.SquaredExponential(variance=1.2, lengthscales=0.7)
    K_xla = np.asarray(k(X))
    Xs = asarray(X / 0.7, torch.float32)
    K_pallas = 1.2 * np.asarray(
        stationary_forward("rbf", Xs, Xs, asarray(1.0, torch.float32))
    )
    np.testing.assert_allclose(K_pallas, K_xla, rtol=2e-4, atol=1e-5)


# --- stationary family generalization ---------------------------------------

from gpflow_tpu_torch.ops.pallas_distance import (  # noqa: E402
    PALLAS_FAMILIES,
    _RationalQuadratic,
    _stationary_bwd_from_w as _port_bwd_from_w,
    _tail_grad,  # noqa: F401
    _tail_value,
    stationary_wgrad,
)


def _stationary_bwd_from_w(Xs, Zs, variance, K, W, g):
    """``_stationary_bwd_from_w`` of the JAX package: every gradient."""
    return _port_bwd_from_w((True, True, True), Xs, Zs, variance, K, W, g)


def _xla_family(family, Xs, Zs, var):
    d2 = torch.sum((Xs[:, None, :] - Zs[None, :, :]) ** 2, -1)
    alpha = asarray(1.0, torch.float32) if family == "rq" else None
    return var * _tail_value(family, d2, alpha)


@pytest.mark.parametrize("family", PALLAS_FAMILIES)
def test_pallas_family_forward_matches_xla(family):
    N, M, D = 33, 21, 4
    Xs = asarray(rng.randn(N, D), torch.float32)
    Zs = asarray(rng.randn(M, D), torch.float32)
    var = asarray(1.7, torch.float32)
    alpha = asarray(1.0, torch.float32) if family == "rq" else None
    K = np.asarray(stationary_forward(family, Xs, Zs, var, alpha))
    expected = np.asarray(_xla_family(family, Xs, Zs, var))
    np.testing.assert_allclose(K, expected, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("family", [f for f in PALLAS_FAMILIES if f != "rq"])
def test_pallas_family_vjp_matches_autodiff(family):
    # rq's VJP (including d/dalpha) has its own dedicated test below
    N, M, D = 14, 11, 3
    Xs = asarray(rng.randn(N, D), torch.float32)
    Zs = asarray(rng.randn(M, D) + 3.0, torch.float32)  # keep r away from 0
    var = asarray(1.3, torch.float32)
    g = asarray(rng.randn(N, M), torch.float32)

    _, ref_vjp = vjp(lambda x, z, v: _xla_family(family, x, z, v), Xs, Zs, var)
    dX_ref, dZ_ref, dv_ref = ref_vjp(g)

    K = _xla_family(family, Xs, Zs, var)
    if family == "rbf":
        W = -0.5 * (g * K)
    else:
        W = stationary_wgrad(family, Xs, Zs, var, g)
    dX, dZ, dv = _stationary_bwd_from_w(Xs, Zs, var, K, W, g)
    np.testing.assert_allclose(np.asarray(dX), np.asarray(dX_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dZ), np.asarray(dZ_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dv_ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cls_name", ["Matern12", "Matern32", "Matern52", "Exponential"])
def test_matern_kernel_routes_pallas_when_forced(cls_name):
    """End-to-end: kernel.K through the forced-on Pallas path (interpret via
    CPU lowering is not available for pallas_call on this backend, so compare
    the routing decision only at value level with pallas disabled/enabled on
    the XLA fallback: the family parity above covers the math)."""
    from gpflow_tpu_torch import kernels as gk

    cls = getattr(gk, cls_name)
    k = cls(lengthscales=np.array([0.7, 1.3]), variance=1.1)
    X = rng.randn(9, 2)
    K1 = np.asarray(k(X))  # CPU: XLA path
    d2 = np.sum(((X[:, None, :] - X[None, :, :]) / np.array([0.7, 1.3])) ** 2, -1)
    family = {"Matern12": "matern12", "Matern32": "matern32",
              "Matern52": "matern52", "Exponential": "exponential"}[cls_name]
    expected = 1.1 * np.asarray(_tail_value(family, asarray(d2)))
    np.testing.assert_allclose(K1, expected, rtol=1e-6, atol=1e-8)


def test_subclass_override_not_routed_to_pallas():
    """A user subclass overriding K_r must keep its own math even when the
    Pallas path is force-enabled (exact-type routing)."""
    from gpflow_tpu_torch import kernels as gk

    class MyMatern(gk.Matern32):
        def K_r(self, r):
            return self.variance * torch.exp(-7.0 * r)

    set_pallas_enabled(True)
    try:
        k = MyMatern()
        X = asarray(rng.randn(6, 2), torch.float32)
        K = np.asarray(k(X))
        d2 = np.sum((np.asarray(X)[:, None, :] - np.asarray(X)[None, :, :]) ** 2, -1)
        r = np.sqrt(np.maximum(d2, 1e-36))
        np.testing.assert_allclose(K, np.exp(-7.0 * r), rtol=1e-5, atol=1e-6)
    finally:
        set_pallas_enabled(None)


def test_pallas_rq_forward_and_vjp_match_autodiff():
    """RationalQuadratic family: value and ALL gradients (incl. alpha, which
    is reconstructed elementwise from the saved K) match plain autodiff."""
    N, M, D = 17, 13, 3
    Xs = asarray(rng.randn(N, D), torch.float32)
    Zs = asarray(rng.randn(M, D), torch.float32)
    var = asarray(1.4, torch.float32)
    alpha = asarray(0.7, torch.float32)
    g = asarray(rng.randn(N, M), torch.float32)

    def ref(Xs, Zs, var, alpha):
        d2 = torch.sum((Xs[:, None, :] - Zs[None, :, :]) ** 2, -1)
        return var * (1 + 0.5 * d2 / alpha) ** (-alpha)

    K_ref = ref(Xs, Zs, var, alpha)
    K_pal = stationary_forward("rq", Xs, Zs, var, alpha)
    np.testing.assert_allclose(np.asarray(K_pal), np.asarray(K_ref), rtol=1e-5, atol=1e-6)

    _, ref_vjp = vjp(ref, Xs, Zs, var, alpha)
    dX_r, dZ_r, dv_r, da_r = ref_vjp(g)
    dX, dZ, dv, da = _rq_bwd((Xs, Zs, var, alpha, K_ref), g)
    np.testing.assert_allclose(np.asarray(dX), np.asarray(dX_r), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dZ), np.asarray(dZ_r), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(dv), np.asarray(dv_r), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(da), np.asarray(da_r), rtol=1e-3, atol=1e-4)
