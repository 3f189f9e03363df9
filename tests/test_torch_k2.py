"""Kernel K2 and the stationary autograd Functions of gpflow_tpu_torch on the
CPU: K2's plain version against the JAX package's Pallas kernel (interpret
mode), the gradients of ``stationary_kernel_matrix`` against the JAX custom
VJP and against autodiff of the JAX kernel classes, and the plumbing around
the CUDA kernel that can be checked without a card. The CUDA kernel itself is
held against its plain version on the card by chip_smoke.py.

Points are kept apart (Zs shifted by 3) where the port is held against the
JAX package's Pallas VJP: for exponential and Matern 1/2 that VJP keeps the
1/r of h' at r = 0, where K2 and the XLA path give 0. Coincident points are
held against the XLA path, on inputs where its distances are exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflow_tpu import kernels as jax_kernels
from gpflow_tpu.ops.pallas_distance import (
    _rq_bwd,
    _stationary_bwd_from_w,
    _stationary_pallas_forward,
    _stationary_pallas_wgrad,
)
from gpflow_tpu_torch import config, kernels, likelihoods
from gpflow_tpu_torch.models import SVGP
from gpflow_tpu_torch.ops import pallas_distance as pd

from chip_smoke import K2_OFFSET_G_SHAPE, K2_SHAPES
from tests.test_torch_k1 import EDGE_SHAPES, SMS, _resident, check_plan_covers

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

FAMILIES = pd.PALLAS_FAMILIES
KUU_FAMILIES = ("rbf", "rq", "matern32", "matern52")
JAX_CLASSES = {
    "rbf": jax_kernels.SquaredExponential,
    "rq": jax_kernels.RationalQuadratic,
    "exponential": jax_kernels.Exponential,
    "matern12": jax_kernels.Matern12,
    "matern32": jax_kernels.Matern32,
    "matern52": jax_kernels.Matern52,
}


def _apart(seed, N, M, D, dtype=np.float32):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D).astype(dtype)
    Z = (rng.randn(M, D) + 3.0).astype(dtype)
    return rng, X, Z


def test_wgrad_families_are_the_jax_kernels_non_rbf_non_rq_families():
    assert pd.WGRAD_FAMILIES == tuple(f for f in FAMILIES if f not in ("rbf", "rq"))


@pytest.mark.parametrize("N,M,D", [(33, 21, 4), (14, 11, 3), (100, 50, 5)])
@pytest.mark.parametrize("family", pd.WGRAD_FAMILIES)
def test_plain_k2_matches_jax_pallas_wgrad_f32(family, N, M, D):
    # f32 on both sides, d2 by the norm expansion summed in different orders:
    # the JAX Pallas tests' own tolerance (tests/gpflow_tpu/test_pallas_ops.py:115)
    rng, Xs, Zs = _apart(N + M + D, N, M, D)
    g = rng.randn(N, M).astype(np.float32)
    var = np.float32(1.3)
    expected = np.asarray(_stationary_pallas_wgrad(
        family, jnp.asarray(Xs), jnp.asarray(Zs), jnp.asarray(var), jnp.asarray(g), interpret=True
    ))
    got = pd.stationary_wgrad(family, torch.from_numpy(Xs), torch.from_numpy(Zs), torch.tensor(var),
                              torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (N, M)
    np.testing.assert_allclose(got.numpy(), expected, rtol=1e-5, atol=1e-6)


def test_plain_k2_f64_computes_in_f64_and_bf16_in_f32():
    rng, Xs, Zs = _apart(1, 9, 7, 3, np.float64)
    g = rng.randn(9, 7)
    W64 = pd.stationary_wgrad_plain("matern32", torch.from_numpy(Xs), torch.from_numpy(Zs),
                                    torch.tensor(1.1, dtype=torch.float64), torch.from_numpy(g))
    assert W64.dtype == torch.float64
    xb = torch.from_numpy(Xs).to(torch.bfloat16)
    zb = torch.from_numpy(Zs).to(torch.bfloat16)
    Wb = pd.stationary_wgrad_plain("matern32", xb, zb, torch.tensor(1.1), torch.from_numpy(g).float())
    W32 = pd.stationary_wgrad_plain("matern32", xb.float(), zb.float(), torch.tensor(1.1), torch.from_numpy(g).float())
    assert Wb.dtype == torch.float32
    np.testing.assert_array_equal(Wb.numpy(), W32.numpy())


def _jax_custom_vjp_f32(family, Xs, Zs, var, alpha, g):
    """The JAX package's backward: K and W from its interpret-mode kernels
    (or W from the saved K), then ``_stationary_bwd_from_w`` / ``_rq_bwd``."""
    Xs, Zs, var, g = map(jnp.asarray, (Xs, Zs, var, g))
    a = jnp.asarray(alpha) if family == "rq" else None
    K = _stationary_pallas_forward(family, Xs, Zs, var, a, interpret=True)
    if family == "rq":
        return _rq_bwd((Xs, Zs, var, a, K), g)
    if family == "rbf":
        W = -0.5 * (g * K)
    else:
        W = _stationary_pallas_wgrad(family, Xs, Zs, var, g, interpret=True)
    return _stationary_bwd_from_w(Xs, Zs, var, K, W, g)


def _port_grads(family, X, Z, ls, var, alpha, g, same):
    """Gradients of <g, stationary_kernel_matrix(...)> by torch autograd:
    (dX, dZ, dls, dvar, dalpha); Z is X itself where ``same``."""
    leaves = [torch.tensor(np.asarray(v), requires_grad=True) for v in (X, Z, ls, var, alpha)]
    Xt, Zt, lst, vart, alphat = leaves
    K = pd.stationary_kernel_matrix(Xt, Xt if same else Zt, lst, vart, family,
                                    alpha=alphat if family == "rq" else None)
    K.backward(torch.from_numpy(np.asarray(g)))
    return [None if t.grad is None else t.grad.numpy() for t in leaves]


def _check(got, want, rtol, atol):
    assert got is not None
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol * max(np.max(np.abs(want)), 1.0))


@pytest.mark.parametrize("family", FAMILIES)
def test_function_gradients_match_jax_custom_vjp_f32_kuf(family):
    # f32 on both sides: the JAX VJP test's own 1e-4 (test_pallas_ops.py:135-137)
    rng, X, Z = _apart(5, 14, 11, 3)
    g = rng.randn(14, 11).astype(np.float32)
    var, alpha = np.float32(1.3), np.float32(0.7)
    want = _jax_custom_vjp_f32(family, X, Z, var, alpha, g)
    got = _port_grads(family, X, Z, np.ones(3, np.float32), var, alpha, g, same=False)
    # want: (dXs, dZs, dvar[, dalpha]); got: (dX, dZ, dls, dvar, dalpha)
    for i, j in zip(range(len(want)), (0, 1, 3, 4)):
        _check(got[j], want[i], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("family", KUU_FAMILIES)
def test_function_gradients_match_jax_custom_vjp_f32_kuu(family):
    # one tensor on both sides: autograd adds the two input gradients
    rng = np.random.RandomState(6)
    X = rng.randn(12, 3).astype(np.float32)
    g = rng.randn(12, 12).astype(np.float32)
    var, alpha = np.float32(1.3), np.float32(0.7)
    want = _jax_custom_vjp_f32(family, X, X, var, alpha, g)
    got = _port_grads(family, X, X, np.ones(3, np.float32), var, alpha, g, same=True)
    _check(got[0], np.asarray(want[0]) + np.asarray(want[1]), rtol=1e-4, atol=1e-4)
    _check(got[3], want[2], rtol=1e-4, atol=1e-4)
    if family == "rq":
        _check(got[4], want[3], rtol=1e-4, atol=1e-4)


def _jax_class_vjp_f64(family, X, Z, ls, var, alpha, g, same):
    def K(X, Z, ls, var, alpha):
        kw = {"alpha": alpha} if family == "rq" else {}
        return JAX_CLASSES[family](variance=var, lengthscales=ls, **kw).K(X, None if same else Z)

    _, vjp = jax.vjp(K, *map(jnp.asarray, (X, Z, ls, var, alpha)))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("family,same", [(f, False) for f in FAMILIES] + [(f, True) for f in KUU_FAMILIES])
def test_function_gradients_match_jax_kernel_classes_f64(family, same):
    # f64 autodiff of the JAX classes' K (XLA path) against the port's custom
    # backward through the Function: the same derivative by two routes, to
    # f64 round-off
    rng, X, Z = _apart(7, 10, 8, 3, np.float64)
    if same:
        Z = X
    g = rng.randn(10, 10 if same else 8)
    ls, var, alpha = np.array([0.6, 1.1, 1.7]), np.float64(1.4), np.float64(0.8)
    want = _jax_class_vjp_f64(family, X, Z, ls, var, alpha, g, same)
    got = _port_grads(family, X, Z, ls, var, alpha, g, same)
    for i in (0, 2, 3) + ((4,) if family == "rq" else ()) + (() if same else (1,)):
        _check(got[i], want[i], rtol=1e-9, atol=1e-9)


def _coincident(seed, N, D):
    """[N, D] points on the grid of multiples of 1/8 with some rows repeated,
    and power-of-two lengthscales: every distance, and so the norm expansion
    of the JAX package's XLA path, is exact, with d2 = 0 on the diagonal and
    at the repeated rows."""
    rng = np.random.RandomState(seed)
    X = rng.randint(-12, 13, size=(N, D)) / 8.0
    X[N // 2:N // 2 + 3] = X[:3]
    return rng, X, 2.0 ** rng.randint(-1, 2, size=D)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("family", pd.WGRAD_FAMILIES)
def test_plain_k2_is_zero_at_coincident_points(family, dtype):
    # W = g var h'(d2) with h' taken as 0 under the 1e-36 clip, as K2 does:
    # the exponential and Matern 1/2 families' 1/r would give about -5e17
    rng, X, _ = _coincident(12, 20, 3)
    g = rng.randn(20, 20).astype(dtype)
    Xs = torch.from_numpy(X.astype(dtype))
    W = pd.stationary_wgrad(family, Xs, Xs, torch.tensor(1.3), torch.from_numpy(g)).numpy()
    same = np.all(X[:, None, :] == X[None, :, :], axis=-1)
    assert same.sum() == 20 + 6
    assert np.all(W[same] == 0.0)
    assert np.all(np.isfinite(W)) and np.all(W[~same] != 0.0)


@pytest.mark.parametrize("family", FAMILIES)
def test_function_gradients_at_coincident_points_match_jax_kernel_classes_f64(family):
    # the gradient of K(X, X) through the port's Function (plain K1 and K2)
    # against autodiff of the JAX classes' K(X) on their XLA path, which
    # differentiates sqrt(max(d2, 1e-36)) and so gives 0 where d2 = 0
    rng, X, ls = _coincident(13, 16, 3)
    g = rng.randn(16, 16)
    var, alpha = np.float64(1.4), np.float64(0.8)
    want = _jax_class_vjp_f64(family, X, X, ls, var, alpha, g, same=True)
    got = _port_grads(family, X, X, ls, var, alpha, g, same=True)
    for i in (0, 2, 3) + ((4,) if family == "rq" else ()):
        assert np.all(np.isfinite(got[i]))
        _check(got[i], want[i], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("family,same", [(f, False) for f in FAMILIES] + [(f, True) for f in KUU_FAMILIES])
def test_function_gradcheck_f64(family, same):
    rng, X, Z = _apart(8, 6, 5, 2, np.float64)
    leaves = [torch.tensor(v, dtype=torch.float64, requires_grad=True)
              for v in (X, Z, np.array([0.7, 1.3]), 1.2, 0.9)]

    def fn(X, Z, ls, var, alpha):
        return pd.stationary_kernel_matrix(X, X if same else Z, ls, var, family,
                                           alpha=alpha if family == "rq" else None)

    assert torch.autograd.gradcheck(fn, leaves)


@pytest.mark.parametrize("family", ["rbf", "matern52", "rq"])
def test_function_bf16_inputs_get_f32_gradients_cast_back(family):
    # the backward runs in float32 on the bfloat16 values and casts the input
    # gradients back: equal, after that cast, to float32 gradients taken from
    # the same rounded inputs
    rng, X, Z = _apart(10, 9, 7, 3)
    g = torch.from_numpy(rng.randn(9, 7).astype(np.float32))
    ls, var, alpha = torch.ones(3), torch.tensor(1.2), torch.tensor(0.8)
    grads = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.from_numpy(X).to(torch.bfloat16).to(dtype).requires_grad_()
        z = torch.from_numpy(Z).to(torch.bfloat16).to(dtype).requires_grad_()
        K = pd.stationary_kernel_matrix(x, z, ls, var, family, alpha=alpha if family == "rq" else None)
        assert K.dtype == torch.float32
        K.backward(g)
        grads[dtype] = (x.grad, z.grad)
    for got, want in zip(grads[torch.bfloat16], grads[torch.float32]):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.float().numpy(), want.to(torch.bfloat16).float().numpy())


def test_kernel_classes_route_their_family_and_alpha():
    from gpflow_tpu_torch.kernels.stationaries import _PALLAS_EXACT_TYPES

    assert {cls.__name__: f for cls, f in _PALLAS_EXACT_TYPES.items()} == {
        cls.__name__: f for f, cls in JAX_CLASSES.items()
    }


def test_k2_launch_counter_stays_zero_on_cpu():
    rng = np.random.RandomState(9)
    model = SVGP(
        kernel=kernels.Matern52(lengthscales=np.ones(2)),
        likelihood=likelihoods.Gaussian(0.1),
        inducing_variable=rng.rand(16, 2),
        num_data=100,
    ).to(torch.float32)
    X = torch.from_numpy(rng.rand(24, 2).astype(np.float32))
    Y = torch.from_numpy(rng.randn(24, 1).astype(np.float32))
    model.training_loss((X, Y)).backward()
    assert model.kernel.variance.unconstrained.grad is not None
    assert pd.launch_counts == {"K1": 0, "K2": 0}


def test_k2_cuda_wrapper_raises_on_cpu_tensors_and_other_families():
    X, g = torch.zeros(4, 2), torch.zeros(4, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        pd.stationary_wgrad_cuda("matern52", X, X, torch.tensor([1.0]), g)
    for family in ("rbf", "rq", "cosine"):
        with pytest.raises(ValueError, match="K2 serves the families"):
            pd.stationary_wgrad_cuda(family, X, X, torch.tensor([1.0]), g)
    assert pd.launch_counts["K2"] == 0


@pytest.mark.parametrize("N,M,D", K2_SHAPES + EDGE_SHAPES)
def test_k2_launch_plan_covers_every_shape(N, M, D):
    def plan(g_ptr=512, out_ptr=256):
        return pd._launch_plan("K2", N, M, D, out_ptr, g_ptr, SMS, _resident, 1024, 2048, 4)

    aligned = plan()
    check_plan_covers(aligned, N, M)
    assert aligned.tma == (M % 4 == 0) and aligned.vec == (D % 4 == 0)
    # g as a contiguous view 4 bytes into its storage (chip_smoke.offset_view),
    # or a W off alignment: the edge path, with the same tiles
    for off in (plan(g_ptr=516), plan(out_ptr=260)):
        assert not off.tma and off.tile_rows == aligned.tile_rows and off.grid <= aligned.tiles
        check_plan_covers(off, N, M)


def test_k2_offset_g_shape_is_a_tma_shape_when_aligned():
    # the offset-g check on the card exercises the edge path at a shape that
    # would otherwise take the TMA path
    N, M, D = K2_OFFSET_G_SHAPE
    assert pd._launch_plan("K2", N, M, D, 256, 512, SMS, _resident, 1024, 2048, 4).tma
