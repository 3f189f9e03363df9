"""The JAX package's ``tests/gpflow_tpu/kernels/test_kernels.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Kernel correctness tests vs NumPy loop oracles + structural properties
(pattern from reference ``tests/gpflow/kernels/test_kernels.py``).
"""
import numpy as np
import pytest
import torch

import gpflow_tpu_torch
from gpflow_tpu_torch import kernels

from .gpflow_tpu.kernels.reference import (
    ref_arccosine_kernel,
    ref_linear,
    ref_matern12,
    ref_matern32,
    ref_matern52,
    ref_periodic_kernel,
    ref_rbf_kernel,
)
from . import test_torch_translated_support as support
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(0)


def _data(N=7, D=3):
    return rng.randn(N, D)


@pytest.mark.parametrize(
    "kernel_cls,oracle",
    [
        (kernels.SquaredExponential, ref_rbf_kernel),
        (kernels.Matern12, ref_matern12),
        (kernels.Matern32, ref_matern32),
        (kernels.Matern52, ref_matern52),
    ],
)
@pytest.mark.parametrize("ard", [False, True])
def test_stationary_vs_oracle(kernel_cls, oracle, ard):
    X = _data()
    lengthscales = np.array([0.9, 1.3, 0.4]) if ard else 0.7
    variance = 1.7
    k = kernel_cls(variance=variance, lengthscales=lengthscales)
    K = np.asarray(k(X))
    K_ref = oracle(X, lengthscales, variance)
    np.testing.assert_allclose(K, K_ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(k(X, full_cov=False)), np.diag(K_ref), rtol=1e-8)
    # cross covariance
    X2 = _data(5)
    K12 = np.asarray(k(X, X2))
    assert K12.shape == (7, 5)


def test_rbf_psd_and_symmetric():
    X = _data(20, 2)
    k = kernels.SquaredExponential()
    K = np.asarray(k(X))
    np.testing.assert_allclose(K, K.T, atol=1e-12)
    evals = np.linalg.eigvalsh(K + 1e-10 * np.eye(20))
    assert (evals > 0).all()


def test_linear_and_polynomial():
    X = _data()
    variance = np.array([0.5, 1.5, 2.0])
    k = kernels.Linear(variance=variance)
    np.testing.assert_allclose(np.asarray(k(X)), ref_linear(X, variance), rtol=1e-10)
    kp = kernels.Polynomial(degree=2.0, variance=1.0, offset=0.5)
    expected = (X @ X.T + 0.5) ** 2.0
    np.testing.assert_allclose(np.asarray(kp(X)), expected, rtol=1e-10)
    np.testing.assert_allclose(
        np.asarray(kp(X, full_cov=False)), np.diag(expected), rtol=1e-10
    )


def test_white_and_constant():
    X = _data()
    kw = kernels.White(variance=0.3)
    np.testing.assert_allclose(np.asarray(kw(X)), 0.3 * np.eye(7), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(kw(X, _data(4))), np.zeros((7, 4)))
    kc = kernels.Constant(variance=0.5)
    np.testing.assert_allclose(np.asarray(kc(X)), 0.5 * np.ones((7, 7)), rtol=1e-12)
    assert kernels.Bias is kernels.Constant


@pytest.mark.parametrize("base", ["rbf", "matern12"])
def test_periodic(base):
    X = _data(6, 2)
    base_kernel = (
        kernels.SquaredExponential(variance=1.3, lengthscales=0.8)
        if base == "rbf"
        else kernels.Matern12(variance=1.3, lengthscales=0.8)
    )
    k = kernels.Periodic(base_kernel, period=1.7)
    K = np.asarray(k(X))
    K_ref = ref_periodic_kernel(X, base, 0.8, 1.3, 1.7)
    np.testing.assert_allclose(K, K_ref, rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_arccosine(order):
    X = _data(6, 3)
    wv = np.array([0.7, 1.1, 0.9])
    k = kernels.ArcCosine(order=order, variance=1.4, weight_variances=wv, bias_variance=0.6)
    K = np.asarray(k(X))
    K_ref = ref_arccosine_kernel(X, order, wv, 0.6, 1.4)
    np.testing.assert_allclose(K, K_ref, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(k(X, full_cov=False)), np.diag(K_ref), rtol=1e-6)


@pytest.mark.parametrize("order", [0, 1, 2])
def test_arccosine_duplicate_points_finite(order):
    # cos(theta) lands exactly on 1 for identical rows (and can exceed 1
    # through rounding on TPU); K and its gradients must stay finite.

    X = np.array([[1.0, 2.0], [1.0, 2.0], [0.5, -0.3]])
    k = kernels.ArcCosine(order=order)
    K = np.asarray(k(X))
    assert np.isfinite(K).all()
    np.testing.assert_allclose(K, K.T, atol=1e-12)

    def loss(wv):
        kk = kernels.ArcCosine(order=order, weight_variances=wv)
        return torch.sum(kk.K(asarray(X)))

    g = support.grad(loss)(1.0)
    assert np.isfinite(g)


def test_rational_quadratic_limits():
    X = _data()
    k_rq = kernels.RationalQuadratic(alpha=1e8)
    k_rbf = kernels.SquaredExponential()
    np.testing.assert_allclose(np.asarray(k_rq(X)), np.asarray(k_rbf(X)), rtol=1e-5)


def test_sum_product_combination():
    X = _data()
    k1 = kernels.SquaredExponential()
    k2 = kernels.Linear()
    k3 = kernels.Constant()
    ks = k1 + k2
    kp = k1 * k2
    np.testing.assert_allclose(
        np.asarray(ks(X)), np.asarray(k1(X)) + np.asarray(k2(X)), rtol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(kp(X)), np.asarray(k1(X)) * np.asarray(k2(X)), rtol=1e-10
    )
    # nested same-type combos flatten
    ks2 = ks + k3
    assert len(ks2.kernels) == 3


def test_active_dims_slice_and_indices():
    X = _data(5, 4)
    k_full = kernels.SquaredExponential()
    k_slice = kernels.SquaredExponential(active_dims=slice(0, 2))
    k_idx = kernels.SquaredExponential(active_dims=[0, 1])
    np.testing.assert_allclose(np.asarray(k_slice(X)), np.asarray(k_full(X[:, :2])), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(k_idx(X)), np.asarray(k_slice(X)), rtol=1e-12)
    k_13 = kernels.SquaredExponential(active_dims=[1, 3])
    np.testing.assert_allclose(np.asarray(k_13(X)), np.asarray(k_full(X[:, [1, 3]])), rtol=1e-10)


def test_active_dims_ard_mismatch_raises():
    with pytest.raises(ValueError):
        kernels.SquaredExponential(lengthscales=[1.0, 1.0], active_dims=[0, 1, 2])


def test_on_separate_dims():
    k1 = kernels.SquaredExponential(active_dims=[0])
    k2 = kernels.SquaredExponential(active_dims=[1])
    k3 = kernels.SquaredExponential(active_dims=[0, 1])
    assert k1.on_separate_dims(k2)
    assert not k1.on_separate_dims(k3)
    assert not k1.on_separate_dims(kernels.SquaredExponential())


def test_coregion():
    k = kernels.Coregion(output_dim=3, rank=2)
    W = rng.randn(3, 2)
    kappa = np.abs(rng.randn(3)) + 0.5
    k.W.assign(W)
    k.kappa.assign(kappa)
    B = W @ W.T + np.diag(kappa)
    X = rng.randint(0, 3, (6, 1)).astype(float)
    K = np.asarray(k(X))
    idx = X[:, 0].astype(int)
    np.testing.assert_allclose(K, B[np.ix_(idx, idx)], rtol=1e-10)
    np.testing.assert_allclose(np.asarray(k(X, full_cov=False)), np.diag(B)[idx], rtol=1e-10)


def test_changepoints():
    k = kernels.ChangePoints(
        [kernels.Constant(variance=1.0), kernels.Constant(variance=4.0)],
        locations=[0.0],
        steepness=50.0,
    )
    X = np.array([[-10.0], [10.0]])
    K = np.asarray(k(X))
    np.testing.assert_allclose(K[0, 0], 1.0, atol=1e-5)
    np.testing.assert_allclose(K[1, 1], 4.0, atol=1e-4)
    Kdiag = np.asarray(k(X, full_cov=False))
    np.testing.assert_allclose(Kdiag, np.diag(K), rtol=1e-8)


def test_cosine():
    X = rng.randn(5, 1)
    k = kernels.Cosine(variance=1.2, lengthscales=0.7)
    K = np.asarray(k(X))
    d = (X - X.T) / 0.7
    np.testing.assert_allclose(K, 1.2 * np.cos(2 * np.pi * d), rtol=1e-8)


def test_convolutional():
    image_shape = [3, 3]
    patch_shape = [2, 2]
    base = kernels.SquaredExponential()
    k = kernels.Convolutional(base, image_shape, patch_shape)
    assert k.num_patches == 4
    X = rng.rand(2, 9)
    K = np.asarray(k(X))
    assert K.shape == (2, 2)
    np.testing.assert_allclose(K, K.T, atol=1e-10)
    Kdiag = np.asarray(k(X, full_cov=False))
    np.testing.assert_allclose(Kdiag, np.diag(K), rtol=1e-8)


def test_kernel_jit_compatible():
    X = _data()
    k = kernels.SquaredExponential() + kernels.Linear()
    def compute(kern, x):
        return kern(x)

    np.testing.assert_allclose(np.asarray(compute(k, X)), np.asarray(k(X)), rtol=1e-12)


def test_kernel_batched_inputs():
    X = rng.randn(4, 7, 2)
    k = kernels.SquaredExponential()
    K = np.asarray(k(X))
    assert K.shape == (4, 7, 7)
    for b in range(4):
        np.testing.assert_allclose(K[b], np.asarray(k(X[b])), rtol=1e-10)
    assert np.asarray(k(X, full_cov=False)).shape == (4, 7)


def test_changepoints_rejects_multidim_input():
    k = kernels.ChangePoints([kernels.Matern32(), kernels.Constant()], locations=[0.0], steepness=2.0)
    X2d = np.random.RandomState(0).randn(5, 2)
    with pytest.raises(ValueError, match="1-dimensional"):
        k(X2d)
    with pytest.raises(ValueError, match="1-dimensional"):
        k(X2d, full_cov=False)
    # 1-D stays fine
    assert np.asarray(k(X2d[:, :1])).shape == (5, 5)


@pytest.mark.parametrize("seed", range(15))
def test_kernel_random_hyperparameters_vs_numpy_oracle(seed):
    """Fuzz: random (family, shapes, ARD/scalar lengthscales, variance)
    configurations against the NumPy loop oracles — agreement must hold
    across the hyperparameter space, not just the structured grid points."""
    r = np.random.RandomState(6000 + seed)
    N = r.randint(2, 12)
    D = r.randint(1, 5)
    X = r.randn(N, D)
    variance = 0.3 + 2 * r.rand()
    ls = (0.4 + r.rand(D)) if r.randint(2) else (0.4 + r.rand())

    family = r.randint(4)
    if family == 0:
        k = kernels.SquaredExponential(variance=variance, lengthscales=ls)
        expected = ref_rbf_kernel(X, np.broadcast_to(ls, (D,)), variance)
    elif family == 1:
        k = kernels.Matern12(variance=variance, lengthscales=ls)
        expected = ref_matern12(X, np.broadcast_to(ls, (D,)), variance)
    elif family == 2:
        k = kernels.Matern32(variance=variance, lengthscales=ls)
        expected = ref_matern32(X, np.broadcast_to(ls, (D,)), variance)
    else:
        k = kernels.Matern52(variance=variance, lengthscales=ls)
        expected = ref_matern52(X, np.broadcast_to(ls, (D,)), variance)

    np.testing.assert_allclose(np.asarray(k(X)), expected, rtol=1e-7, atol=1e-11)
    np.testing.assert_allclose(
        np.asarray(k(X, full_cov=False)), np.diag(expected), rtol=1e-7, atol=1e-11
    )
