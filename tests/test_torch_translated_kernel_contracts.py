"""The JAX package's ``tests/gpflow_tpu/kernels/test_kernel_contracts.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Kernel API contracts and edge cases (pattern from reference
``tests/gpflow/kernels/test_kernels.py``): ard property semantics,
active_dims slicing equivalences, combination kernels, error paths,
and gradient finiteness at degenerate inputs.
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch import kernels
from . import test_torch_translated_support as support
from .test_torch_translated_support import X64, asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(42)
N, D = 6, 4
X = rng.randn(N, D)
X2 = rng.randn(N + 1, D)


# ---------------------------------------------------------------------------
# ard property (reference test_kernels.py:459-516)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kernel_class, param_name",
    [
        (kernels.SquaredExponential, "lengthscales"),
        (kernels.Linear, "variance"),
        (kernels.ArcCosine, "weight_variances"),
        (kernels.Cosine, "lengthscales"),
    ],
)
@pytest.mark.parametrize(
    "param_value, ard",
    [(1.0, False), ([1.0], True), ([1.0, 1.0], True)],
)
def test_ard_property(kernel_class, param_name, param_value, ard):
    kernel = kernel_class(**{param_name: param_value})
    assert kernel.ard is ard


@pytest.mark.parametrize("d", [4, 7])
def test_ard_init_scalar_broadcast_equals_array(d):
    """Scalar and length-D constant lengthscales give the same gram matrix
    (reference ``test_kernels.py:459-469``)."""
    k1 = kernels.SquaredExponential(lengthscales=2.3)
    k2 = kernels.SquaredExponential(lengthscales=np.ones(d) * 2.3)
    Xd = rng.randn(5, d)
    np.testing.assert_allclose(np.asarray(k1(Xd)), np.asarray(k2(Xd)), atol=1e-12)


def test_ard_invalid_active_dims_raises():
    with pytest.raises(ValueError):
        kernels.SquaredExponential(lengthscales=np.ones(2), active_dims=[1])


# ---------------------------------------------------------------------------
# active_dims slicing (reference test_kernels.py:396-456)
# ---------------------------------------------------------------------------

_SLICED_KERNEL_FACTORIES = [
    lambda dims: kernels.SquaredExponential(active_dims=dims),
    lambda dims: kernels.Linear(active_dims=dims),
    lambda dims: kernels.Matern32(active_dims=dims),
    lambda dims: kernels.ArcCosine(active_dims=dims),
]


@pytest.mark.parametrize("make_kernel", _SLICED_KERNEL_FACTORIES)
@pytest.mark.parametrize("dims", [[0], [1, 3], [0, 2, 3]])
def test_slice_symmetric_equals_manual(make_kernel, dims):
    """k(X) with active_dims == plain kernel on the pre-sliced columns
    (reference ``test_kernels.py:396-404``)."""
    k_sliced = make_kernel(dims)
    k_manual = make_kernel(None)
    np.testing.assert_allclose(
        np.asarray(k_sliced(X)), np.asarray(k_manual(X[:, dims])), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(k_sliced(X, full_cov=False)),
        np.asarray(k_manual(X[:, dims], full_cov=False)),
        atol=1e-12,
    )


@pytest.mark.parametrize("make_kernel", _SLICED_KERNEL_FACTORIES)
@pytest.mark.parametrize("dims", [[0], [1, 3]])
def test_slice_asymmetric_equals_manual(make_kernel, dims):
    k_sliced = make_kernel(dims)
    k_manual = make_kernel(None)
    np.testing.assert_allclose(
        np.asarray(k_sliced(X, X2)),
        np.asarray(k_manual(X[:, dims], X2[:, dims])),
        atol=1e-12,
    )


def test_active_dims_product_equals_full_ard(seed=3):
    """SqExp(all dims) == SqExp(dims minus i) * SqExp(dim i) with matched ARD
    lengthscales (reference ``test_kernels.py:433-456``)."""
    local = np.random.RandomState(seed)
    ls = local.rand(D) + 0.4
    i = 2
    rest = [d for d in range(D) if d != i]
    k_all = kernels.SquaredExponential(lengthscales=ls, active_dims=list(range(D)))
    k_rest = kernels.SquaredExponential(lengthscales=ls[rest], active_dims=rest)
    k_one = kernels.SquaredExponential(lengthscales=ls[i], active_dims=[i])
    k_prod = k_rest * k_one
    np.testing.assert_allclose(np.asarray(k_all(X)), np.asarray(k_prod(X)), atol=1e-10)


# ---------------------------------------------------------------------------
# Combinations (reference test_kernels.py:349-363, 659-674)
# ---------------------------------------------------------------------------


def test_add_symmetric_and_asymmetric():
    k1 = kernels.SquaredExponential(lengthscales=0.8)
    k2 = kernels.Linear(variance=0.3)
    ksum = k1 + k2
    np.testing.assert_allclose(
        np.asarray(ksum(X)), np.asarray(k1(X)) + np.asarray(k2(X)), atol=1e-12
    )
    np.testing.assert_allclose(
        np.asarray(ksum(X, X2)), np.asarray(k1(X, X2)) + np.asarray(k2(X, X2)),
        atol=1e-12,
    )


def test_white_asymmetric_is_zero():
    """White has zero cross-covariance (reference ``test_kernels.py:365-372``)."""
    w = kernels.White(variance=1.7)
    np.testing.assert_array_equal(np.asarray(w(X, X2)), np.zeros((N, N + 1)))
    np.testing.assert_allclose(np.asarray(w(X)), 1.7 * np.eye(N), atol=1e-12)


def test_combination_of_linear_coregionalization_kernels():
    """Sum of two LCM kernels with different latent counts produces the
    [N, P, N, P] sum of the parts (reference ``test_kernels.py:659-674``)."""
    P = 2
    k1 = kernels.LinearCoregionalization(
        [kernels.Linear(active_dims=[1]), kernels.SquaredExponential()],
        W=rng.randn(P, 2),
    )
    k2 = kernels.LinearCoregionalization(
        [kernels.SquaredExponential(), kernels.Linear(), kernels.Linear()],
        W=rng.randn(P, 3),
    )
    ksum = k1 + k2
    K = np.asarray(ksum(X, full_cov=True))
    assert K.shape == (N, P, N, P)
    np.testing.assert_allclose(
        K,
        np.asarray(k1(X, full_cov=True)) + np.asarray(k2(X, full_cov=True)),
        atol=1e-10,
    )


def test_latent_kernels_property():
    """latent_kernels of the multioutput wrappers (reference
    ``test_kernels.py:646-656``)."""
    kernel_list = (
        kernels.SquaredExponential(),
        kernels.White(),
        kernels.White() + kernels.Linear(),
    )
    assert len(kernels.SharedIndependent(kernels.SquaredExponential(), 3).latent_kernels) == 1
    assert kernels.SeparateIndependent(kernel_list).latent_kernels == tuple(kernel_list)
    assert (
        kernels.LinearCoregionalization(kernel_list, rng.random((5, 3))).latent_kernels
        == tuple(kernel_list)
    )


# ---------------------------------------------------------------------------
# Error paths (reference test_kernels.py:518-545, 621-626, 234-245)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "make_kernel",
    [
        lambda: kernels.SquaredExponential(),
        lambda: kernels.Linear(),
        lambda: kernels.White(),
        lambda: kernels.Periodic(kernels.SquaredExponential()),
        lambda: kernels.SquaredExponential() + kernels.Linear(),
    ],
)
def test_kernel_call_diag_with_x2_raises(make_kernel):
    with pytest.raises(ValueError):
        make_kernel()(X, X2[:N], full_cov=False)


def test_changepoints_init_failures():
    ks = [kernels.Matern12(), kernels.Linear(), kernels.Matern32()]
    with pytest.raises(ValueError, match="one more than"):
        kernels.ChangePoints(ks, [1.0], steepness=1.0)
    with pytest.raises(ValueError, match="steepness"):
        kernels.ChangePoints(ks, [1.0, 2.0], steepness=[1.0])


def test_periodic_requires_isotropic_stationary_base():
    with pytest.raises(TypeError):
        kernels.Periodic(kernels.Linear())


def test_periodic_active_dims_follows_base():
    """Periodic delegates active_dims to its base kernel (reference
    ``test_kernels.py:629-643``)."""
    base = kernels.SquaredExponential(active_dims=[1])
    kernel = kernels.Periodic(base_kernel=base)
    assert tuple(kernel.active_dims) == tuple(base.active_dims)
    base.active_dims = [3]
    assert tuple(kernel.active_dims) == (3,)


def test_periodic_diag_matches_base_variance():
    """Periodic K_diag equals the base stationary's constant diagonal
    (reference ``test_kernels.py:226-231``)."""
    for base in (kernels.SquaredExponential(variance=1.3), kernels.Matern32(variance=0.7)):
        k = kernels.Periodic(base)
        np.testing.assert_allclose(
            np.asarray(k(X, full_cov=False)),
            np.asarray(base(X, full_cov=False)),
            atol=1e-12,
        )


# ---------------------------------------------------------------------------
# Gradient finiteness at degenerate inputs (reference test_kernels.py:164-196)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("order", [0, 1, 2])
def test_arccosine_gradient_finite_at_duplicate_points(order):
    """ArcCosine's acos saturates at +-1 for identical rows; the gradient
    must stay finite (reference ``test_kernels.py:164-196``)."""
    Xd = np.tile(rng.randn(1, 2), (3, 1))

    def objective(weight_variances):
        k = kernels.ArcCosine(order=order, weight_variances=weight_variances)
        return torch.sum(k(Xd))

    grad = support.grad(objective)(torch.ones(2, **X64))
    assert np.isfinite(np.asarray(grad)).all()


@pytest.mark.parametrize(
    "make_kernel",
    [
        lambda: kernels.SquaredExponential(),
        lambda: kernels.Matern12(),
        lambda: kernels.Matern52(),
        lambda: kernels.RationalQuadratic(),
    ],
)
def test_stationary_gradient_finite_at_duplicate_points(make_kernel):
    """r=0 is the classic sqrt-gradient NaN trap; the clipped-r2 formulation
    must keep lengthscale gradients finite."""
    Xd = np.tile(rng.randn(1, 3), (4, 1))

    def objective(ls):
        k = make_kernel()
        k.lengthscales.assign(ls)
        return torch.sum(k(Xd))

    grad = support.grad(objective)(asarray(1.3))
    assert np.isfinite(np.asarray(grad)).all()


# ---------------------------------------------------------------------------
# Coregion grid (reference test_kernels.py:269-319)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("output_dim, rank", [(3, 1), (4, 2), (5, 5)])
def test_coregion_shapes_diag_and_B(output_dim, rank):
    k = kernels.Coregion(output_dim=output_dim, rank=rank)
    k.W.assign(rng.randn(output_dim, rank))
    k.kappa.assign(rng.rand(output_dim) + 0.1)
    idx = rng.randint(0, output_dim, size=(7, 1)).astype(float)
    idx2 = rng.randint(0, output_dim, size=(5, 1)).astype(float)

    B = np.asarray(k.W.value) @ np.asarray(k.W.value).T + np.diag(np.asarray(k.kappa.value))
    K_full = np.asarray(k(idx))
    assert K_full.shape == (7, 7)
    for i in range(7):
        for j in range(7):
            np.testing.assert_allclose(
                K_full[i, j], B[int(idx[i, 0]), int(idx[j, 0])], atol=1e-12
            )

    K_cross = np.asarray(k(idx, idx2))
    assert K_cross.shape == (7, 5)

    K_diag = np.asarray(k(idx, full_cov=False))
    np.testing.assert_allclose(K_diag, np.diag(K_full), atol=1e-12)


def test_coregion_slice_active_dims_product():
    """Coregion x SquaredExponential on separate active dims: the Product
    kernel slices each factor internally (reference
    ``test_kernels.py:295-306``)."""
    output_dim, rank = 3, 2
    k1 = kernels.Coregion(output_dim=output_dim, rank=rank, active_dims=[0])
    k1.W.assign(rng.randn(output_dim, rank))
    k1.kappa.assign(rng.rand(output_dim) + 0.1)
    k2 = kernels.SquaredExponential(active_dims=[1])
    Xc = np.hstack(
        [rng.randint(0, output_dim, size=(8, 1)).astype(float), rng.randn(8, 1)]
    )
    K_prod = np.asarray((k1 * k2)(Xc))
    # slicing happens inside each kernel when given the full input
    K_manual = np.asarray(k1(Xc)) * np.asarray(k2(Xc))
    np.testing.assert_allclose(K_prod, K_manual, atol=1e-12)


# ---------------------------------------------------------------------------
# Convolutional diag (reference test_kernels.py:329-346)
# ---------------------------------------------------------------------------


def test_convolutional_diag_matches_full_cov_diagonal():
    image_shape, patch_shape = [4, 4], [2, 2]
    k = kernels.Convolutional(
        kernels.SquaredExponential(), image_shape=image_shape, patch_shape=patch_shape
    )
    Ximg = rng.rand(5, np.prod(image_shape))
    K_full = np.asarray(k(Ximg))
    K_diag = np.asarray(k(Ximg, full_cov=False))
    np.testing.assert_allclose(np.diag(K_full), K_diag, atol=1e-10)


@pytest.mark.parametrize(
    "make_kernel",
    [
        lambda: kernels.Matern12(),
        lambda: kernels.Matern32(),
        lambda: kernels.Matern52(),
        lambda: kernels.Exponential(),
        lambda: kernels.Cosine(),
    ],
    ids=["matern12", "matern32", "matern52", "exponential", "cosine"],
)
def test_scaled_euclid_dist_high_dim_value_and_input_gradient(make_kernel):
    """High-dimensional inputs generate tiny scaled distances whose naive
    ||x||^2 + ||y||^2 - 2 x.y evaluation goes NEGATIVE by cancellation; both
    the kernel matrix and its gradient WITH RESPECT TO THE INPUTS must stay
    finite (reference ``tests/gpflow/kernels/test_scaled_euclid_dist.py``)."""
    rng_hd = np.random.RandomState(0)
    Xhd = rng_hd.rand(100, 100) * 100

    kernel = make_kernel()
    K = np.asarray(kernel(Xhd))
    assert np.isfinite(K).all(), f"non-finite K for {type(kernel).__name__}"

    dK = support.grad(lambda x: torch.sum(make_kernel()(x, x)))(asarray(Xhd))
    assert np.isfinite(np.asarray(dK)).all(), (
        f"non-finite input-gradient for {type(kernel).__name__}"
    )


# ---------------------------------------------------------------------------
# runtime shape contracts on the kernel surface (VERDICT r2 #3: layer-3
# @check_shapes coverage; reference kernels/base.py:170-214)
# ---------------------------------------------------------------------------


def test_rank_wrong_kernel_input_raises():
    from gpflow_tpu_torch.utilities.shapes import ShapeError, set_enable_check_shapes

    k = kernels.SquaredExponential()
    set_enable_check_shapes(True)
    try:
        with pytest.raises(ShapeError):
            k(np.ones(5))  # rank-1: missing the feature axis
        with pytest.raises(ShapeError):
            k.K(np.ones((5,)))
        with pytest.raises(ShapeError):
            k.K_diag(np.ones(5))
        # mismatched feature dims between X and X2
        with pytest.raises(ShapeError):
            k(np.ones((5, 3)), np.ones((4, 2)))
        # valid calls still fine, incl. batched
        assert k(np.ones((5, 3))).shape == (5, 5)
        assert k(np.ones((2, 5, 3)), np.ones((4, 3))).shape == (2, 5, 4)
    finally:
        set_enable_check_shapes(False)


def test_rank_wrong_multioutput_kernel_raises():
    from gpflow_tpu_torch.utilities.shapes import ShapeError, set_enable_check_shapes

    k = kernels.SharedIndependent(kernels.SquaredExponential(), output_dim=2)
    set_enable_check_shapes(True)
    try:
        with pytest.raises(ShapeError):
            k(np.ones(5))
        assert k(np.ones((5, 3)), full_cov=False, full_output_cov=False).shape == (5, 2)
        assert k(np.ones((5, 3)), full_cov=True, full_output_cov=True).shape == (5, 2, 5, 2)
    finally:
        set_enable_check_shapes(False)


def test_mean_function_and_likelihood_contracts_fire():
    from gpflow_tpu_torch import likelihoods
    from gpflow_tpu_torch.functions import Linear as LinearMean
    from gpflow_tpu_torch.utilities.shapes import ShapeError, set_enable_check_shapes

    set_enable_check_shapes(True)
    try:
        mf = LinearMean(A=np.ones((3, 1)))
        assert mf(np.ones((7, 3))).shape == (7, 1)
        with pytest.raises(ShapeError):
            mf(np.ones(7))  # rank-1 input

        lik = likelihoods.Gaussian(0.1)
        F = np.zeros((7, 1))
        assert lik.variational_expectations(None, F, F + 0.1, F).shape == (7,)
        with pytest.raises(ShapeError):
            # Fvar rank mismatch vs Fmu
            lik.variational_expectations(None, F, np.ones(7), F)
    finally:
        set_enable_check_shapes(False)
