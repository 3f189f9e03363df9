"""The JAX package's ``tests/gpflow_tpu/utilities/test_misc_utils.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; ``parameters`` is the port's ``all_parameters`` (ROADMAP Queue 3).

Utility-layer tests (patterns from reference
``tests/gpflow/utilities/test_misc.py``, ``test_set_trainable.py``,
``test_training_loop.py``, ``test_parameter_or_function.py``,
``test_model_utils.py``, ``test_multipledispatch.py``, ``test_ops.py``).
"""
import numpy as np
import pytest
import torch

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch import kernels, likelihoods
from gpflow_tpu_torch.config import default_float, default_int
from gpflow_tpu_torch.utilities import (
    Dispatcher,
    add_likelihood_noise_cov,
    add_noise_cov,
    assert_params_false,
    broadcasting_elementwise,
    difference_matrix,
    evaluate_parameter_or_function,
    is_variable,
    leading_transpose,
    pca_reduce,
    prepare_parameter_or_function,
    set_trainable,
    square_distance,
    to_default_float,
    to_default_int,
    training_loop,
)
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(6)


def test_to_default_dtypes():
    assert to_default_float(np.int32(3)).dtype == default_float()
    assert to_default_int(np.float64(3.7)).dtype == default_int()


def test_set_trainable_module_and_iterable():
    k1, k2 = kernels.SquaredExponential(), kernels.Matern32()
    set_trainable(k1, False)
    assert all(not p.trainable for p in k1.all_parameters)
    set_trainable([k1, k2], True)
    assert all(p.trainable for p in list(k1.all_parameters) + list(k2.all_parameters))
    set_trainable(k1.variance, False)
    assert not k1.variance.trainable and k1.lengthscales.trainable


def test_is_variable():
    assert is_variable(gpf.Parameter(1.0))
    assert not is_variable(np.ones(3))


def test_training_loop_reduces_loss():
    X = np.linspace(0, 4, 30)[:, None]
    Y = np.sin(X) + 0.05 * rng.randn(30, 1)
    m = gpf.models.GPR((X, Y), kernel=kernels.SquaredExponential(), noise_variance=0.5)
    before = float(m.training_loss())
    training_loop(m.training_loss, var_list=m.trainable_variables, maxiter=40, learning_rate=0.05)
    assert float(m.training_loss()) < before


def test_parameter_or_function_constant():
    p = prepare_parameter_or_function(0.7, lower_bound=1e-6)
    assert isinstance(p, gpf.Parameter)
    v = evaluate_parameter_or_function(p, np.zeros((4, 2)))
    np.testing.assert_allclose(float(np.asarray(v).ravel()[0]), 0.7, rtol=1e-6)


def test_parameter_or_function_function():
    from gpflow_tpu_torch.functions import Linear

    f = prepare_parameter_or_function(Linear(A=np.ones((2, 1))), lower_bound=None)
    X = rng.rand(4, 2)
    v = np.asarray(evaluate_parameter_or_function(f, X))
    np.testing.assert_allclose(v, X.sum(-1, keepdims=True), atol=1e-9)


def test_add_noise_cov():
    K = rng.randn(5, 5)
    K = K @ K.T
    out = np.asarray(add_noise_cov(asarray(K), asarray(0.3)))
    np.testing.assert_allclose(out, K + 0.3 * np.eye(5), atol=1e-9)


def test_add_likelihood_noise_cov_input_dependent():
    from gpflow_tpu_torch.functions import Linear

    lik = likelihoods.Gaussian(variance=Linear(A=np.ones((1, 1)), b=np.ones(1)))
    X = np.abs(rng.rand(5, 1))
    K = np.eye(5)
    out = np.asarray(add_likelihood_noise_cov(asarray(K), lik, asarray(X)))
    np.testing.assert_allclose(out, K + np.diag((X + 1.0).ravel()), atol=1e-7)


def test_assert_params_false():
    def fn():
        pass

    assert_params_false(fn, a=False, b=False)  # fine
    with pytest.raises(NotImplementedError):
        assert_params_false(fn, a=True, b=False)


def test_dispatcher_mro_resolution():
    d = Dispatcher("demo")

    class A:
        pass

    class B(A):
        pass

    @d.register(A)
    def handle_a(x):
        return "A"

    assert d(B()) == "A"  # resolves through the MRO

    @d.register(B)
    def handle_b(x):
        return "B"

    assert d(B()) == "B"  # exact match wins
    assert d(A()) == "A"

    with pytest.raises(NotImplementedError):
        d(3.14)


def test_square_distance_and_difference_matrix():
    X, X2 = rng.randn(6, 3), rng.randn(4, 3)
    d2 = np.asarray(square_distance(asarray(X), asarray(X2)))
    expected = ((X[:, None, :] - X2[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d2, expected, atol=1e-9)
    # one-argument form: symmetric, with (near-)zero diagonal
    d2_self = np.asarray(square_distance(asarray(X), None))
    np.testing.assert_allclose(d2_self, d2_self.T, atol=0)  # exactly symmetric
    np.testing.assert_allclose(np.diag(d2_self), 0.0, atol=1e-12)

    diff = np.asarray(difference_matrix(asarray(X), asarray(X2)))
    np.testing.assert_allclose(diff, X[:, None, :] - X2[None, :, :], atol=1e-12)


def test_leading_transpose():
    A = rng.randn(2, 3, 4, 5)
    out = np.asarray(leading_transpose(asarray(A), perm=[..., -1, -2]))
    assert out.shape == (2, 3, 5, 4)


def test_broadcasting_elementwise():
    a, b = np.array([1.0, 2.0]), np.array([10.0, 20.0, 30.0])
    out = np.asarray(broadcasting_elementwise(torch.add, asarray(a), asarray(b)))
    np.testing.assert_allclose(out, a[:, None] + b[None, :], atol=1e-12)


def test_pca_reduce():
    X = rng.randn(30, 5) @ np.diag([5.0, 3.0, 1.0, 0.1, 0.05])
    Xr = np.asarray(pca_reduce(asarray(X), 2))
    assert Xr.shape == (30, 2)
    # the retained components carry most of the variance
    assert Xr.var(0).sum() > 0.8 * X.var(0).sum()


def test_add_likelihood_noise_cov_batched():
    """Batched K [B, N, N] / X [B, N, D] must add per-batch diagonals like
    the reference's set_diag form (a flat reshape raised a
    broadcast error)."""
    from gpflow_tpu_torch import likelihoods
    from gpflow_tpu_torch.utilities import add_likelihood_noise_cov

    rngb = np.random.RandomState(0)
    B, N, D = 3, 5, 2
    K = np.stack([np.eye(N) for _ in range(B)])
    X = rngb.randn(B, N, D)
    lik = likelihoods.Gaussian(0.25)
    out = np.asarray(add_likelihood_noise_cov(asarray(K), lik, asarray(X)))
    assert out.shape == (B, N, N)
    np.testing.assert_allclose(out, K + 0.25 * np.eye(N)[None], rtol=1e-12)
    # unbatched path unchanged
    out2 = np.asarray(add_likelihood_noise_cov(asarray(K[0]), lik, asarray(X[0])))
    np.testing.assert_allclose(out2, K[0] + 0.25 * np.eye(N), rtol=1e-12)


def test_dispatcher_mixed_arity():
    """2-type and 3-type registrations must coexist (the
    first-registered arity masked the others)."""
    from gpflow_tpu_torch.utilities import Dispatcher

    d = Dispatcher("mixed")

    @d.register(int, int)
    def _two(a, b):
        return "two"

    @d.register(int, int, str)
    def _three(a, b, c):
        return "three"

    assert d(1, 2) == "two"
    assert d(1, 2, "x") == "three"
    # longest-arity preference when both match
    assert d(1, 2, "x") == "three"


def test_checkshapes_env_false_spellings():
    """GPFLOW_TPU_CHECK_SHAPES=False must DISABLE shape checking (same falsy
    spellings as GPFLOW_TPU_PALLAS)."""
    from gpflow_tpu_torch.utilities.shapes import _env_enabled

    for spelling in ("False", "FALSE", "no", "off", "Off", "0", ""):
        assert _env_enabled(spelling) is False, spelling
    for spelling in ("1", "true", "True", "yes", "on"):
        assert _env_enabled(spelling) is True, spelling
