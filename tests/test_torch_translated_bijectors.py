"""The JAX package's ``tests/gpflow_tpu/utilities/test_bijectors.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Bijector correctness (pattern from reference
``tests/gpflow/utilities/test_bijectors.py``, extended to the whole
in-house set): forward/inverse round-trips, log-det-Jacobians vs autodiff,
positive() lower-bound behavior, triangular packing.
"""
import numpy as np
import pytest

from gpflow_tpu_torch import bijectors as bj
from gpflow_tpu_torch.utilities.bijectors import positive, triangular, triangular_size
from .test_torch_translated_support import asarray, grad, translated_test_environment  # noqa: F401

rng = np.random.RandomState(13)

SCALAR_BIJECTORS = [
    ("Identity", bj.Identity()),
    ("Exp", bj.Exp()),
    ("Softplus", bj.Softplus()),
    ("Shift", bj.Shift(1.5)),
    ("Sigmoid", bj.Sigmoid()),
    ("Chain", bj.Chain([bj.Shift(0.5), bj.Softplus()])),
    ("positive", positive()),
    ("positive_lower", positive(lower=1e-3)),
    ("positive_exp", positive(base="exp")),
]
IDS = [n for n, _ in SCALAR_BIJECTORS]
BIJ = [b for _, b in SCALAR_BIJECTORS]


@pytest.mark.parametrize("b", BIJ, ids=IDS)
def test_roundtrip(b):
    x = rng.randn(7) * 1.5
    y = np.asarray(b.forward(asarray(x)))
    x_back = np.asarray(b.inverse(asarray(y)))
    np.testing.assert_allclose(x_back, x, atol=1e-7)


@pytest.mark.parametrize("b", BIJ, ids=IDS)
def test_forward_log_det_jacobian_vs_autodiff(b):
    xs = rng.randn(5) * 1.2
    for x in xs:
        fldj = float(b.forward_log_det_jacobian(asarray(x)))
        deriv = float(grad(lambda t: b.forward(t))(asarray(x)))
        np.testing.assert_allclose(fldj, np.log(abs(deriv)), atol=1e-6)


def test_positive_lower_bound():
    b = positive(lower=0.1)
    y = np.asarray(b.forward(asarray(np.linspace(-20, 5, 50))))
    assert (y > 0.1 - 1e-12).all()
    # inverse of values at the bound stays finite
    x = np.asarray(b.inverse(asarray(np.array([0.1 + 1e-6, 1.0, 10.0]))))
    assert np.isfinite(x).all()


def test_triangular_size():
    for n in (1, 2, 5, 10):
        assert triangular_size(n) == n * (n + 1) // 2


def test_triangular_mask_roundtrip():
    # triangular() is the TPU-native TriangularMask: full-matrix storage,
    # forward = one tril mask (see bijectors.TriangularMask docstring)
    n = 4
    b = triangular()
    A = asarray(rng.randn(n, n))
    L = np.asarray(b.forward(A))
    assert np.allclose(L, np.tril(L))
    np.testing.assert_allclose(np.asarray(b.inverse(asarray(L))), L, atol=1e-12)


def test_fill_triangular_roundtrip():
    n = 4
    b = bj.FillTriangular()
    flat = asarray(rng.randn(triangular_size(n)))
    L = np.asarray(b.forward(flat))
    assert L.shape == (n, n)
    assert np.allclose(L, np.tril(L))
    flat_back = np.asarray(b.inverse(asarray(L)))
    np.testing.assert_allclose(flat_back, np.asarray(flat), atol=1e-10)


def test_exp_matches_log():
    b = bj.Exp()
    y = asarray([0.5, 1.0, 3.0])
    np.testing.assert_allclose(np.asarray(b.inverse(y)), np.log(np.asarray(y)), atol=1e-12)


def test_chain_order():
    """Chain([a, b]).forward = a(b(x)) — outermost first, as in TFP."""
    chain = bj.Chain([bj.Shift(2.0), bj.Exp()])
    x = asarray(0.3)
    np.testing.assert_allclose(float(chain.forward(x)), np.exp(0.3) + 2.0, atol=1e-10)
