"""The JAX package's ``tests/gpflow_tpu/utilities/test_shapes.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Tests for the lightweight shape-contract utility.
"""
import numpy as np
import pytest
import torch

from gpflow_tpu_torch.utilities.shapes import (
    ShapeError,
    check_shape,
    check_shapes,
    get_enable_check_shapes,
    set_enable_check_shapes,
)
from .test_torch_translated_support import X64, translated_test_environment  # noqa: F401


@pytest.fixture(autouse=True)
def _enable():
    # restore the PRIOR state: the suite-wide conftest turns contracts on,
    # and hard-setting False here would silently disable them for every
    # test collected after this file
    prev = get_enable_check_shapes()
    set_enable_check_shapes(True)
    yield
    set_enable_check_shapes(prev)


@check_shapes(
    "X: [batch..., N, D]",
    "X2: [batch2..., N2, D]",
    "return: [batch..., N, batch2..., N2]",
)
def cross(X, X2=None):
    if X2 is None:
        X2 = X
    return torch.tensordot(X, X2, dims=([-1], [-1]))


def test_accepts_valid_shapes():
    X = torch.ones((5, 3), **X64)
    X2 = torch.ones((4, 3), **X64)
    assert cross(X, X2).shape == (5, 4)
    # batched
    Xb = torch.ones((2, 5, 3), **X64)
    assert cross(Xb, X2).shape == (2, 5, 4)
    # None argument is skipped
    assert cross(X).shape == (5, 5)


def test_rejects_inconsistent_dims():
    X = torch.ones((5, 3), **X64)
    X2 = torch.ones((4, 2), **X64)  # D mismatch
    with pytest.raises(ShapeError):
        cross(X, X2)


def test_rejects_bad_return():
    @check_shapes("X: [N, D]", "return: [N, N]")
    def bad(X):
        return torch.ones((X.shape[0], X.shape[0] + 1), **X64)

    with pytest.raises(ShapeError):
        bad(torch.ones((3, 2), **X64))


def test_literal_and_wildcard_dims():
    @check_shapes("X: [N, 2]", "return: [N, .]")
    def f(X):
        return torch.ones((X.shape[0], 7), **X64)

    f(torch.ones((4, 2), **X64))
    with pytest.raises(ShapeError):
        f(torch.ones((4, 3), **X64))


def test_disabled_is_noop():
    @check_shapes("X: [N, 2]", "return: [N]")
    def f(X):
        return torch.ones((X.shape[0],), **X64)

    prev = get_enable_check_shapes()
    set_enable_check_shapes(False)
    try:
        f(torch.ones((4, 5), **X64))  # spec violation ignored when disabled
    finally:
        set_enable_check_shapes(prev)
    set_enable_check_shapes(True)
    with pytest.raises(ShapeError):
        f(torch.ones((4, 5), **X64))


def test_tuple_returns():
    @check_shapes("X: [N, D]", "return[0]: [N]", "return[1]: [N, N]")
    def f(X):
        n = X.shape[0]
        return torch.ones((n,), **X64), torch.ones((n, n), **X64)

    f(torch.ones((3, 2), **X64))

    @check_shapes("X: [N, D]", "return[0]: [N]", "return[1]: [N, N]")
    def g(X):
        n = X.shape[0]
        return torch.ones((n,), **X64), torch.ones((n, n + 1), **X64)

    with pytest.raises(ShapeError):
        g(torch.ones((3, 2), **X64))


def test_check_shape_inline():
    x = torch.ones((3, 2), **X64)
    assert check_shape(x, "[N, D]") is x
    with pytest.raises(ShapeError):
        check_shape(x, "[N, N, N]")


def test_guarded_specs_select_on_flag():
    from gpflow_tpu_torch.utilities.shapes import ShapeError, check_shapes, set_enable_check_shapes

    @check_shapes(
        "K: [N, N] if full_cov",
        "K: [N] if not full_cov",
        "return: [N]",
    )
    def diag_or_full(K, full_cov=False):
        return np.diag(K) if full_cov else K

    prev = get_enable_check_shapes()
    set_enable_check_shapes(True)
    try:
        diag_or_full(np.eye(3), full_cov=True)
        diag_or_full(np.ones(3), full_cov=False)
        with pytest.raises(ShapeError):
            diag_or_full(np.ones(3), full_cov=True)
        with pytest.raises(ShapeError):
            diag_or_full(np.eye(3), full_cov=False)
        # guard must also see DEFAULT argument values
        with pytest.raises(ShapeError):
            diag_or_full(np.eye(3))
    finally:
        set_enable_check_shapes(prev)


def test_guard_grammar_is_none_and_conjunction():
    """Reference-style guards (kernels/base.py:170-214): `X2 is [not] None`
    atoms combined with and/or/not/parens."""

    @check_shapes(
        "X: [N, D]",
        "X2: [N2, D]",
        "return: [N, N2] if full_cov and (X2 is not None)",
        "return: [N, N] if full_cov and (X2 is None)",
        "return: [N] if not full_cov",
    )
    def k(X, X2=None, full_cov=True):
        if not full_cov:
            return np.ones(X.shape[0])
        n2 = X.shape[0] if X2 is None else X2.shape[0]
        return np.ones((X.shape[0], n2))

    k(np.ones((3, 2)))
    k(np.ones((3, 2)), np.ones((5, 2)))
    k(np.ones((3, 2)), full_cov=False)

    @check_shapes(
        "X: [N, D]",
        "return: [N, N] if full_cov and (X2 is None)",
    )
    def bad(X, X2=None, full_cov=True):
        return np.ones((X.shape[0], X.shape[0] + 1))

    with pytest.raises(ShapeError):
        bad(np.ones((3, 2)))
    bad(np.ones((3, 2)), X2=np.ones((5, 2)))  # guard off -> unchecked


def test_guard_grammar_rejects_malformed():
    for guard in ("full_cov ==", "X2 is", "x &", "(full_cov", "full_cov)"):
        with pytest.raises(ValueError):
            check_shapes(f"X: [N] if {guard}")(lambda X, X2=None, full_cov=True, x=1: X)


def test_guard_typo_raises_at_decoration():
    with pytest.raises(ValueError, match=r"unknown argument\(s\) \['full_covv'\]"):
        @check_shapes("K: [N, N] if full_covv")
        def f(K, full_cov=False):
            return K


def test_register_get_shape_custom_type():
    """Custom shape extractors feed the contract system (reference
    posteriors.py:172, probability_distributions.py:45)."""
    from gpflow_tpu_torch.utilities.shapes import check_shape, register_get_shape

    class Boxed:
        def __init__(self, arr):
            self.arr = arr

    @register_get_shape(Boxed)
    def _get_boxed_shape(b):
        return np.shape(b.arr)

    set_enable_check_shapes(True)
    try:
        check_shape(Boxed(np.ones((3, 2))), "[N, 2]")
        with pytest.raises(ShapeError):
            check_shape(Boxed(np.ones((3, 3))), "[N, 2]")
    finally:
        set_enable_check_shapes(False)


def test_get_shape_of_probability_distribution_and_precomputed_value():
    from gpflow_tpu_torch.posteriors import PrecomputedValue, get_precomputed_value_shape
    from gpflow_tpu_torch.probability_distributions import (
        Gaussian,
        get_probability_distribution_shape,
    )
    from gpflow_tpu_torch.utilities.shapes import check_shape

    p = Gaussian(np.zeros((5, 2)), np.tile(np.eye(2), (5, 1, 1)))
    assert get_probability_distribution_shape(p) == (5, 2)

    pv = PrecomputedValue(torch.ones((4, 3), **X64), (False, True))
    assert get_precomputed_value_shape(pv) == (4, None)

    set_enable_check_shapes(True)
    try:
        check_shape(p, "[N, D]")
        # dynamic axis -> unknown shape -> check skipped, no raise
        check_shape(pv, "[A, B]")
    finally:
        set_enable_check_shapes(False)


def test_dispatcher_get_first_occurrence():
    from gpflow_tpu_torch.utilities import Dispatcher

    d = Dispatcher("demo")

    class A: ...
    class B(A): ...

    @d.register(A)
    def on_a(x):
        return "a"

    assert d.get_first_occurrence(B) is on_a
    assert d.get_first_occurrence(int) is None


def test_leading_transpose_leading_dim_ignored():
    from gpflow_tpu_torch.utilities.ops import leading_transpose

    x = np.ones((2, 3, 4, 5))
    a = leading_transpose(x, [..., -1, -2])
    b = leading_transpose(x, [..., -1, -2], leading_dim=1)
    assert a.shape == b.shape == (2, 3, 5, 4)


def test_kuu_fallbace_separate_alias():
    # reference mo/kuus.py:98 exports this typo'd name; we keep import parity
    from gpflow_tpu_torch.covariances.multioutput.kuus import (
        Kuu_fallbace_separate,
        Kuu_fallback_separate,
    )

    assert Kuu_fallbace_separate is Kuu_fallback_separate


def test_expectation_contracts_fire_on_bad_shapes():
    """The layer-3 expectation/inducing contracts must reject rank-wrong
    inputs."""
    import gpflow_tpu_torch
    from gpflow_tpu_torch.expectations import expectation
    from gpflow_tpu_torch.probability_distributions import Gaussian
    from gpflow_tpu_torch.utilities.shapes import ShapeError, set_enable_check_shapes

    set_enable_check_shapes(True)
    try:
        N, D, M = 4, 2, 3
        mu = torch.zeros((N, D), **X64)
        cov = torch.tile(torch.eye(D, **X64), (N, 1, 1))
        kernel = gpflow_tpu_torch.kernels.SquaredExponential()
        # inducing points in the WRONG input dimension: psi1 spec binds D
        # across p [N, D] and inducing_variable [M, D, P]
        bad_iv = gpflow_tpu_torch.inducing_variables.InducingPoints(np.zeros((M, D + 1)))
        with pytest.raises(ShapeError):
            expectation(Gaussian(mu, cov), (kernel, bad_iv))
        # rank-wrong Z rejected at construction ([M, D] contract)
        with pytest.raises(ShapeError):
            gpflow_tpu_torch.inducing_variables.InducingPoints(np.zeros((M,)))
        # Multiscale scales must match Z's shape
        with pytest.raises(ShapeError):
            gpflow_tpu_torch.inducing_variables.Multiscale(
                np.zeros((M, D)), scales=np.ones((M, D + 1))
            )
    finally:
        set_enable_check_shapes(False)


def test_markov_gaussian_contract_shape_is_n_not_n_plus_1():
    # matches reference probability_distributions.py:98-105: the contract
    # shape of a MarkovGaussian is (N, D) although mu holds N+1 rows
    from gpflow_tpu_torch.probability_distributions import MarkovGaussian

    mu = np.zeros((6, 2))
    cov = np.zeros((2, 6, 2, 2))
    assert MarkovGaussian(mu, cov).shape == (5, 2)
