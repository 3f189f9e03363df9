"""The JAX package's ``tests/gpflow_tpu/conditionals/test_util.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

Conditional math-kernel utilities (pattern from reference
``tests/gpflow/conditionals/test_util.py``): rollaxis round trips,
expand_independent_outputs against loop oracles, and the fully-correlated
conditional against base_conditional on the flattened [NP] problem.
"""
import numpy as np
import pytest

from gpflow_tpu_torch.conditionals.util import (
    base_conditional,
    expand_independent_outputs,
    fully_correlated_conditional,
    rollaxis_left,
    rollaxis_right,
)
from .test_torch_translated_support import asarray, translated_test_environment  # noqa: F401

rng = np.random.RandomState(21)
M, N, P = 6, 4, 3


def test_rollaxis_left_right_roundtrip():
    A = rng.randn(2, 3, 4, 5)
    for k in (1, 2, 3):
        left = np.asarray(rollaxis_left(asarray(A), k))
        back = np.asarray(rollaxis_right(asarray(left), k))
        np.testing.assert_array_equal(back, A)
        np.testing.assert_array_equal(left, np.moveaxis(A, range(k), range(-k, 0)))


def test_expand_independent_outputs_against_loops():
    fvar_diag = rng.rand(N, P) + 0.1  # [N, P]
    fvar_full = rng.rand(P, N, N)  # [P, N, N]

    # (full_cov=False, full_output_cov=True) -> [N, P, P] diagonal blocks
    out = np.asarray(expand_independent_outputs(asarray(fvar_diag), False, True))
    assert out.shape == (N, P, P)
    for n in range(N):
        np.testing.assert_allclose(out[n], np.diag(fvar_diag[n]))

    # (True, True) -> [N, P, N, P] with out[n, p, n', p'] = delta_pp' fvar[p, n, n']
    out = np.asarray(expand_independent_outputs(asarray(fvar_full), True, True))
    assert out.shape == (N, P, N, P)
    for n in range(N):
        for p in range(P):
            for n2 in range(N):
                for p2 in range(P):
                    expected = fvar_full[p, n, n2] if p == p2 else 0.0
                    np.testing.assert_allclose(out[n, p, n2, p2], expected)

    # identity cases
    np.testing.assert_array_equal(
        np.asarray(expand_independent_outputs(asarray(fvar_diag), False, False)),
        fvar_diag,
    )
    np.testing.assert_array_equal(
        np.asarray(expand_independent_outputs(asarray(fvar_full), True, False)),
        fvar_full,
    )


def _make_joint_cov(dim):
    a = rng.randn(dim, dim)
    return a @ a.T + dim * np.eye(dim)


@pytest.mark.parametrize("white", [True, False])
def test_fully_correlated_equals_base_conditional_on_flattened(white):
    """fully_correlated_conditional on Kmn [M, N, P] must equal
    base_conditional on the [M, NP]-flattened single-output problem."""
    Kmm = _make_joint_cov(M)
    Kmn_flat = rng.randn(M, N * P)
    Knn_flat = _make_joint_cov(N * P)
    f = rng.randn(M, 1)
    q_sqrt = np.tril(0.2 * rng.randn(1, M, M) + 2 * np.eye(M))

    # reference route: plain single-output conditional over the NP axis
    mean_ref, cov_ref = base_conditional(
        asarray(Kmn_flat), asarray(Kmm), asarray(Knn_flat),
        asarray(f), full_cov=True, q_sqrt=asarray(q_sqrt), white=white,
    )
    mean_ref = np.asarray(mean_ref).reshape(N, P)
    cov_ref = np.asarray(cov_ref)[0].reshape(N, P, N, P)

    # fully-correlated route with the reshaped operands
    mean_fc, cov_fc = fully_correlated_conditional(
        asarray(Kmn_flat.reshape(M, N, P)),
        asarray(Kmm),
        asarray(Knn_flat.reshape(N, P, N, P)),
        asarray(f),
        full_cov=True, full_output_cov=True,
        q_sqrt=asarray(q_sqrt), white=white,
    )
    np.testing.assert_allclose(np.asarray(mean_fc), mean_ref, atol=1e-9)
    np.testing.assert_allclose(np.asarray(cov_fc), cov_ref, atol=1e-9)


@pytest.mark.parametrize("white", [True, False])
def test_fully_correlated_marginals_consistent(white):
    """The (False, False) diagonal must equal the diagonal of the full
    (True, True) joint covariance."""
    Kmm = _make_joint_cov(M)
    Kmn = rng.randn(M, N, P)
    Knn_full = _make_joint_cov(N * P).reshape(N, P, N, P)
    Knn_diag = np.einsum("npnp->np", Knn_full)
    f = rng.randn(M, 1)

    m1, v_joint = fully_correlated_conditional(
        asarray(Kmn), asarray(Kmm), asarray(Knn_full),
        asarray(f), full_cov=True, full_output_cov=True, white=white,
    )
    m2, v_diag = fully_correlated_conditional(
        asarray(Kmn), asarray(Kmm), asarray(Knn_diag),
        asarray(f), full_cov=False, full_output_cov=False, white=white,
    )
    np.testing.assert_allclose(np.asarray(m1), np.asarray(m2), atol=1e-9)
    np.testing.assert_allclose(
        np.einsum("npnp->np", np.asarray(v_joint)), np.asarray(v_diag), atol=1e-9
    )
