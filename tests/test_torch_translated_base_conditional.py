"""The JAX package's ``tests/gpflow_tpu/conditionals/test_base_conditional.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names.

base_conditional vs a dense NumPy oracle over the whitened/unwhitened x
q_sqrt-form x full_cov grid — the "hard part #1" combinatorics of
SURVEY.md §7.3 (reference math at ``conditionals/util.py:73-169``).
"""
import numpy as np
import pytest

from gpflow_tpu_torch.conditionals.util import base_conditional, sample_mvn
from .test_torch_translated_support import deviation, seeded_generator, translated_test_environment  # noqa: F401

rng = np.random.RandomState(1)
M, N, R = 5, 7, 2


def _oracle(Kmn, Kmm, Knn, f, q_sqrt, white):
    """Dense NumPy: q(g1) moments after integrating q(u).

    Unwhitened: mean = Knm Kmm^-1 f;  whitened: mean = Knm Lm^-T f
    cov = Knn - Knm Kmm^-1 Kmn + A^T S A with A the appropriate projection.
    """
    Lm = np.linalg.cholesky(Kmm)
    Kmm_inv = np.linalg.inv(Kmm)
    means = np.zeros((N, f.shape[1]))
    covs = []
    Lm_inv = np.linalg.inv(Lm)
    for r in range(f.shape[1]):
        if white:
            # whitened: mean = Knm Lm^-T f; cov term uses A = Lm^-1 Kmn
            mean = Kmn.T @ Lm_inv.T @ f[:, r]
            Amat = Lm_inv @ Kmn
        else:
            mean = Kmn.T @ Kmm_inv @ f[:, r]
            Amat = Kmm_inv @ Kmn
        base_cov = Knn - Kmn.T @ Kmm_inv @ Kmn
        if q_sqrt is None:
            S = np.zeros((M, M))
        elif q_sqrt.ndim == 2:
            S = np.diag(q_sqrt[:, r] ** 2)
        else:
            Lq = np.tril(q_sqrt[r])
            S = Lq @ Lq.T
        cov = base_cov + Amat.T @ S @ Amat
        means[:, r] = mean
        covs.append(cov)
    return means, np.stack(covs)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("q_form", [None, "diag", "tril"])
@pytest.mark.parametrize("full_cov", [False, True])
def test_base_conditional_vs_oracle(white, q_form, full_cov):
    X = rng.randn(M + N, 2)
    from gpflow_tpu_torch import kernels

    k = kernels.SquaredExponential(lengthscales=1.2)
    Kfull = np.asarray(k(X)) + 1e-10 * np.eye(M + N)
    Kmm = Kfull[:M, :M] + 1e-6 * np.eye(M)
    Kmn = Kfull[:M, M:]
    Knn_full = Kfull[M:, M:]

    f = rng.randn(M, R)
    if q_form is None:
        q_sqrt = None
    elif q_form == "diag":
        q_sqrt = np.abs(rng.randn(M, R)) + 0.2
    else:
        q_sqrt = np.stack([np.tril(rng.randn(M, M)) + np.eye(M) for _ in range(R)])

    Knn = Knn_full if full_cov else np.diag(Knn_full)
    mean, var = base_conditional(
        Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white
    )
    mean_ref, cov_ref = _oracle(Kmn, Kmm, Knn_full, f, q_sqrt, white)

    np.testing.assert_allclose(np.asarray(mean), mean_ref, rtol=1e-7, atol=1e-9)
    if full_cov:
        assert np.asarray(var).shape == (R, N, N)
        np.testing.assert_allclose(np.asarray(var), cov_ref, rtol=1e-6, atol=1e-8)
    else:
        assert np.asarray(var).shape == (N, R)
        diag_ref = np.stack([np.diag(c) for c in cov_ref], axis=-1)
        np.testing.assert_allclose(np.asarray(var), diag_ref, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("full_cov", [False, True])
def test_base_conditional_inv_solve_batched_leading_dims(
    monkeypatch, white, full_cov
):
    """INV_SOLVE path with leading batch dims must match the solve path.

    Regression: the fast path used to invert the BROADCAST [..., M, M]
    Cholesky (redundant O(M^3) work per batch element); now it inverts once
    and broadcasts — results must stay identical either way."""
    B1, B2, Nn = 2, 3, 12  # N > M triggers the inv-solve branch (M=5)
    X = rng.randn(M, 2)
    from gpflow_tpu_torch import kernels

    k = kernels.SquaredExponential(lengthscales=0.9)
    Kmm = np.asarray(k(X)) + 1e-6 * np.eye(M)
    Kmn = rng.randn(M, B1, B2, Nn) * 0.3
    Knn_full = np.stack(
        [np.eye(Nn) + 0.1 * np.ones((Nn, Nn)) for _ in range(B1 * B2)]
    ).reshape(B1, B2, Nn, Nn)
    Knn = Knn_full if full_cov else np.einsum("...ii->...i", Knn_full)
    f = rng.randn(M, R)
    q_sqrt = np.stack([np.tril(rng.randn(M, M)) + np.eye(M) for _ in range(R)])

    monkeypatch.delenv("GPFLOW_TPU_INV_SOLVE", raising=False)
    mean_ref, var_ref = base_conditional(
        Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white
    )
    monkeypatch.setenv("GPFLOW_TPU_INV_SOLVE", "1")
    mean_fast, var_fast = base_conditional(
        Kmn, Kmm, Knn, f, full_cov=full_cov, q_sqrt=q_sqrt, white=white
    )
    np.testing.assert_allclose(
        np.asarray(mean_fast), np.asarray(mean_ref), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(var_fast), np.asarray(var_ref), rtol=1e-8, atol=1e-10
    )


@deviation("the draws")
def test_sample_mvn_default_key_refused_inside_jit():
    """Omitting `key=` under tracing would bake a constant PRNG key into the
    compiled function (identical samples every call) — must raise."""

    mean = rng.randn(4, 3)
    cov = np.abs(rng.randn(4, 3)) + 0.1

    def f(m, c):
        return sample_mvn(m, c, full_cov=False)

    with pytest.raises(ValueError, match="explicit"):
        (f)(mean, cov)
    # outside jit the stateful default key still works, and successive calls
    # draw DIFFERENT keys
    s1 = np.asarray(sample_mvn(mean, cov, full_cov=False))
    s2 = np.asarray(sample_mvn(mean, cov, full_cov=False))
    assert s1.shape == (4, 3)
    assert not np.allclose(s1, s2)


def test_sample_mvn_moments():

    mean = rng.randn(1, 3)
    cov_factor = rng.randn(3, 3)
    cov = cov_factor @ cov_factor.T + np.eye(3)
    n = 40_000
    key = seeded_generator(0)
    samples = np.asarray(
        sample_mvn(
            np.broadcast_to(mean, (n, 3)),
            np.broadcast_to(cov, (n, 3, 3)),
            full_cov=True,
            generator=key,
        )
    )
    np.testing.assert_allclose(samples.mean(0), mean[0], atol=0.05)
    emp_cov = np.cov(samples.T)
    np.testing.assert_allclose(emp_cov, cov, atol=0.15, rtol=0.1)


def test_inv_solve_context_manager_overrides_env(monkeypatch):
    """The programmatic inv_solve switch (in place of the process-global
    env var alone) selects the same fast path as the env var and
    restores the previous state on exit."""
    from gpflow_tpu_torch.conditionals.util import _use_inv_solve, inv_solve, set_inv_solve

    monkeypatch.delenv("GPFLOW_TPU_INV_SOLVE", raising=False)
    assert _use_inv_solve() is False
    with inv_solve():
        assert _use_inv_solve() is True
        with inv_solve(False):  # nesting restores the outer setting
            assert _use_inv_solve() is False
        assert _use_inv_solve() is True
    assert _use_inv_solve() is False

    # explicit setting beats the env var in both directions
    monkeypatch.setenv("GPFLOW_TPU_INV_SOLVE", "1")
    with inv_solve(False):
        assert _use_inv_solve() is False
    assert _use_inv_solve() is True
    set_inv_solve(None)

    # numeric agreement through the public conditional
    M, Nn, R = 8, 24, 2
    from gpflow_tpu_torch import kernels

    X = rng.randn(M, 2)
    k = kernels.SquaredExponential()
    Kmm = np.asarray(k(X)) + 1e-6 * np.eye(M)
    Kmn = rng.randn(M, Nn) * 0.3
    Knn = np.ones((Nn,)) * 1.1
    f = rng.randn(M, R)
    monkeypatch.delenv("GPFLOW_TPU_INV_SOLVE", raising=False)
    mean_ref, var_ref = base_conditional(Kmn, Kmm, Knn, f)
    with inv_solve():
        mean_fast, var_fast = base_conditional(Kmn, Kmm, Knn, f)
    np.testing.assert_allclose(np.asarray(mean_fast), np.asarray(mean_ref), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(var_fast), np.asarray(var_ref), rtol=1e-8)
