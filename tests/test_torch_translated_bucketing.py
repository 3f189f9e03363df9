"""The JAX package's ``tests/gpflow_tpu/utilities/test_bucketing.py``, translated onto the
port: the JAX idioms replaced one for one
(``tests/test_torch_translated_support.py``), the same inputs, oracles,
tolerances and test names; ``jax.jit`` is the port's trace and replay (``jit``),
and the trace count of ``test_bucketize_compiles_once_per_bucket`` is the
port's count of traces.

Bucketed batching (the documented dynamic-shape replacement, SURVEY A.5.1).
"""
import numpy as np
import pytest
import torch

import gpflow_tpu_torch as gpf
from gpflow_tpu_torch.utilities.bucketing import bucket_size_for, bucketize, pad_to_bucket
from .test_torch_translated_support import X64, jit, translated_test_environment  # noqa: F401

rng = np.random.RandomState(43)


def test_bucket_size_for_powers_of_two():
    assert [bucket_size_for(n) for n in (0, 1, 2, 3, 5, 8, 9)] == [1, 1, 2, 4, 8, 8, 16]


def test_bucket_size_for_explicit_buckets():
    assert bucket_size_for(5, [4, 16, 64]) == 16
    with pytest.raises(ValueError, match="no bucket"):
        bucket_size_for(100, [4, 16, 64])


def test_pad_to_bucket_shapes():
    X = rng.randn(5, 3)
    Xp, n = pad_to_bucket(X)
    assert Xp.shape == (8, 3) and n == 5
    np.testing.assert_allclose(np.asarray(Xp[:5]), X)
    np.testing.assert_allclose(np.asarray(Xp[5:]), 0.0)


def test_bucketize_compiles_once_per_bucket():
    traces = []

    @jit(on_trace=lambda x: traces.append(x.shape[0]))  # appended once per TRACE, not per call
    def fn(x):
        return x.sum(-1), x * 2

    wrapped = bucketize(fn)
    for n in (3, 5, 7, 8, 2, 6):
        s, d = wrapped(rng.randn(n, 2))
        assert s.shape == (n,) and d.shape == (n, 2)
    # sizes 5,7,8,6 -> bucket 8; 3 -> 4; 2 -> 2: exactly three traces
    assert sorted(traces) == [2, 4, 8]


def test_bucketize_correct_values_on_gp_prediction():
    X = rng.randn(20, 2)
    Y = np.sin(X[:, :1])
    m = gpf.models.GPR((X, Y), kernel=gpf.kernels.SquaredExponential())
    post = m.posterior()
    predict = bucketize(jit(lambda x: post.predict_f(x)))
    for n in (1, 3, 11):
        Xt = rng.randn(n, 2)
        mu_b, var_b = predict(Xt)
        mu, var = m.predict_f(Xt)
        np.testing.assert_allclose(np.asarray(mu_b), np.asarray(mu), atol=1e-9)
        np.testing.assert_allclose(np.asarray(var_b), np.asarray(var), atol=1e-9)


def test_bucketize_slices_every_padded_axis():
    # full_cov outputs are [b, b] (or [P, b, b]): every axis of the padded
    # length must be sliced, not just the leading one (half-sliced
    # [n, b] covariance)
    def fn(x):
        k = x @ x.T  # [b, b]
        return x.sum(-1), k, torch.broadcast_to(k, (2, *k.shape))

    X = rng.randn(5, 2)
    s, k, kp = bucketize(fn)(X)
    assert s.shape == (5,)
    assert k.shape == (5, 5)
    assert kp.shape == (2, 5, 5)
    np.testing.assert_allclose(np.asarray(k), X @ X.T, atol=1e-12)


def test_bucketize_full_cov_gp_prediction():
    X = rng.randn(16, 2)
    Y = np.sin(X[:, :1])
    m = gpf.models.GPR((X, Y), kernel=gpf.kernels.Matern32())
    predict = bucketize(jit(lambda x: m.predict_f(x, full_cov=True)))
    Xt = rng.randn(5, 2)
    mu_b, cov_b = predict(Xt)
    mu, cov = m.predict_f(Xt, full_cov=True)
    assert cov_b.shape == np.asarray(cov).shape
    np.testing.assert_allclose(np.asarray(mu_b), np.asarray(mu), atol=1e-9)
    np.testing.assert_allclose(np.asarray(cov_b), np.asarray(cov), atol=1e-9)


def test_bucketize_unpad_leading_for_coincident_dims():
    """A [b, P] output with P == bucket size is ambiguous under 'matching';
    'leading' slices only the batch axis and keeps all P columns."""
    P = 8  # == bucket size of a 5-row batch

    def fn(x):
        return torch.ones((x.shape[0], P), **X64)

    X5 = rng.randn(5, 2)
    out_matching = bucketize(fn)(X5)  # documented caveat: slices both axes
    assert out_matching.shape == (5, 5)
    out_leading = bucketize(fn, unpad="leading")(X5)
    assert out_leading.shape == (5, P)
    with pytest.raises(ValueError, match="unpad"):
        bucketize(fn, unpad="nope")


def test_bucketize_rejects_batch_reduced_outputs():
    """A padding-contaminated reduction (no axis equal to the padded size)
    must raise, not silently return a wrong value."""
    import pytest as _pytest

    wrapped = bucketize(lambda x: torch.mean(x))
    # no padding (power-of-two batch): reduction passes through fine? no —
    # unpadded calls return as-is
    np.testing.assert_allclose(float(wrapped(torch.ones((8, 2), **X64))), 1.0)
    with _pytest.raises(ValueError, match="cannot be unpadded"):
        wrapped(torch.ones((7, 2), **X64))  # pads to 8 -> mean contaminated
    # per-row outputs still work
    ok = bucketize(lambda x: x * 2)(torch.ones((7, 2), **X64))
    assert np.asarray(ok).shape == (7, 2)
