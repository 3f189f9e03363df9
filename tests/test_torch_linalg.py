"""The exact-GP linear algebra of gpflow_tpu_torch (``ops/linalg.py``:
``mvn_logp``, ``cholesky_mm``, the blocked triangular inverse;
``logdensities.multivariate_normal``) against gpflow_tpu, in float64 on the
CPU on the same numpy inputs, to 1e-10 relative (entries that are zero in
exact arithmetic get 1e-12 of the largest entry). The blocked inverse is
driven at small n with small blocks."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpflow_tpu import logdensities as jax_logdensities
from gpflow_tpu.ops import linalg as jax_linalg
from gpflow_tpu_torch import config, logdensities
from gpflow_tpu_torch.ops import linalg
from .test_torch_environment import one_thread  # noqa: F401

config.set_default_device("cpu")  # the port builds on the card unless asked for the CPU

RTOL = 1e-10


def _close(got, want, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12 * max(np.max(np.abs(want)), 1.0))


def _spd(rng, n):
    """A Gram-like SPD matrix with cond of a few tens."""
    A = rng.randn(n, n)
    return A @ A.T / n + 0.1 * np.eye(n)


@pytest.fixture
def small_blocks(monkeypatch):
    """The port's dispatch at block size 16, so that n = 64 takes the blocked
    recursive doubling (4 blocks) as n = 2048 does at the real block size."""
    monkeypatch.setattr(linalg, "_BLOCK", 16)


@pytest.mark.parametrize("n", [256, 512])
def test_blocked_inverse_matches_jax_and_the_solve(n):
    rng = np.random.RandomState(n)
    L = np.linalg.cholesky(_spd(rng, n))
    got = linalg._blocked_lower_triangular_inverse(torch.from_numpy(L), block=64)
    _close(got, jax_linalg._blocked_lower_triangular_inverse(jnp.asarray(L), block=64))
    _close(got, np.linalg.solve(L, np.eye(n)), rtol=1e-9)
    assert np.all(np.triu(got.numpy(), k=1) == 0.0)


@pytest.mark.parametrize("shape,blocked", [((64, 64), True), ((128, 128), True), ((48, 48), False),
                                           ((40, 40), False), ((2, 64, 64), False)])
def test_large_triangular_inverse_dispatch(small_blocks, monkeypatch, shape, blocked):
    # blocked where the shape allows it: 2-D, n a power-of-two multiple of
    # the block size with at least 4 blocks (gpflow_tpu/ops/linalg.py:117-126)
    calls = []
    inner = linalg._blocked_lower_triangular_inverse
    monkeypatch.setattr(linalg, "_blocked_lower_triangular_inverse",
                        lambda L, block: calls.append(block) or inner(L, block))
    rng = np.random.RandomState(1)
    L = np.linalg.cholesky(np.stack([_spd(rng, shape[-1]) for _ in range(int(np.prod(shape[:-2])))]))
    L = L.reshape(shape)
    got = linalg._large_triangular_inverse(torch.from_numpy(L))
    assert calls == ([16] if blocked else [])
    _close(got, np.linalg.inv(L), rtol=1e-9)


def _mvn_inputs(seed, n, R):
    rng = np.random.RandomState(seed)
    return rng, _spd(rng, n), rng.randn(n, R), rng.randn(R)


@pytest.mark.parametrize("blocks", ["solve", "blocked"])
@pytest.mark.parametrize("R", [1, 3])
def test_mvn_logp_value_and_pullback_match_jax(request, blocks, R):
    if blocks == "blocked":
        request.getfixturevalue("small_blocks")
    _, ks, d, dp = _mvn_inputs(R, 64, R)
    want, vjp = jax.vjp(jax_linalg.mvn_logp, jnp.asarray(ks), jnp.asarray(d))
    dks_want, dd_want = vjp(jnp.asarray(dp))
    kst = torch.from_numpy(ks).requires_grad_()
    dt = torch.from_numpy(d).requires_grad_()
    got = linalg.mvn_logp(kst, dt)
    got.backward(torch.from_numpy(dp))
    _close(got, want)
    _close(kst.grad, dks_want)
    _close(dt.grad, dd_want)


@pytest.mark.parametrize("blocks", ["solve", "blocked"])
def test_cholesky_mm_pullback_matches_jax(request, blocks):
    if blocks == "blocked":
        request.getfixturevalue("small_blocks")
    rng = np.random.RandomState(5)
    K = _spd(rng, 64)
    dL = np.tril(rng.randn(64, 64))
    want, vjp = jax.vjp(jax_linalg.cholesky_mm, jnp.asarray(K))
    (dK_want,) = vjp(jnp.asarray(dL))
    Kt = torch.from_numpy(K).requires_grad_()
    L = linalg.cholesky_mm(Kt)
    L.backward(torch.from_numpy(dL))
    _close(L, want)
    _close(Kt.grad, dK_want)


def test_mvn_logp_is_nan_where_ks_is_not_positive_definite():
    # no exception and no host check: the Cholesky's failure reads as NaN
    ks = torch.from_numpy(np.diag([1.0, -1.0, 2.0]))
    assert bool(torch.isnan(linalg.mvn_logp(ks, torch.ones(3, 2, dtype=torch.float64))).all())


@pytest.mark.parametrize("mu_cols", [1, 4])
def test_multivariate_normal_matches_jax(mu_cols):
    rng = np.random.RandomState(6)
    L = np.linalg.cholesky(_spd(rng, 20))
    x, mu = rng.randn(20, 4), rng.randn(20, mu_cols)
    got = logdensities.multivariate_normal(torch.from_numpy(x), torch.from_numpy(mu), torch.from_numpy(L))
    _close(got, jax_logdensities.multivariate_normal(x, mu, L))
    _close(got, linalg.mvn_logp(torch.from_numpy(L @ L.T), torch.from_numpy(x - mu)), rtol=1e-9)
