"""Factorization helpers with matmul-only backward passes (counterpart of
``gpflow_tpu/ops/linalg.py``).

* ``cholesky(K)``: the lower Cholesky factor, NaN where K is not positive
  definite, as ``jnp.linalg.cholesky`` returns. It never raises
  and never synchronises the host with a CUDA device.
* ``triangular_inverse(L)``: forward is one [M, M] triangular solve against
  the identity; backward is ``-L^-T dX L^-T`` projected to the lower
  triangle (two matmuls, no solve).
* ``chol_and_inverse(K)``: forward is ``cholesky`` + ``triangular_inverse``;
  backward folds both cotangents into the Cholesky pullback (Murray 2016,
  "Differentiation of the Cholesky decomposition", arXiv:1602.07527, eq. 8)
  evaluated with the saved ``L^-1``: matmuls only, no solve.

These take arbitrary leading batch dimensions. For one large standalone
[n, n] factorization (the exact-GP objective) there are also:

* ``cholesky_mm(K)``: ``cholesky`` whose backward computes ``L^-1`` once
  (``_large_triangular_inverse``) and evaluates the same pullback as
  matmuls;
* ``mvn_logp(ks, d)``: log N(d_r | 0, ks) per column r with the analytic
  pullback ``dks = 1/2 beta beta^T - 1/2 ks^-1``, ``dd = -beta dp``.

Float32 matmuls run in full IEEE fp32 (the package turns TF32 off on
import), so these backwards are at least as precise as the JAX package's
pinned HIGH/HIGHEST precisions (``gpflow_tpu/ops/linalg.py:285-299``).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..base import array_inputs

__all__ = ["chol_and_inverse", "cholesky", "cholesky_mm", "mvn_logp", "sym_jitter", "triangular_inverse"]


@array_inputs("A")
def sym_jitter(A: torch.Tensor) -> torch.Tensor:
    """Symmetrizes ``A`` and, below float64, adds a diagonal jitter of 1e-5
    times the mean absolute diagonal (``gpflow_tpu/ops/linalg.py:42-56``)."""
    A = 0.5 * (A + A.mT)
    if A.dtype == torch.float64:
        return A
    scale = torch.mean(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    eps = 1e-5 * scale[..., None, None]
    return A + eps * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a symmetric [..., M, M] K. Where a matrix of
    the batch is not positive definite its lower triangle is NaN (the upper
    stays 0), as ``jnp.linalg.cholesky`` gives; the failure is never read on
    the host. Differentiable through ``torch.linalg.cholesky_ex``."""
    L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info == 0)[..., None, None], L, torch.full_like(L, float("nan")).tril())


def _lower_triangular_inverse_values(L: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


_BLOCK = 512  # diagonal-block size of the recursive-doubling inverse


def _blocked_lower_triangular_inverse(L: torch.Tensor, block: int = _BLOCK) -> torch.Tensor:
    """L^-1 for a 2-D lower-triangular [n, n] L by recursive doubling
    (``gpflow_tpu/ops/linalg.py:74-114``): one batched solve inverts the n/b
    diagonal blocks, then log2(n/b) rounds of batched matmuls combine pairs,

        inv([[A, 0], [B, C]]) = [[A^-1, 0], [-C^-1 B A^-1, C^-1]],

    about (2/3) n^3 flops in all. n must be ``block`` times a power of two.
    The diagonal and sub-diagonal blocks are read as strided views of L."""
    n = L.shape[-1]
    nb = n // block
    diag = torch.diagonal(L.view(nb, block, nb, block), dim1=0, dim2=2).permute(2, 0, 1)
    eye = torch.eye(block, dtype=L.dtype, device=L.device).expand(nb, block, block)
    inv = torch.linalg.solve_triangular(diag, eye, upper=False)  # [nb, b, b]
    s = block
    while s < n:
        # B_j = L[(2j+1)s:(2j+2)s, 2js:(2j+1)s]: every other block of the
        # first sub-diagonal of the (n/s) x (n/s) block grid
        sub = torch.diagonal(L.view(n // s, s, n // s, s), offset=-1, dim1=0, dim2=2)
        B = sub[..., 0::2].permute(2, 0, 1)  # [p, s, s]
        A_inv, C_inv = inv[0::2], inv[1::2]
        X = -torch.matmul(C_inv, torch.matmul(B, A_inv))
        top = torch.cat([A_inv, torch.zeros_like(X)], dim=-1)
        bottom = torch.cat([X, C_inv], dim=-1)
        inv = torch.cat([top, bottom], dim=-2)  # [p, 2s, 2s]
        s *= 2
    return inv[0]


def _large_triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """The blocked recursive doubling where the shape allows it (2-D, n a
    power-of-two multiple of ``_BLOCK`` with at least 4 blocks), else one
    triangular solve against the identity (``gpflow_tpu/ops/linalg.py:117-126``)."""
    n = L.shape[-1]
    if L.ndim == 2 and n % _BLOCK == 0:
        nb = n // _BLOCK
        if nb >= 4 and (nb & (nb - 1)) == 0:
            return _blocked_lower_triangular_inverse(L, _BLOCK)
    return _lower_triangular_inverse_values(L)


def _phi(x: torch.Tensor) -> torch.Tensor:
    """Lower triangle with the diagonal halved (the Cholesky pullback's
    projection)."""
    return torch.tril(x) - 0.5 * torch.diag_embed(torch.diagonal(x, dim1=-2, dim2=-1))


def _fold_inverse_cotangent(Linv: torch.Tensor, dLinv: torch.Tensor) -> torch.Tensor:
    """The L cotangent equivalent to a cotangent of L^-1:
    d(L^-1) = -L^-1 dL L^-1, so dL = tril(-L^-T dLinv L^-T)."""
    return torch.tril(-torch.matmul(Linv.mT, torch.matmul(dLinv, Linv.mT)))


class _TriangularInverse(torch.autograd.Function):
    """``gpflow_tpu/ops/linalg.py:140-162``."""

    @staticmethod
    def forward(ctx, L: torch.Tensor) -> torch.Tensor:
        Linv = _lower_triangular_inverse_values(L)
        ctx.save_for_backward(Linv)
        return Linv

    @staticmethod
    def backward(ctx, dLinv: torch.Tensor) -> torch.Tensor:
        (Linv,) = ctx.saved_tensors
        return _fold_inverse_cotangent(Linv, dLinv)


class _CholAndInverse(torch.autograd.Function):
    """``gpflow_tpu/ops/linalg.py:165-199``."""

    @staticmethod
    def forward(ctx, K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        L = cholesky(K)
        Linv = _lower_triangular_inverse_values(L)
        ctx.save_for_backward(L, Linv)
        return L, Linv

    @staticmethod
    def backward(ctx, dL: torch.Tensor, dLinv: torch.Tensor) -> torch.Tensor:
        L, Linv = ctx.saved_tensors
        dL = dL + _fold_inverse_cotangent(Linv, dLinv)
        # dK = (1/2) L^-T (P + P^T) L^-1, P = Phi(L^T dL)
        P = _phi(torch.matmul(L.mT, dL))
        return 0.5 * torch.matmul(Linv.mT, torch.matmul(P + P.mT, Linv))


@array_inputs("L")
def triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular [..., M, M] matrix; its backward is two
    matmuls."""
    return _TriangularInverse.apply(L)


@array_inputs("K")
def chol_and_inverse(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) for a symmetric positive-definite [..., M, M] K: one
    Cholesky and one [M, M] triangular solve forward, matmuls backward. Both
    are NaN where K is not positive definite."""
    return _CholAndInverse.apply(K)


class _CholeskyMM(torch.autograd.Function):
    """``gpflow_tpu/ops/linalg.py:202-240``."""

    @staticmethod
    def forward(ctx, K: torch.Tensor) -> torch.Tensor:
        L = cholesky(K)
        ctx.save_for_backward(L)
        return L

    @staticmethod
    def backward(ctx, dL: torch.Tensor) -> torch.Tensor:
        (L,) = ctx.saved_tensors
        Linv = _large_triangular_inverse(L)
        P = _phi(torch.matmul(L.mT, dL))
        return 0.5 * torch.matmul(Linv.mT, torch.matmul(P + P.mT, Linv))


class _MvnLogp(torch.autograd.Function):
    """``gpflow_tpu/ops/linalg.py:243-304``."""

    @staticmethod
    def forward(ctx, ks: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
        L = cholesky(ks)
        alpha = torch.linalg.solve_triangular(L, d, upper=False)  # [n, R]
        n = ks.shape[-1]
        p = (
            -0.5 * torch.sum(torch.square(alpha), dim=0)
            - 0.5 * n * math.log(2.0 * math.pi)
            - torch.sum(torch.log(torch.diagonal(L)))
        )
        ctx.save_for_backward(L, alpha)
        return p

    @staticmethod
    def backward(ctx, dp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        L, alpha = ctx.saved_tensors
        Linv = _large_triangular_inverse(L)
        beta = torch.matmul(Linv.mT, alpha)  # [n, R] = ks^-1 d
        Kinv = torch.matmul(Linv.mT, Linv)
        # dks = sum_r dp_r (1/2 beta_r beta_r^T) - (sum_r dp_r) (1/2) Kinv
        bscaled = beta * dp[None, :]
        dks = 0.5 * (torch.matmul(bscaled, beta.mT) - torch.sum(dp) * Kinv)
        return dks, -bscaled


@array_inputs("K")
def cholesky_mm(K: torch.Tensor) -> torch.Tensor:
    """``cholesky(K)`` of one large [n, n] K, whose backward computes
    ``L^-1`` once (the blocked recursive doubling where the shape allows it)
    and evaluates the Cholesky pullback ``dK = 1/2 L^-T (P + P^T) L^-1``,
    ``P = Phi(L^T dL)`` as matmuls. Its gradient error grows as
    cond(K) * eps, from the explicit inverse."""
    return _CholeskyMM.apply(K)


@array_inputs("ks", "d")
def mvn_logp(ks: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """[R] log densities log N(d[:, r] | 0, ks) for ks [n, n] and d [n, R].

    Forward: one Cholesky (``cholesky``: NaN where ks is not positive
    definite, no host synchronisation) and one [n, R] triangular solve.
    Backward: the closed form ``dks = sum_r dp_r (1/2 beta_r beta_r^T) -
    (sum_r dp_r) (1/2) ks^-1``, ``dd = -beta dp`` with ``beta = ks^-1 d``:
    ``L^-1`` once (the blocked recursive doubling where the shape allows it)
    and one [n, n] matmul for ``ks^-1 = L^-T L^-1``. TF32 stays off, so
    every product runs in exact fp32 (at least the JAX package's pinned
    precisions); the gradient carries a cond(ks) * eps error from the
    explicit inverse."""
    return _MvnLogp.apply(ks, d)
