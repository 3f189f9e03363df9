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

All take arbitrary leading batch dimensions.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["chol_and_inverse", "cholesky", "sym_jitter", "triangular_inverse"]


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


def triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular [..., M, M] matrix; its backward is two
    matmuls."""
    return _TriangularInverse.apply(L)


def chol_and_inverse(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) for a symmetric positive-definite [..., M, M] K: one
    Cholesky and one [M, M] triangular solve forward, matmuls backward. Both
    are NaN where K is not positive definite."""
    return _CholAndInverse.apply(K)
