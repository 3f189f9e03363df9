"""Factorization helpers (counterpart of ``gpflow_tpu/ops/linalg.py``).

Forward values only for now: ``triangular_inverse`` and ``chol_and_inverse``
differentiate through ``torch.linalg`` here. Their matmul-only custom
backward passes (``gpflow_tpu/ops/linalg.py:140-199``) come with the training
slice. Both take arbitrary leading batch dimensions.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["chol_and_inverse", "sym_jitter", "triangular_inverse"]


def sym_jitter(A: torch.Tensor) -> torch.Tensor:
    """Symmetrizes ``A`` and, below float64, adds a diagonal jitter of 1e-5
    times the mean absolute diagonal (``gpflow_tpu/ops/linalg.py:42-56``)."""
    A = 0.5 * (A + A.mT)
    if A.dtype == torch.float64:
        return A
    scale = torch.mean(torch.abs(torch.diagonal(A, dim1=-2, dim2=-1)), dim=-1)
    eps = 1e-5 * scale[..., None, None]
    return A + eps * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)


def triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """Inverse of a lower-triangular [..., M, M] matrix: one triangular solve
    against the identity."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device).expand(L.shape)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def chol_and_inverse(K: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, L^-1) for a symmetric positive-definite [..., M, M] K: one Cholesky
    and one [M, M] triangular solve. Raises where K is not positive definite
    (the JAX package returns NaNs there)."""
    L = torch.linalg.cholesky(K)
    return L, triangular_inverse(L)
