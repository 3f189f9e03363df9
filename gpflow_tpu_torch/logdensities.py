"""Closed-form log densities (counterpart of ``gpflow_tpu/logdensities.py``;
``gaussian``, ``bernoulli``, ``poisson`` and ``multivariate_normal`` so far,
ROADMAP.md lists the rest)."""
from __future__ import annotations

import math

import torch

__all__ = ["bernoulli", "gaussian", "multivariate_normal", "poisson"]


def gaussian(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """log N(x | mu, var), broadcast elementwise (``logdensities.py:33``)."""
    return -0.5 * (math.log(2.0 * math.pi) + torch.log(var) + torch.square(mu - x) / var)


def bernoulli(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """log p where x > 0.5, else log(1 - p) (``logdensities.py:54-55``)."""
    return torch.log(torch.where(x > 0.5, p, 1.0 - p))


def poisson(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """log Poisson(x | lam) (``logdensities.py:63-64``)."""
    return x * torch.log(lam) - lam - torch.lgamma(x + 1.0)


def multivariate_normal(x: torch.Tensor, mu: torch.Tensor, L: torch.Tensor) -> torch.Tensor:
    """log N(x[:, r] | mu[:, r], L L^T) for each column r, given the lower
    Cholesky factor L [D, D] (``logdensities.py:141-154``): x [D, R], mu
    [D, R] or [D, 1]; returns [R]."""
    d = x - mu
    alpha = torch.linalg.solve_triangular(L, d, upper=False)  # [D, R]
    num_dims = x.shape[0]
    p = -0.5 * torch.sum(torch.square(alpha), dim=0)
    p = p - 0.5 * num_dims * math.log(2.0 * math.pi)
    p = p - torch.sum(torch.log(torch.diagonal(L)))
    return p
