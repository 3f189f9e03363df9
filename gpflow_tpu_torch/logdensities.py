"""Closed-form log densities (counterpart of ``gpflow_tpu/logdensities.py``),
elementwise with broadcasting but for ``multivariate_normal``."""
from __future__ import annotations

import math
from typing import Union

import numpy as np
import torch

from .base import _as_tensor, array_inputs
from .utilities.shapes import check_shapes

__all__ = [
    "bernoulli",
    "beta",
    "exponential",
    "gamma",
    "gaussian",
    "laplace",
    "lognormal",
    "multivariate_normal",
    "poisson",
    "student_t",
]


@array_inputs("x", "mu", "var")
@check_shapes(
    "x: [broadcast shape...]",
    "mu: [broadcast shape...]",
    "var: [broadcast shape...]",
    "return: [shape...]",
)
def gaussian(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """log N(x | mu, var), broadcast elementwise (``logdensities.py:33``)."""
    return -0.5 * (math.log(2.0 * math.pi) + torch.log(var) + torch.square(mu - x) / var)


@array_inputs("x", "mu", "var")
@check_shapes(
    "x: [broadcast shape...]",
    "mu: [broadcast shape...]",
    "var: [broadcast shape...]",
    "return: [shape...]",
)
def lognormal(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """log of the density of x whose log is N(mu, var) (``logdensities.py:44-45``)."""
    lnx = torch.log(x)
    return gaussian(lnx, mu, var) - lnx


@array_inputs("x", "p")
@check_shapes(
    "x: [broadcast shape...]",
    "p: [broadcast shape...]",
    "return: [shape...]",
)
def bernoulli(x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """log p where x > 0.5, else log(1 - p) (``logdensities.py:54-55``)."""
    return torch.log(torch.where(x > 0.5, p, 1.0 - p))


@array_inputs("x", "lam")
@check_shapes(
    "x: [broadcast shape...]",
    "lam: [broadcast shape...]",
    "return: [shape...]",
)
def poisson(x: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """log Poisson(x | lam) (``logdensities.py:63-64``)."""
    return x * torch.log(lam) - lam - torch.lgamma(x + 1.0)


@array_inputs("x", "scale")
@check_shapes(
    "x: [broadcast shape...]",
    "scale: [broadcast shape...]",
    "return: [shape...]",
)
def exponential(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """log of the exponential density of mean ``scale`` (``logdensities.py:72-73``)."""
    return -x / scale - torch.log(scale)


@array_inputs("x", "shape", "scale")
@check_shapes(
    "x: [broadcast shape...]",
    "shape: [broadcast shape...]",
    "scale: [broadcast shape...]",
    "return: [shape...]",
)
def gamma(x: torch.Tensor, shape: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """log Gamma(x | shape, scale) (``logdensities.py:82-88``)."""
    return -shape * torch.log(scale) - torch.lgamma(shape) + (shape - 1.0) * torch.log(x) - x / scale


@array_inputs("x", "mean", "scale")
@check_shapes(
    "x: [broadcast shape...]",
    "mean: [broadcast shape...]",
    "scale: [broadcast shape...]",
    "df: [broadcast shape...]",
    "return: [shape...]",
)
def student_t(
    x: torch.Tensor, mean: torch.Tensor, scale: torch.Tensor, df: Union[float, torch.Tensor]
) -> torch.Tensor:
    """log Student-t density with ``df`` degrees of freedom (``logdensities.py:98-108``).
    A Python ``df`` stays on the host: copying it to the device would make
    the host wait for the device. A numpy ``df`` becomes a tensor on x's
    device, as the other arguments do."""
    if isinstance(df, (np.ndarray, np.generic)):
        df = _as_tensor(df, x.device)
    if isinstance(df, torch.Tensor):
        log_gamma_ratio = torch.lgamma((df + 1.0) * 0.5) - torch.lgamma(df * 0.5)
        log_df = torch.log(df)
    else:
        df = float(df)
        log_gamma_ratio = math.lgamma((df + 1.0) * 0.5) - math.lgamma(df * 0.5)
        log_df = math.log(df)
    const = log_gamma_ratio - 0.5 * (torch.log(torch.square(scale)) + log_df + math.log(math.pi))
    return const - 0.5 * (df + 1.0) * torch.log1p((1.0 / df) * torch.square((x - mean) / scale))


def _algdiv(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log(Gamma(b) / Gamma(a + b)) for b >= 8 and a <= b, the series of
    scipy's cdflib ``algdiv`` as ``jax.scipy.special.betaln`` evaluates it."""
    c0, c1, c2 = 0.833333333333333e-01, -0.277777777760991e-02, 0.793650666825390e-03
    c3, c4, c5 = -0.595202931351870e-03, 0.837308034031215e-03, -0.165322962780713e-02
    h = a / b
    c = h / (1 + h)
    x = h / (1 + h)
    d = b + (a - 0.5)
    x2 = x * x
    s3 = 1.0 + (x + x2)
    s5 = 1.0 + (x + x2 * s3)
    s7 = 1.0 + (x + x2 * s5)
    s9 = 1.0 + (x + x2 * s7)
    s11 = 1.0 + (x + x2 * s9)
    t = (1.0 / b) ** 2
    w = ((((c5 * s11 * t + c4 * s9) * t + c3 * s7) * t + c2 * s5) * t + c1 * s3) * t + c0
    w = w * (c / b)
    u = d * torch.log1p(a / b)
    v = a * (torch.log(b) - 1.0)
    return torch.where(u <= v, (w - v) - u, (w - u) - v)


def _betaln(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """log B(a, b), as ``jax.scipy.special.betaln``: lgamma sums for
    max(a, b) < 8, else ``_algdiv``, which keeps its accuracy for large
    arguments."""
    a, b = torch.broadcast_tensors(a, b)
    a, b = torch.minimum(a, b), torch.maximum(a, b)
    small_b = torch.lgamma(a) + (torch.lgamma(b) - torch.lgamma(a + b))
    large_b = torch.lgamma(a) + _algdiv(a, b)
    return torch.where(b < 8, small_b, large_b)


@array_inputs("x", "alpha", "bet")
@check_shapes(
    "x: [broadcast shape...]",
    "alpha: [broadcast shape...]",
    "bet: [broadcast shape...]",
    "return: [shape...]",
)
def beta(x: torch.Tensor, alpha: torch.Tensor, bet: torch.Tensor) -> torch.Tensor:
    """log Beta(x | alpha, bet), with x clipped to [1e-6, 1 - 1e-6] so that
    proportions of exactly 0 or 1 give a finite density and gradient
    (``logdensities.py:117-122``)."""
    x = torch.clamp(x, 1e-6, 1.0 - 1e-6)
    return (alpha - 1.0) * torch.log(x) + (bet - 1.0) * torch.log1p(-x) - _betaln(alpha, bet)


@array_inputs("x", "mu", "sigma")
@check_shapes(
    "x: [broadcast shape...]",
    "mu: [broadcast shape...]",
    "sigma: [broadcast shape...]",
    "return: [shape...]",
)
def laplace(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """log Laplace(x | mu, sigma) (``logdensities.py:131-132``)."""
    return -torch.abs(mu - x) / sigma - torch.log(2.0 * sigma)


@array_inputs("x", "mu", "L")
@check_shapes(
    "x: [D, broadcast R]",
    "mu: [D, broadcast R]",
    "L: [D, D]",
    "return: [R]",
)
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
