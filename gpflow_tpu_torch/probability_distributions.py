"""Distributions over inputs for the expectations (counterpart of
``gpflow_tpu/probability_distributions.py``): containers of a mean and a
covariance, with the [N, D] shape that the shape contracts read."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .base import Module
from .utilities.shapes import check_shapes, register_get_shape

__all__ = [
    "DiagonalGaussian",
    "Gaussian",
    "MarkovGaussian",
    "ProbabilityDistribution",
    "get_probability_distribution_shape",
]


class ProbabilityDistribution(Module):
    """Base of the input distributions; ``shape`` is [N, D]-style. A
    ``Module``, as in the JAX package, holding tensors and no Parameters."""

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        raise NotImplementedError(f"{type(self).__name__} must implement the `shape` property")


class Gaussian(ProbabilityDistribution):
    """mu: [N, D], cov: [N, D, D]."""

    @check_shapes(
        "mu: [N, D]",
        "cov: [N, D, D]",
    )
    def __init__(self, mu: torch.Tensor, cov: torch.Tensor) -> None:
        super().__init__()
        self.mu = mu
        self.cov = cov

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return tuple(self.mu.shape)


class DiagonalGaussian(ProbabilityDistribution):
    """mu: [N, D], the covariances' diagonals cov: [N, D]."""

    @check_shapes(
        "mu: [N, D]",
        "cov: [N, D]",
    )
    def __init__(self, mu: torch.Tensor, cov: torch.Tensor) -> None:
        super().__init__()
        self.mu = mu
        self.cov = cov

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        return tuple(self.mu.shape)


class MarkovGaussian(ProbabilityDistribution):
    """A Gaussian over a time series x_0 .. x_N (``probability_distributions.py:81-105``):
    mu: [N + 1, D]; cov: [2, N + 1, D, D], cov[0] the marginal covariances
    and cov[1] those between consecutive steps. Its shape is (N, D), so
    that a contract binds N as it does for a Gaussian."""

    @check_shapes(
        "mu: [N_plus_1, D]",
        "cov: [2, N_plus_1, D, D]",
    )
    def __init__(self, mu: torch.Tensor, cov: torch.Tensor) -> None:
        super().__init__()
        self.mu = mu
        self.cov = cov

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        n_plus_1, d = self.mu.shape
        return (n_plus_1 - 1, d)


@register_get_shape(ProbabilityDistribution)
def get_probability_distribution_shape(shaped: ProbabilityDistribution) -> Tuple[int, ...]:
    """The shape the contracts read (``probability_distributions.py:74-78``)."""
    return tuple(shaped.shape)
