"""Likelihoods of one observation driven by several latent functions
(counterpart of ``gpflow_tpu/likelihoods/multilatent.py``).

The JAX package builds the conditional distribution of Y from F with a
callable that returns any object with ``log_prob(Y)``, ``mean()`` and
``variance()``; the port keeps its own copies of its two small distribution
classes, with the JAX package's formulas.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Type

import torch

from .. import logdensities
from ..bijectors import Bijector, positive
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import QuadratureLikelihood

__all__ = [
    "HeteroskedasticTFPConditional",
    "MultiLatentLikelihood",
    "MultiLatentTFPConditional",
    "NormalDistribution",
    "StudentTDistribution",
]


@dataclasses.dataclass
class NormalDistribution:
    """N(loc, scale^2) (``multilatent.py:33-47``)."""

    loc: torch.Tensor
    scale: torch.Tensor

    def log_prob(self, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.gaussian(Y, self.loc, torch.square(self.scale))

    def mean(self) -> torch.Tensor:
        return self.loc

    def variance(self) -> torch.Tensor:
        return torch.square(self.scale)


@dataclasses.dataclass
class StudentTDistribution:
    """Student-t of location ``loc``, scale ``scale`` and ``df`` degrees of
    freedom (``multilatent.py:50-62``)."""

    loc: torch.Tensor
    scale: torch.Tensor
    df: float = 3.0

    def log_prob(self, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.student_t(Y, self.loc, self.scale, self.df)

    def mean(self) -> torch.Tensor:
        return self.loc

    def variance(self) -> torch.Tensor:
        return torch.square(self.scale) * (self.df / (self.df - 2.0))


class MultiLatentLikelihood(QuadratureLikelihood):
    """One-dimensional observations driven by ``latent_dim`` latent
    functions, integrated by Gauss-Hermite quadrature over all of them
    (``multilatent.py:65-70``)."""

    def __init__(self, latent_dim: int, **kwargs: Any) -> None:
        super().__init__(input_dim=None, latent_dim=latent_dim, observation_dim=1, **kwargs)


class MultiLatentTFPConditional(MultiLatentLikelihood):
    """The observation's distribution built from F by
    ``conditional_distribution`` (``multilatent.py:73-96``)."""

    def __init__(self, latent_dim: int, conditional_distribution: Callable[..., Any], **kwargs: Any) -> None:
        super().__init__(latent_dim, **kwargs)
        self.conditional_distribution = conditional_distribution

    @inherit_check_shapes
    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return torch.squeeze(self.conditional_distribution(F).log_prob(Y), -1)

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.conditional_distribution(F).mean()

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.conditional_distribution(F).variance()


class HeteroskedasticTFPConditional(MultiLatentTFPConditional):
    """Two latent functions give the location and, through
    ``scale_transform`` (default ``positive(base="exp")``), the scale of
    the observation's distribution (``multilatent.py:99-131``)."""

    def __init__(
        self,
        distribution_class: Type[Any] = NormalDistribution,
        scale_transform: Optional[Any] = None,
        **kwargs: Any,
    ) -> None:
        @check_shapes(
            "F: [batch..., 2]",
        )
        def conditional_distribution(F: torch.Tensor) -> Any:
            transform = self.scale_transform
            scale_fn = transform.forward if isinstance(transform, Bijector) else transform
            return distribution_class(F[..., :1], scale_fn(F[..., 1:]))

        super().__init__(latent_dim=2, conditional_distribution=conditional_distribution, **kwargs)
        self.scale_transform = positive(base="exp") if scale_transform is None else scale_transform
