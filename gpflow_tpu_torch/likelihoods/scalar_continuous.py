"""Continuous scalar likelihoods (counterpart of
``gpflow_tpu/likelihoods/scalar_continuous.py``; ``Gaussian`` so far)."""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from .. import logdensities
from ..base import MeanAndVariance
from ..config import default_likelihood_positive_minimum
from ..utilities.parameter_or_function import (
    ConstantOrFunction,
    evaluate_parameter_or_function,
    prepare_parameter_or_function,
)
from ..utilities.shapes import check_shapes
from .base import ScalarLikelihood

__all__ = ["Gaussian"]


class Gaussian(ScalarLikelihood):
    """Gaussian noise (``scalar_continuous.py:39-145``). Its ``variance`` or
    its ``scale`` (not both) is a constant Parameter or an input-dependent
    Function; the variance is bounded below by ``variance_lower_bound``
    (default ``config.default_likelihood_positive_minimum()``, 1e-6) and the
    scale by its square root."""

    def __init__(
        self,
        variance: Optional[Any] = None,
        *,
        scale: Optional[Any] = None,
        variance_lower_bound: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.variance_lower_bound = (
            default_likelihood_positive_minimum() if variance_lower_bound is None else variance_lower_bound
        )
        self.scale_lower_bound = math.sqrt(self.variance_lower_bound)
        if scale is None:
            self.variance: Optional[ConstantOrFunction] = prepare_parameter_or_function(
                1.0 if variance is None else variance,
                lower_bound=self.variance_lower_bound,
                name="variance",
            )
            self.scale: Optional[ConstantOrFunction] = None
        else:
            if variance is not None:
                raise ValueError("Cannot set both `variance` and `scale`.")
            self.variance = None
            self.scale = prepare_parameter_or_function(scale, lower_bound=self.scale_lower_bound, name="scale")

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [broadcast batch..., broadcast N, broadcast P]",
    )
    def _variance(self, X: torch.Tensor) -> torch.Tensor:
        if self.variance is not None:
            return evaluate_parameter_or_function(self.variance, X, lower_bound=self.variance_lower_bound)
        return evaluate_parameter_or_function(self.scale, X, lower_bound=self.scale_lower_bound) ** 2

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [batch..., N, 1]",
    )
    def variance_at(self, X: torch.Tensor) -> torch.Tensor:
        """The noise variance broadcast to [batch..., N, 1]
        (``scalar_continuous.py:77-85``)."""
        return self._variance(X).expand(X.shape[:-1] + (1,))

    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return F

    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self._variance(X).expand(F.shape)

    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        return Fmu, Fvar + self._variance(X)

    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.gaussian(Y, F, self._variance(X))

    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return torch.sum(logdensities.gaussian(Y, Fmu, Fvar + self._variance(X)), dim=-1)

    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        """Closed form (``scalar_continuous.py:112-122``)."""
        variance = self._variance(X)
        return torch.sum(
            -0.5 * math.log(2 * math.pi)
            - 0.5 * torch.log(variance)
            - 0.5 * ((Y - Fmu) ** 2 + Fvar) / variance,
            dim=-1,
        )
