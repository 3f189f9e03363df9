"""Continuous scalar likelihoods (counterpart of
``gpflow_tpu/likelihoods/scalar_continuous.py``): Gaussian, Exponential,
StudentT, Gamma and Beta. Each positive hyperparameter is a constant
Parameter or an input-dependent Function, bounded below by its
``*_lower_bound`` (default ``config.default_likelihood_positive_minimum()``,
1e-6)."""
from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from .. import logdensities
from ..base import MeanAndVariance
from ..config import default_likelihood_positive_minimum
from ..utilities.parameter_or_function import (
    ConstantOrFunction,
    evaluate_parameter_or_function,
    prepare_parameter_or_function,
)
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import ScalarLikelihood
from .utils import inv_probit

__all__ = ["Beta", "Exponential", "Gamma", "Gaussian", "StudentT"]


def _lower_bound(value: Optional[float]) -> float:
    return default_likelihood_positive_minimum() if value is None else value


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
        self.variance_lower_bound = _lower_bound(variance_lower_bound)
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

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return F

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self._variance(X).expand(F.shape)

    @inherit_check_shapes
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        return Fmu, Fvar + self._variance(X)

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.gaussian(Y, F, self._variance(X))

    @inherit_check_shapes
    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return torch.sum(logdensities.gaussian(Y, Fmu, Fvar + self._variance(X)), dim=-1)

    @inherit_check_shapes
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


class Exponential(ScalarLikelihood):
    """p(y | f) = Exponential(y | mean invlink(f)) (``scalar_continuous.py:125-150``).
    With ``invlink`` ``torch.exp`` the variational expectations are in
    closed form; any other invlink goes through the quadrature."""

    def __init__(self, invlink: Callable[[torch.Tensor], torch.Tensor] = torch.exp, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.invlink = invlink

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.exponential(Y, self.invlink(F))

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.invlink(F)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return torch.square(self.invlink(F))

    @inherit_check_shapes
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        if self.invlink is torch.exp:
            return torch.sum(-torch.exp(-Fmu + Fvar / 2) * Y - Fmu, dim=-1)
        return super()._variational_expectations(X, Fmu, Fvar, Y)


class StudentT(ScalarLikelihood):
    """Student-t noise with ``df`` degrees of freedom and a positive
    ``scale`` (``scalar_continuous.py:153-186``)."""

    def __init__(
        self,
        scale: Any = 1.0,
        df: float = 3.0,
        scale_lower_bound: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.df = df
        self.scale_lower_bound = _lower_bound(scale_lower_bound)
        self.scale = prepare_parameter_or_function(scale, lower_bound=self.scale_lower_bound, name="scale")

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [broadcast batch..., broadcast N, broadcast P]",
    )
    def _scale(self, X: torch.Tensor) -> torch.Tensor:
        return evaluate_parameter_or_function(self.scale, X, lower_bound=self.scale_lower_bound)

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.student_t(Y, F, self._scale(X), self.df)

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return F

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        var = (self._scale(X) ** 2) * (self.df / (self.df - 2.0))
        return var.expand(F.shape)


class Gamma(ScalarLikelihood):
    """The transformed latent gives the Gamma *scale*; ``shape`` is a positive
    hyperparameter (``scalar_continuous.py:189-238``). With ``invlink``
    ``torch.exp`` the variational expectations are in closed form."""

    def __init__(
        self,
        invlink: Callable[[torch.Tensor], torch.Tensor] = torch.exp,
        shape: Any = 1.0,
        shape_lower_bound: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.invlink = invlink
        self.shape_lower_bound = _lower_bound(shape_lower_bound)
        self.shape = prepare_parameter_or_function(shape, lower_bound=self.shape_lower_bound, name="shape")

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [broadcast batch..., broadcast N, broadcast P]",
    )
    def _shape(self, X: torch.Tensor) -> torch.Tensor:
        return evaluate_parameter_or_function(self.shape, X, lower_bound=self.shape_lower_bound)

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.gamma(Y, self._shape(X), self.invlink(F))

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self._shape(X) * self.invlink(F)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self._shape(X) * (self.invlink(F) ** 2)

    @inherit_check_shapes
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        if self.invlink is torch.exp:
            shape = self._shape(X)
            return torch.sum(
                -shape * Fmu
                - torch.lgamma(shape)
                + (shape - 1.0) * torch.log(Y)
                - Y * torch.exp(-Fmu + Fvar / 2.0),
                dim=-1,
            )
        return super()._variational_expectations(X, Fmu, Fvar, Y)


class Beta(ScalarLikelihood):
    """Beta observations in (0, 1), reparametrized by their mean
    invlink(f) and a positive ``scale``: alpha = scale * mean,
    beta = scale * (1 - mean) (``scalar_continuous.py:241-280``)."""

    def __init__(
        self,
        invlink: Callable[[torch.Tensor], torch.Tensor] = inv_probit,
        scale: Any = 1.0,
        scale_lower_bound: Optional[float] = None,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.scale_lower_bound = _lower_bound(scale_lower_bound)
        self.scale = prepare_parameter_or_function(scale, lower_bound=self.scale_lower_bound, name="scale")
        self.invlink = invlink

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [broadcast batch..., broadcast N, broadcast P]",
    )
    def _scale(self, X: torch.Tensor) -> torch.Tensor:
        return evaluate_parameter_or_function(self.scale, X, lower_bound=self.scale_lower_bound)

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        mean = self.invlink(F)
        scale = self._scale(X)
        alpha = mean * scale
        beta = scale - alpha
        return logdensities.beta(Y, alpha, beta)

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.invlink(F)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        mean = self.invlink(F)
        var = (mean - torch.square(mean)) / (self._scale(X) + 1.0)
        return var.expand(F.shape)
