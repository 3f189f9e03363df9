"""Likelihood base classes (counterpart of ``gpflow_tpu/likelihoods/base.py``):
``Likelihood``, the Gauss-Hermite fallback ``QuadratureLikelihood`` and
``ScalarLikelihood``. ``SwitchedLikelihood`` and ``MonteCarloLikelihood`` are
not ported yet (ROADMAP.md).

Shapes: the last dimension of F holds the latent functions and of Y the
observations; every statistic returns the batch shape with it reduced.
"""
from __future__ import annotations

import abc
from typing import Any, Optional

import torch

from ..base import MeanAndVariance, Module
from ..quadrature import GaussianQuadrature, NDiagGHQuadrature

__all__ = [
    "DEFAULT_NUM_GAUSS_HERMITE_POINTS",
    "Likelihood",
    "QuadratureLikelihood",
    "ScalarLikelihood",
]

DEFAULT_NUM_GAUSS_HERMITE_POINTS = 20
"""The Gauss-Hermite resolution of the quadrature fallback (``base.py:33``)."""


class Likelihood(Module, abc.ABC):
    """Observation model p(Y | X, F) (``base.py:37-168``)."""

    def __init__(
        self,
        input_dim: Optional[int],
        latent_dim: Optional[int],
        observation_dim: Optional[int],
    ) -> None:
        super().__init__()
        self.input_dim = input_dim
        self.latent_dim = latent_dim
        self.observation_dim = observation_dim

    def log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(Y | X, F) -> [batch...]."""
        return self._log_prob(X, F, Y)

    @abc.abstractmethod
    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        """E[Y | X, F] -> [batch..., observation_dim]."""
        return self._conditional_mean(X, F)

    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        """var[Y | X, F] -> [batch..., observation_dim]."""
        return self._conditional_variance(X, F)

    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        """Mean and variance of Y under q(f) = N(Fmu, Fvar)."""
        return self._predict_mean_and_var(X, Fmu, Fvar)

    @abc.abstractmethod
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        raise NotImplementedError

    def predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        """log int p(Y | f) q(f) df -> [batch...]."""
        return self._predict_log_density(X, Fmu, Fvar, Y)

    @abc.abstractmethod
    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError

    def variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        """int log p(Y | f) q(f) df -> [batch...] (``base.py:152-168``)."""
        return self._variational_expectations(X, Fmu, Fvar, Y)

    @abc.abstractmethod
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        raise NotImplementedError


class QuadratureLikelihood(Likelihood, abc.ABC):
    """Gauss-Hermite quadrature as the fallback for the three Gaussian
    integrals (``base.py:171-241``); ``quadrature`` defaults to
    ``DEFAULT_NUM_GAUSS_HERMITE_POINTS`` points per dimension."""

    def __init__(
        self,
        input_dim: Optional[int],
        latent_dim: Optional[int],
        observation_dim: Optional[int],
        *,
        quadrature: Optional[GaussianQuadrature] = None,
    ) -> None:
        super().__init__(input_dim=input_dim, latent_dim=latent_dim, observation_dim=observation_dim)
        if quadrature is None:
            quadrature = NDiagGHQuadrature(self._quadrature_dim, DEFAULT_NUM_GAUSS_HERMITE_POINTS)
        self.quadrature = quadrature

    @property
    def _quadrature_dim(self) -> int:
        assert self.latent_dim is not None
        return self.latent_dim

    def _quadrature_log_prob(self, F: torch.Tensor, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """The integrand [batch..., d'] with d' = 1."""
        return self.log_prob(X, F, Y)[..., None]

    def _quadrature_reduction(self, quadrature_result: torch.Tensor) -> torch.Tensor:
        return quadrature_result.squeeze(-1)

    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return self._quadrature_reduction(
            self.quadrature.logspace(self._quadrature_log_prob, Fmu, Fvar, X=X, Y=Y)
        )

    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return self._quadrature_reduction(self.quadrature(self._quadrature_log_prob, Fmu, Fvar, X=X, Y=Y))

    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        def conditional_mean(F: torch.Tensor, X_: torch.Tensor) -> torch.Tensor:
            return self.conditional_mean(X_, F)

        def conditional_y_squared(F: torch.Tensor, X_: torch.Tensor) -> torch.Tensor:
            return self.conditional_variance(X_, F) + torch.square(self.conditional_mean(X_, F))

        E_y, E_y2 = self.quadrature([conditional_mean, conditional_y_squared], Fmu, Fvar, X_=X)
        return E_y, E_y2 - E_y ** 2


class ScalarLikelihood(QuadratureLikelihood, abc.ABC):
    """Likelihoods that act on each scalar latent independently: implement
    ``_scalar_log_prob``; ``log_prob`` sums it over the last axis, and the
    quadrature is one-dimensional, broadcast over the latents
    (``base.py:244-286``)."""

    #: an observation with a finite log density under every built-in scalar
    #: likelihood (what ``SwitchedLikelihood`` substitutes for other rows)
    safe_observation: float = 0.5

    def __init__(self, **kwargs: Any) -> None:
        super().__init__(input_dim=None, latent_dim=None, observation_dim=None, **kwargs)

    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return torch.sum(self._scalar_log_prob(X, F, Y), dim=-1)

    @abc.abstractmethod
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(y | x, f) per scalar -> [batch..., N, P]."""
        raise NotImplementedError

    @property
    def _quadrature_dim(self) -> int:
        return 1

    def _quadrature_log_prob(self, F: torch.Tensor, X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return self._scalar_log_prob(X, F, Y)

    def _quadrature_reduction(self, quadrature_result: torch.Tensor) -> torch.Tensor:
        return torch.sum(quadrature_result, dim=-1)
