"""Likelihood base classes (counterpart of ``gpflow_tpu/likelihoods/base.py``;
the closed-form statistics so far, the quadrature fallbacks wait for the
non-conjugate slice).

Shapes: the last dimension of F holds the latent functions and of Y the
observations; every statistic returns the batch shape with it reduced.
"""
from __future__ import annotations

import abc

import torch

from ..base import MeanAndVariance, Module

__all__ = ["Likelihood", "ScalarLikelihood"]


class Likelihood(Module, abc.ABC):
    """Observation model p(Y | X, F)."""

    def log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(Y | X, F) -> [batch...]."""
        return self._log_prob(X, F, Y)

    @abc.abstractmethod
    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
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


class ScalarLikelihood(Likelihood, abc.ABC):
    """Likelihoods that act on each scalar latent independently: implement
    ``_scalar_log_prob``; ``log_prob`` sums it over the last axis."""

    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return torch.sum(self._scalar_log_prob(X, F, Y), dim=-1)

    @abc.abstractmethod
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        """log p(y | x, f) per scalar -> [batch..., N, P]."""
        raise NotImplementedError
