"""Likelihood base classes (counterpart of ``gpflow_tpu/likelihoods/base.py``;
the predictive mean and variance only so far)."""
from __future__ import annotations

import abc

import torch

from ..base import MeanAndVariance, Module

__all__ = ["Likelihood", "ScalarLikelihood"]


class Likelihood(Module, abc.ABC):
    """Observation model p(Y | X, F)."""

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


class ScalarLikelihood(Likelihood, abc.ABC):
    """Likelihoods that act on each scalar latent independently."""
