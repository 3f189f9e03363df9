"""Discrete scalar likelihoods (counterpart of
``gpflow_tpu/likelihoods/scalar_discrete.py``)."""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch

from .. import logdensities
from ..base import MeanAndVariance, Parameter
from ..bijectors import positive
from ..config import default_device, default_float
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import ScalarLikelihood
from .utils import inv_probit

__all__ = ["Bernoulli", "Ordinal", "Poisson"]


class Poisson(ScalarLikelihood):
    """p(y | f) = Poisson(y | invlink(f) * binsize) (``scalar_discrete.py:23-61``).
    With ``invlink`` ``torch.exp`` the variational expectations are in
    closed form; any other invlink goes through the quadrature."""

    def __init__(
        self,
        invlink: Callable[[torch.Tensor], torch.Tensor] = torch.exp,
        binsize: float = 1.0,
        **kwargs: Any,
    ) -> None:
        super().__init__(**kwargs)
        self.invlink = invlink
        self.binsize = float(binsize)

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.poisson(Y, self.invlink(F) * self.binsize)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.invlink(F) * self.binsize

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.invlink(F) * self.binsize

    @inherit_check_shapes
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        if self.invlink is torch.exp:
            return torch.sum(
                Y * Fmu
                - torch.exp(Fmu + Fvar / 2) * self.binsize
                - torch.lgamma(Y + 1)
                + Y * math.log(self.binsize),
                dim=-1,
            )
        return super()._variational_expectations(X, Fmu, Fvar, Y)


class Bernoulli(ScalarLikelihood):
    """Binary classification, probit link by default
    (``scalar_discrete.py:64-101``). With the probit link the predictive
    mean is in closed form, p = inv_probit(Fmu / sqrt(1 + Fvar))."""

    def __init__(self, invlink: Callable[[torch.Tensor], torch.Tensor] = inv_probit, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.invlink = invlink

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        return logdensities.bernoulli(Y, self.invlink(F))

    @inherit_check_shapes
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        if self.invlink is inv_probit:
            p = inv_probit(Fmu / torch.sqrt(1 + Fvar))
            return p, p - torch.square(p)
        return super()._predict_mean_and_var(X, Fmu, Fvar)

    @inherit_check_shapes
    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        p = self.predict_mean_and_var(X, Fmu, Fvar)[0]
        return torch.sum(logdensities.bernoulli(Y, p), dim=-1)

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.invlink(F)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        p = self.conditional_mean(X, F)
        return p - (p ** 2)


class Ordinal(ScalarLikelihood):
    """Ordinal regression through bin edges and a probit link (Chu and
    Ghahramani 2005; ``scalar_discrete.py:104-167``). Labels are the
    integers 0 .. num_bins - 1; a label outside that range gives a NaN log
    density, so mislabelled data fails loudly. ``sigma`` is a positive
    Parameter."""

    @check_shapes(
        "bin_edges: [num_bins_minus_1]",
    )
    def __init__(self, bin_edges: np.ndarray, **kwargs: Any) -> None:
        super().__init__(**kwargs)
        self.register_buffer(
            "bin_edges", torch.as_tensor(np.asarray(bin_edges), dtype=default_float(), device=default_device())
        )
        self.num_bins = int(np.asarray(bin_edges).size) + 1
        self.sigma = Parameter(1.0, transform=positive(), name="sigma")

    def _scaled_bins(self):
        """(left, right) edges over sigma for each label, [num_bins] each."""
        scaled = self.bin_edges / self.sigma.value
        inf = torch.full((1,), math.inf, dtype=scaled.dtype, device=scaled.device)
        return torch.cat([scaled, inf], 0), torch.cat([-inf, scaled], 0)

    @inherit_check_shapes
    def _scalar_log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        Y = Y.to(torch.int64)
        left, right = self._scaled_bins()
        valid = (Y >= 0) & (Y < self.num_bins)
        safe_Y = torch.clamp(Y, 0, self.num_bins - 1)
        sigma = self.sigma.value
        logp = torch.log(inv_probit(left[safe_Y] - F / sigma) - inv_probit(right[safe_Y] - F / sigma) + 1e-6)
        return torch.where(valid, logp, math.nan)

    @check_shapes(
        "F: [batch..., latent_dim]",
        "return: [batch_and_latent_dim, num_bins]",
    )
    def _make_phi(self, F: torch.Tensor) -> torch.Tensor:
        """The [flattened batch, num_bins] matrix of bin probabilities
        (``scalar_discrete.py:139-153``)."""
        left, right = self._scaled_bins()
        F = F.reshape(-1, 1) / self.sigma.value
        return inv_probit(left - F) - inv_probit(right - F)

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        phi = self._make_phi(F)
        Ys = torch.arange(self.num_bins, dtype=phi.dtype, device=phi.device).reshape(-1, 1)
        return torch.reshape(phi @ Ys, F.shape)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        phi = self._make_phi(F)
        Ys = torch.arange(self.num_bins, dtype=phi.dtype, device=phi.device).reshape(-1, 1)
        E_y = phi @ Ys
        E_y2 = phi @ (Ys ** 2)
        return torch.reshape(E_y2 - E_y ** 2, F.shape)
