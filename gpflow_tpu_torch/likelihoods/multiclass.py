"""Multiclass likelihoods (counterpart of
``gpflow_tpu/likelihoods/multiclass.py``): ``Softmax`` through Monte-Carlo
expectations, and ``MultiClass`` with the ``RobustMax`` link, whose
expectations are one-dimensional Gauss-Hermite sums.

Labels are Y [N, 1] of class indices 0 .. C - 1 (any float or integer
type). One-hot rows are comparisons with ``arange(C)``, never
``torch.nn.functional.one_hot``, which reads the labels on the host to check
them: a label out of range gives an all-zero row, as ``jax.nn.one_hot`` does.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Union

import numpy as np
import torch

from ..base import MeanAndVariance, Module, Parameter
from ..bijectors import Sigmoid
from ..config import default_int
from ..priors import Beta as BetaPrior
from ..quadrature.gauss_hermite import DeviceGrid
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import Likelihood, MonteCarloLikelihood

__all__ = ["MultiClass", "RobustMax", "Softmax"]


def _one_hot(labels: torch.Tensor, num_classes: int, dtype: torch.dtype) -> torch.Tensor:
    """[..., num_classes] rows of ``labels == c``; all zero out of range."""
    return (labels[..., None] == torch.arange(num_classes, device=labels.device)).to(dtype)


class Softmax(MonteCarloLikelihood):
    """The soft-max likelihood over ``num_classes`` latent functions, with
    Monte-Carlo expectations (``multiclass.py:21-51``). A label outside
    [0, C) gives a NaN log density instead of scoring another class."""

    def __init__(self, num_classes: int, **kwargs: Any) -> None:
        super().__init__(input_dim=None, latent_dim=num_classes, observation_dim=None, **kwargs)
        self.num_classes = self.latent_dim

    @inherit_check_shapes
    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        labels = Y[..., 0].to(default_int())
        log_p = torch.log_softmax(F, dim=-1)
        valid = (labels >= 0) & (labels < self.num_classes)
        safe = torch.clamp(labels, 0, self.num_classes - 1)
        picked = torch.gather(log_p, -1, safe[..., None].expand(log_p.shape[:-1] + (1,)))[..., 0]
        return torch.where(valid, picked, torch.nan)

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return torch.softmax(F, dim=-1)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        p = self.conditional_mean(X, F)
        return p - p ** 2


class RobustMax(Module):
    """The robust-max inverse link: 1 - epsilon for the largest latent
    function, epsilon / (C - 1) for each other (``multiclass.py:54-141``).
    ``epsilon`` is a Parameter in (0, 1) (a ``Sigmoid`` transform) with a
    Beta(0.2, 5) prior, not trainable (``multiclass.py:62-65``)."""

    @check_shapes(
        "epsilon: []",
    )
    def __init__(self, num_classes: int, epsilon: float = 1e-3, **kwargs: Any) -> None:
        super().__init__()
        self.epsilon = Parameter(
            epsilon, transform=Sigmoid(), prior=BetaPrior(0.2, 5.0), trainable=False, name="epsilon"
        )
        self.num_classes = num_classes
        self._squash = 1e-6

    @check_shapes(
        "F: [broadcast batch..., latent_dim]",
        "return: [batch..., latent_dim]",
    )
    def forward(self, F: torch.Tensor) -> torch.Tensor:
        # argmax over the latent (last) axis, which admits leading batch dims
        one_hot = _one_hot(torch.argmax(F, dim=-1), self.num_classes, F.dtype)
        return one_hot * (1.0 - self.epsilon.value) + (1.0 - one_hot) * self.eps_k1

    @property
    @check_shapes(
        "return: []",
    )
    def eps_k1(self) -> torch.Tensor:
        return self.epsilon.value / (self.num_classes - 1.0)

    @check_shapes(
        "val: [batch...]",
        "return: [batch...]",
    )
    def safe_sqrt(self, val: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(torch.clamp(val, min=1e-10))

    @check_shapes(
        "Y: [broadcast batch..., observation_dim]",
        "mu: [broadcast batch..., latent_dim]",
        "var: [broadcast batch..., latent_dim]",
        "gh_x: [n_quad_points]",
        "gh_w: [n_quad_points]",
        "return: [batch..., observation_dim]",
    )
    def prob_is_largest(
        self,
        Y: torch.Tensor,
        mu: torch.Tensor,
        var: torch.Tensor,
        gh_x: Union[torch.Tensor, np.ndarray],
        gh_w: Union[torch.Tensor, np.ndarray],
    ) -> torch.Tensor:
        """P(f_y = max_i f_i) for independent Gaussians f_i ~ N(mu_i, var_i)
        and the label y of each row: a Gauss-Hermite sum over f_y of the
        product of the other latents' CDFs, each squashed into
        [1e-6, 1 - 1e-6] (``multiclass.py:101-141``). mu, var [N, C] ->
        [N, 1]."""
        Yi = Y.reshape(-1).to(default_int())
        gh_x = torch.as_tensor(gh_x, dtype=mu.dtype, device=mu.device)
        gh_w = torch.as_tensor(gh_w, dtype=mu.dtype, device=mu.device)

        oh_on = _one_hot(Yi, self.num_classes, mu.dtype)  # [N, C]
        mu_selected = torch.sum(oh_on * mu, dim=1)  # [N]
        var_selected = torch.sum(oh_on * var, dim=1)

        # the Gauss-Hermite grid on the selected latent: [N, Ngh]
        X = mu_selected[:, None] + gh_x * self.safe_sqrt(2.0 * var_selected)[:, None]

        # each latent's CDF at each grid point: [N, C, Ngh]
        dist = (X[:, None, :] - mu[:, :, None]) / self.safe_sqrt(var)[:, :, None]
        cdfs = 0.5 * (1.0 + torch.special.erf(dist / math.sqrt(2.0)))
        cdfs = cdfs * (1 - 2 * self._squash) + self._squash

        # the selected latent's own CDF is left out of the product
        oh_off = 1.0 - oh_on
        cdfs = cdfs * oh_off[:, :, None] + oh_on[:, :, None]

        # the product over latents, weighted over the grid: [N, 1]. A chain
        # of products, not torch.prod, whose backward reads on the host
        # whether any factor is zero
        prod = cdfs[:, 0]
        for c in range(1, cdfs.shape[1]):
            prod = prod * cdfs[:, c]
        return prod @ (gh_w / math.sqrt(math.pi)).reshape(-1, 1)


class MultiClass(Likelihood):
    """Multiclass classification with the ``RobustMax`` link
    (``multiclass.py:144-222``): the variational expectations and the
    predictions in closed form through ``prob_is_largest`` with
    ``num_gauss_hermite_points`` = 20. The grid is placed on
    ``config.default_device()`` in float64 when the likelihood is built and
    cast there per dtype, so no step copies it from the host."""

    def __init__(self, num_classes: int, invlink: Optional[RobustMax] = None, **kwargs: Any) -> None:
        super().__init__(input_dim=None, latent_dim=num_classes, observation_dim=None, **kwargs)
        self.num_classes = num_classes
        self.num_gauss_hermite_points = 20
        if invlink is None:
            invlink = RobustMax(self.num_classes)
        if not isinstance(invlink, RobustMax):
            raise NotImplementedError("Only RobustMax invlink is supported")
        self.invlink = invlink
        self._gh = DeviceGrid(*np.polynomial.hermite.hermgauss(self.num_gauss_hermite_points))

    def _prob_is_largest(self, Y: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor) -> torch.Tensor:
        gh_x, gh_w = self._gh.grid(Fmu.device, Fmu.dtype)
        return self.invlink.prob_is_largest(Y, Fmu, Fvar, gh_x, gh_w)

    @inherit_check_shapes
    def _log_prob(self, X: torch.Tensor, F: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
        hits = torch.argmax(F, dim=1)[:, None] == Y.to(torch.int64)
        p = torch.where(hits, 1.0 - self.invlink.epsilon.value, self.invlink.eps_k1)
        return torch.sum(torch.log(p), dim=-1)

    @inherit_check_shapes
    def _variational_expectations(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        p = self._prob_is_largest(Y, Fmu, Fvar)
        ve = p * torch.log(1.0 - self.invlink.epsilon.value) + (1.0 - p) * torch.log(self.invlink.eps_k1)
        return torch.sum(ve, dim=-1)

    @inherit_check_shapes
    def _predict_mean_and_var(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor
    ) -> MeanAndVariance:
        N = Fmu.shape[0]
        ps = [
            self._predict_non_logged_density(
                X, Fmu, Fvar, torch.full((N, 1), i, dtype=torch.int64, device=Fmu.device)
            ).reshape(-1)
            for i in range(self.num_classes)
        ]
        ps = torch.stack(ps, dim=-1)  # [N, C]
        return ps, ps - torch.square(ps)

    @inherit_check_shapes
    def _predict_log_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        return torch.sum(torch.log(self._predict_non_logged_density(X, Fmu, Fvar, Y)), dim=-1)

    @check_shapes(
        "X: [broadcast batch..., input_dim]",
        "Fmu: [broadcast batch..., latent_dim]",
        "Fvar: [broadcast batch..., latent_dim]",
        "Y: [broadcast batch..., observation_dim]",
        "return: [batch..., observation_dim]",
    )
    def _predict_non_logged_density(
        self, X: torch.Tensor, Fmu: torch.Tensor, Fvar: torch.Tensor, Y: torch.Tensor
    ) -> torch.Tensor:
        p = self._prob_is_largest(Y, Fmu, Fvar)
        return p * (1.0 - self.invlink.epsilon.value) + (1.0 - p) * self.invlink.eps_k1

    @inherit_check_shapes
    def _conditional_mean(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return self.invlink(F)

    @inherit_check_shapes
    def _conditional_variance(self, X: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        p = self.conditional_mean(X, F)
        return p - torch.square(p)
