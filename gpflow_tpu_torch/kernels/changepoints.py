"""ChangePoints kernel (counterpart of ``gpflow_tpu/kernels/changepoints.py``)."""
from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
from torch import nn

from ..base import Parameter, input_to_tensor
from ..bijectors import positive
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import Combination, Kernel

__all__ = ["ChangePoints"]


class ChangePoints(Combination):
    """Fixed change-points along a 1-D input; the regimes are blended by
    logistic sigmoids sigma(x) = 1 / (1 + exp(-s (x - x0))):

        K1(x, x') (1 - sig(x)) (1 - sig(x')) + K2(x, x') sig(x) sig(x')

    (Lloyd et al. 2014; ``changepoints.py:17-119``). Each term is called with
    its own active dims, so a stationary term's K(X) on a 2-D CUDA input
    reaches K1 (and a Matern term's backward K2) at D = 1.
    """

    @check_shapes(
        "locations: [n_change_points]",
        "steepness: [broadcast n_change_points]",
    )
    def __init__(
        self,
        kernels: Sequence[Kernel],
        locations: Any,
        steepness: Any = 1.0,
        name: Optional[str] = None,
    ) -> None:
        if len(kernels) != len(locations) + 1:
            raise ValueError(
                f"Number of kernels ({len(kernels)}) must be one more than the number "
                f"of changepoint locations ({len(locations)})"
            )
        if isinstance(steepness, (list, tuple)) and len(steepness) != len(locations):
            raise ValueError(
                f"Dimension of steepness ({len(steepness)}) does not match number of "
                f"changepoint locations ({len(locations)})"
            )
        super().__init__(kernels, name=name)
        self.locations = Parameter(locations, name="locations")
        self.steepness = Parameter(steepness, transform=positive(), name="steepness")

    def _set_kernels(self, kernels: Sequence[Kernel]) -> None:
        # nested change-points are not flattened (``changepoints.py:53-55``)
        self.kernels = nn.ModuleList(kernels)

    @check_shapes(
        "X: [batch...]",
        "return: [batch..., Ncp]",
    )
    def _sigmoids(self, X: torch.Tensor) -> torch.Tensor:
        """X: [batch...] -> [batch..., Ncp], the locations sorted."""
        locations = torch.sort(self.locations.value.reshape(-1)).values
        steepness = self.steepness.value.reshape(-1)
        return torch.sigmoid(steepness * (X[..., None] - locations))

    @staticmethod
    def _check_1d(X: torch.Tensor) -> None:
        if X.shape[-1] != 1:
            raise ValueError(
                f"ChangePoints is defined for 1-dimensional inputs only; got "
                f"input dimension {X.shape[-1]}."
            )

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        self._check_1d(X)
        sig_X = self._sigmoids(X)  # [batch..., N, 1, Ncp]
        batch, N, Ncp = X.shape[:-2], X.shape[-2], sig_X.shape[-1]
        if X2 is None:
            sig_X1 = sig_X.reshape(batch + (N, 1, Ncp))
            sig_X2 = sig_X.reshape(batch + (1, N, Ncp))
            ones_shape = batch + (N, N, 1)
        else:
            self._check_1d(X2)
            batch2, N2 = X2.shape[:-2], X2.shape[-2]
            sig_X1 = sig_X.reshape(batch + (N,) + (1,) * len(batch2) + (1, Ncp))
            sig_X2 = self._sigmoids(X2).reshape((1,) * len(batch) + (1,) + batch2 + (N2, Ncp))
            ones_shape = batch + (N,) + batch2 + (N2, 1)
        starters = sig_X1 * sig_X2
        stoppers = (1 - sig_X1) * (1 - sig_X2)
        ones = torch.ones(ones_shape, dtype=starters.dtype, device=X.device)
        starters = torch.cat([ones, starters], dim=-1)
        stoppers = torch.cat([stoppers, ones], dim=-1)
        kernel_stack = torch.stack([k(X, X2) for k in self.kernels], dim=-1)
        return torch.sum(kernel_stack * starters * stoppers, dim=-1)

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        self._check_1d(X)
        batch, N = X.shape[:-2], X.shape[-2]
        sig_X = self._sigmoids(X).reshape(batch + (N, -1))  # [batch..., N, Ncp]
        ones = torch.ones(batch + (N, 1), dtype=sig_X.dtype, device=X.device)
        starters = torch.cat([ones, sig_X * sig_X], dim=-1)
        stoppers = torch.cat([(1 - sig_X) * (1 - sig_X), ones], dim=-1)
        kernel_stack = torch.stack([k(X, full_cov=False) for k in self.kernels], dim=-1)
        return torch.sum(kernel_stack * starters * stoppers, dim=-1)
