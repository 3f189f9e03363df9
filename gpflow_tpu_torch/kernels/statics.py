"""Static kernels (counterpart of ``gpflow_tpu/kernels/statics.py``)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..base import Parameter, input_to_tensor
from ..bijectors import positive
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import ActiveDims, Kernel

__all__ = ["Bias", "Constant", "Static", "White"]


class Static(Kernel):
    """Kernels that do not depend on the inputs' values; one variance
    (``statics.py:17-32``)."""

    @check_shapes(
        "variance: []",
    )
    def __init__(self, variance: Any = 1.0, active_dims: Optional[ActiveDims] = None) -> None:
        super().__init__(active_dims)
        self.variance = Parameter(variance, transform=positive(), name="variance")

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        variance = self.variance.value
        return torch.ones(X.shape[:-1], dtype=variance.dtype, device=X.device) * variance


class White(Static):
    """k(x_n, x_m) = delta(n, m) sigma^2 (``statics.py:35-46``): K(X) is
    sigma^2 I, K(X, X2) is zero."""

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        if X2 is None:
            d = self.K_diag(X)
            return d[..., :, None] * torch.eye(X.shape[-2], dtype=d.dtype, device=d.device)
        return torch.zeros(X.shape[:-1] + X2.shape[:-1], dtype=X.dtype, device=X.device)


class Constant(Static):
    """k(x, y) = sigma^2 (``statics.py:49-60``)."""

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        if X2 is None:
            shape = X.shape[:-2] + (X.shape[-2], X.shape[-2])
        else:
            shape = X.shape[:-1] + X2.shape[:-1]
        variance = self.variance.value
        return torch.ones(shape, dtype=variance.dtype, device=X.device) * variance


#: Alias of Constant (``statics.py:63``).
Bias = Constant
