"""Linear and Polynomial kernels (counterpart of ``gpflow_tpu/kernels/linears.py``).

K = X diag(v) X2^T is one matmul, left to cuBLAS as the JAX package leaves
it to XLA; no hand-written kernel covers it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..base import Parameter, input_to_tensor
from ..bijectors import positive
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import ActiveDims, Kernel

__all__ = ["Linear", "Polynomial"]


class Linear(Kernel):
    """k(x, y) = sigma^2 x . y, with an optional ARD variance
    (``linears.py:17-45``)."""

    @check_shapes(
        "variance: [broadcast n_active_dims]",
    )
    def __init__(self, variance: Any = 1.0, active_dims: Optional[ActiveDims] = None) -> None:
        super().__init__(active_dims)
        self.variance = Parameter(variance, transform=positive(), name="variance")
        self._validate_ard_active_dims(self.variance)

    @property
    def ard(self) -> bool:
        return len(self.variance.shape) > 0

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        if X2 is None:
            return torch.matmul(X * self.variance.value, X.mT)
        return torch.tensordot(X * self.variance.value, X2, dims=([-1], [-1]))

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        return torch.sum(torch.square(X) * self.variance.value, dim=-1)


class Polynomial(Linear):
    """k(x, y) = (sigma^2 x . y + offset)^degree (``linears.py:48-72``)."""

    @check_shapes(
        "variance: [broadcast n_active_dims]",
        "offset: []",
    )
    def __init__(
        self,
        degree: float = 3.0,
        variance: Any = 1.0,
        offset: Any = 1.0,
        active_dims: Optional[ActiveDims] = None,
    ) -> None:
        super().__init__(variance, active_dims)
        self.degree = float(degree)
        self.offset = Parameter(offset, transform=positive(), name="offset")

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        return (super().K(X, X2) + self.offset.value) ** self.degree

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        return (super().K_diag(X) + self.offset.value) ** self.degree
