"""Stationary kernels (counterpart of ``gpflow_tpu/kernels/stationaries.py``).

``SquaredExponential.K`` on a CUDA float32/bfloat16 input goes to kernel K1
(``gpflow_tpu_torch.ops.pallas_distance``); every other input takes the
PyTorch path through ``square_distance`` and ``K_r2``. Routing is by exact
type, so a subclass that overrides ``K_r2`` keeps its own math.
"""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..base import Parameter
from ..bijectors import positive
from ..ops.pallas_distance import pallas_available, stationary_kernel_matrix
from ..utilities.ops import square_distance
from .base import Kernel

__all__ = ["IsotropicStationary", "SquaredExponential", "Stationary"]


class Stationary(Kernel):
    """Base of kernels of d = x - x'; holds the variance and (ARD) lengthscales."""

    def __init__(self, variance: Any = 1.0, lengthscales: Any = 1.0, **kwargs: Any) -> None:
        for kwarg in kwargs:
            if kwarg not in {"name", "active_dims"}:
                raise TypeError(f"Unknown keyword argument: {kwarg}")
        super().__init__(**kwargs)
        self.variance = Parameter(variance, transform=positive(), name="variance")
        self.lengthscales = Parameter(lengthscales, transform=positive(), name="lengthscales")
        self._validate_ard_active_dims(self.lengthscales)

    def scale(self, X: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return X / self.lengthscales.value if X is not None else X

    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        variance = self.variance.value
        return torch.full(X.shape[:-1], 1.0, dtype=variance.dtype, device=X.device) * variance


class IsotropicStationary(Stationary):
    """Kernels of r = ||x - x'||; subclasses implement ``K_r2``."""

    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        family = _PALLAS_EXACT_TYPES.get(type(self))
        if (family is not None and pallas_available(X)
                and X.ndim == 2 and (X2 is None or X2.ndim == 2)):
            Z = X if X2 is None else X2
            return stationary_kernel_matrix(
                X, Z, self.lengthscales.value, self.variance.value, family
            )
        return self.K_r2(self.scaled_squared_euclid_dist(X, X2))

    def K_r2(self, r2: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def scaled_squared_euclid_dist(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return square_distance(self.scale(X), self.scale(X2))


class SquaredExponential(IsotropicStationary):
    """RBF: k(r) = sigma^2 exp(-r^2 / 2)."""

    def K_r2(self, r2: torch.Tensor) -> torch.Tensor:
        return self.variance.value * torch.exp(-0.5 * r2)


# Kernels whose K matrix K1 computes on the card, keyed by EXACT type. The
# other families of K1 join with their kernel classes (ROADMAP.md).
_PALLAS_EXACT_TYPES = {SquaredExponential: "rbf"}
