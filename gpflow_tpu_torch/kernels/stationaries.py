"""Stationary kernels (counterpart of ``gpflow_tpu/kernels/stationaries.py``).

``K`` of SquaredExponential, RationalQuadratic, Exponential and Matern
1/2, 3/2, 5/2 on a 2-D CUDA float32/bfloat16 input goes to kernel K1, with
its gradient through K2 or the saved K
(``gpflow_tpu_torch.ops.pallas_distance``); every other input takes the
PyTorch path through ``square_distance`` and ``K_r2``. Routing is by exact
type, so a subclass that overrides ``K_r``/``K_r2`` keeps its own math, and
``Cosine`` (an ``AnisotropicStationary``) never reaches K1.
"""
from __future__ import annotations

from typing import Any, Optional

import math

import torch

from ..base import Parameter, input_to_tensor
from ..bijectors import positive
from ..ops.pallas_distance import _routes_to_kernel, stationary_kernel_matrix
from ..utilities.ops import difference_matrix, square_distance
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import Kernel

__all__ = [
    "AnisotropicStationary",
    "Cosine",
    "Exponential",
    "IsotropicStationary",
    "Matern12",
    "Matern32",
    "Matern52",
    "RationalQuadratic",
    "SquaredExponential",
    "Stationary",
]


class Stationary(Kernel):
    """Base of kernels of d = x - x'; holds the variance and (ARD) lengthscales."""

    @check_shapes(
        "variance: []",
        "lengthscales: [broadcast n_active_dims]",
    )
    def __init__(self, variance: Any = 1.0, lengthscales: Any = 1.0, **kwargs: Any) -> None:
        for kwarg in kwargs:
            if kwarg not in {"name", "active_dims"}:
                raise TypeError(f"Unknown keyword argument: {kwarg}")
        super().__init__(**kwargs)
        self.variance = Parameter(variance, transform=positive(), name="variance")
        self.lengthscales = Parameter(lengthscales, transform=positive(), name="lengthscales")
        self._validate_ard_active_dims(self.lengthscales)

    @property
    def ard(self) -> bool:
        return len(self.lengthscales.shape) > 0

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [batch..., N, D]",
    )
    def scale(self, X: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return X / self.lengthscales.value if X is not None else X

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        variance = self.variance.value
        return torch.full(X.shape[:-1], 1.0, dtype=variance.dtype, device=X.device) * variance


class IsotropicStationary(Stationary):
    """Kernels of r = ||x - x'||; subclasses implement ``K_r2`` or ``K_r``
    (r with its square root clipped at 1e-36, as the JAX package does)."""

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        family = _PALLAS_EXACT_TYPES.get(type(self))
        if (family is not None and _routes_to_kernel(X)
                and X.ndim == 2 and (X2 is None or X2.ndim == 2)):
            Z = X if X2 is None else X2
            alpha = self.alpha.value if family == "rq" else None
            return stationary_kernel_matrix(
                X, Z, self.lengthscales.value, self.variance.value, family, alpha=alpha
            )
        return self.K_r2(self.scaled_squared_euclid_dist(X, X2))

    @check_shapes(
        "r2: [batch...]",
        "return: [batch...]",
    )
    def K_r2(self, r2: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "K_r"):
            return self.K_r(torch.sqrt(torch.clamp(r2, min=1e-36)))
        raise NotImplementedError

    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, batch2..., N2] if X2 is not None",
        "return: [batch..., N, N] if X2 is None",
    )
    def scaled_squared_euclid_dist(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return square_distance(self.scale(X), self.scale(X2))


class AnisotropicStationary(Stationary):
    """Kernels of d = (x - x') / l, through ``K_d`` on the scaled difference
    matrix (``stationaries.py:119-158``). ARD lengthscales may be negative
    here, so they are left unconstrained."""

    @check_shapes(
        "variance: []",
        "lengthscales: [broadcast n_active_dims]",
    )
    def __init__(self, variance: Any = 1.0, lengthscales: Any = 1.0, **kwargs: Any) -> None:
        super().__init__(variance, lengthscales, **kwargs)
        if self.ard:
            self.lengthscales = Parameter(self.lengthscales.value.detach(), name="lengthscales")

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        return self.K_d(self.scaled_difference_matrix(X, X2))

    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, batch2..., N2, D] if X2 is not None",
        "return: [batch..., N, N, D] if X2 is None",
    )
    def scaled_difference_matrix(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        return difference_matrix(self.scale(X), self.scale(X2))

    @check_shapes(
        "d: [batch..., N, D]",
        "return: [batch..., N]",
    )
    def K_d(self, d: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class SquaredExponential(IsotropicStationary):
    """RBF: k(r) = sigma^2 exp(-r^2 / 2)."""

    @inherit_check_shapes
    def K_r2(self, r2: torch.Tensor) -> torch.Tensor:
        return self.variance.value * torch.exp(-0.5 * r2)


class RationalQuadratic(IsotropicStationary):
    """k(r) = sigma^2 (1 + r^2 / (2 alpha))^(-alpha)."""

    def __init__(
        self,
        variance: Any = 1.0,
        lengthscales: Any = 1.0,
        alpha: Any = 1.0,
        active_dims: Any = None,
    ) -> None:
        super().__init__(variance=variance, lengthscales=lengthscales, active_dims=active_dims)
        self.alpha = Parameter(alpha, transform=positive(), name="alpha")

    @inherit_check_shapes
    def K_r2(self, r2: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.value
        return self.variance.value * (1 + 0.5 * r2 / alpha) ** (-alpha)


class Exponential(IsotropicStationary):
    """k(r) = sigma^2 exp(-r / 2)."""

    @check_shapes(
        "r: [batch...]",
        "return: [batch...]",
    )
    def K_r(self, r: torch.Tensor) -> torch.Tensor:
        return self.variance.value * torch.exp(-0.5 * r)


class Matern12(IsotropicStationary):
    """k(r) = sigma^2 exp(-r)."""

    @check_shapes(
        "r: [batch...]",
        "return: [batch...]",
    )
    def K_r(self, r: torch.Tensor) -> torch.Tensor:
        return self.variance.value * torch.exp(-r)


class Matern32(IsotropicStationary):
    """k(r) = sigma^2 (1 + sqrt3 r) exp(-sqrt3 r)."""

    @check_shapes(
        "r: [batch...]",
        "return: [batch...]",
    )
    def K_r(self, r: torch.Tensor) -> torch.Tensor:
        sqrt3 = math.sqrt(3.0)
        return self.variance.value * (1.0 + sqrt3 * r) * torch.exp(-sqrt3 * r)


class Matern52(IsotropicStationary):
    """k(r) = sigma^2 (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r)."""

    @check_shapes(
        "r: [batch...]",
        "return: [batch...]",
    )
    def K_r(self, r: torch.Tensor) -> torch.Tensor:
        sqrt5 = math.sqrt(5.0)
        return self.variance.value * (1.0 + sqrt5 * r + 5.0 / 3.0 * torch.square(r)) * torch.exp(-sqrt5 * r)


class Cosine(AnisotropicStationary):
    """k(d) = sigma^2 cos(2 pi sum_i d_i) (``stationaries.py:240-245``)."""

    @inherit_check_shapes
    def K_d(self, d: torch.Tensor) -> torch.Tensor:
        return self.variance.value * torch.cos(2 * math.pi * torch.sum(d, dim=-1))


# Kernels whose K matrix K1 computes on the card, keyed by EXACT type
# (``gpflow_tpu/kernels/stationaries.py:252-259``).
_PALLAS_EXACT_TYPES = {
    SquaredExponential: "rbf",
    RationalQuadratic: "rq",
    Exponential: "exponential",
    Matern12: "matern12",
    Matern32: "matern32",
    Matern52: "matern52",
}
