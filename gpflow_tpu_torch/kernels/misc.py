"""ArcCosine and Coregion kernels (counterpart of ``gpflow_tpu/kernels/misc.py``)."""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..base import Parameter, input_to_tensor
from ..bijectors import positive
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import ActiveDims, Kernel

__all__ = ["ArcCosine", "Coregion"]


class ArcCosine(Kernel):
    """Arc-cosine ("neural network") kernel of orders 0, 1 and 2 (Cho and
    Saul, NIPS 2009; ``misc.py:19-132``)."""

    implemented_orders = {0, 1, 2}

    @check_shapes(
        "variance: []",
        "weight_variances: [broadcast n_active_dims]",
        "bias_variance: []",
    )
    def __init__(
        self,
        order: int = 0,
        variance: Any = 1.0,
        weight_variances: Any = 1.0,
        bias_variance: Any = 1.0,
        *,
        active_dims: Optional[ActiveDims] = None,
        name: Optional[str] = None,
    ) -> None:
        super().__init__(active_dims=active_dims, name=name)
        if order not in self.implemented_orders:
            raise ValueError("Requested kernel order is not implemented.")
        self.order = order
        self.variance = Parameter(variance, transform=positive(), name="variance")
        self.bias_variance = Parameter(bias_variance, transform=positive(), name="bias_variance")
        self.weight_variances = Parameter(weight_variances, transform=positive(), name="weight_variances")
        self._validate_ard_active_dims(self.weight_variances)

    @property
    def ard(self) -> bool:
        return len(self.weight_variances.shape) > 0

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [batch..., N]",
    )
    def _diag_weighted_product(self, X: torch.Tensor) -> torch.Tensor:
        return torch.sum(self.weight_variances.value * torch.square(X), dim=-1) + self.bias_variance.value

    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, batch2..., N2] if X2 is not None",
        "return: [batch..., N, N] if X2 is None",
    )
    def _full_weighted_product(self, X: torch.Tensor, X2: Optional[torch.Tensor]) -> torch.Tensor:
        wX = self.weight_variances.value * X
        if X2 is None:
            return torch.matmul(wX, X.mT) + self.bias_variance.value
        return torch.tensordot(wX, X2, dims=([-1], [-1])) + self.bias_variance.value

    @check_shapes(
        "theta: [any...]",
        "return: [any...]",
    )
    def _J(self, theta: torch.Tensor) -> torch.Tensor:
        """The order's J function, eqs. 4-7 of the NIPS 2009 paper."""
        if self.order == 0:
            return math.pi - theta
        if self.order == 1:
            return torch.sin(theta) + (math.pi - theta) * torch.cos(theta)
        return 3.0 * torch.sin(theta) * torch.cos(theta) + (math.pi - theta) * (1.0 + 2.0 * torch.cos(theta) ** 2)

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        X_denominator = torch.sqrt(self._diag_weighted_product(X))  # [batch..., N]
        if X2 is None:
            X2_denominator = X_denominator[..., None, :]  # [batch..., 1, N]
            X_denom = X_denominator[..., :, None]  # [batch..., N, 1]
            numerator = self._full_weighted_product(X, None)
        else:
            X2_denominator = torch.sqrt(self._diag_weighted_product(X2))  # [batch2..., N2]
            X_denom = X_denominator.reshape(X_denominator.shape + (1,) * (X2.ndim - 1))
            X2_denominator = X2_denominator.reshape((1,) * (X.ndim - 1) + X2_denominator.shape)
            numerator = self._full_weighted_product(X, X2)
        # rounding can push |cos| past 1 by more than the squash's margin:
        # clip first, then keep arccos off its endpoints
        cos_theta = torch.clamp(numerator / X_denom / X2_denominator, -1.0, 1.0)
        jitter = 1e-15
        theta = torch.arccos(jitter + (1 - 2 * jitter) * cos_theta)
        return (self.variance.value * (1.0 / math.pi) * self._J(theta)
                * X_denom ** self.order * X2_denominator ** self.order)

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        X_product = self._diag_weighted_product(X)
        const = (1.0 / math.pi) * self._J(torch.zeros((), dtype=X_product.dtype, device=X_product.device))
        return self.variance.value * const * X_product ** self.order


class Coregion(Kernel):
    """Coregionalization lookup kernel K(x, y) = B[x, y], B = W W^T +
    diag(kappa) (``misc.py:135-195``). Its input is one column of integer
    output indices stored as floats. A label outside [0, output_dim) gives
    NaN in every entry it touches, as in the JAX package; the labels become
    indices on the device (``.long()``, which truncates as the JAX package's
    cast does) and are gathered by advanced indexing, with no host read."""

    def __init__(
        self,
        output_dim: int,
        rank: int,
        *,
        active_dims: Optional[ActiveDims] = None,
        name: Optional[str] = None,
    ) -> None:
        super().__init__(active_dims=active_dims, name=name)
        self.output_dim = output_dim
        self.rank = rank
        self.W = Parameter(0.1 * np.ones((self.output_dim, self.rank)), name="W")
        self.kappa = Parameter(np.ones(self.output_dim), transform=positive(), name="kappa")

    @check_shapes("return: [P, P]")
    def output_covariance(self) -> torch.Tensor:
        W = self.W.value
        return torch.matmul(W, W.mT) + torch.diag(self.kappa.value)

    @check_shapes("return: [P]")
    def output_variance(self) -> torch.Tensor:
        return torch.sum(torch.square(self.W.value), dim=1) + self.kappa.value

    def _indices(self, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(clipped indices, per-row validity)."""
        Xi = X[..., 0].long()
        valid = (Xi >= 0) & (Xi < self.output_dim)
        return torch.clamp(Xi, 0, self.output_dim - 1), valid

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        B = self.output_covariance()  # [O, O]
        Xi, v1 = self._indices(X)  # [batch..., N]
        if X2 is None:
            out = B[Xi[..., :, None], Xi[..., None, :]]
            valid = v1[..., :, None] & v1[..., None, :]
        else:
            X2i, v2 = self._indices(X2)  # [batch2..., N2]
            idx1 = Xi.reshape(Xi.shape + (1,) * X2i.ndim)
            idx2 = X2i.reshape((1,) * Xi.ndim + X2i.shape)
            out = B[idx1, idx2]  # [batch..., N, batch2..., N2]
            valid = v1.reshape(idx1.shape) & v2.reshape(idx2.shape)
        return torch.where(valid, out, torch.full_like(out, float("nan")))

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        Xi, valid = self._indices(X)
        out = self.output_variance()[Xi]
        return torch.where(valid, out, torch.full_like(out, float("nan")))
