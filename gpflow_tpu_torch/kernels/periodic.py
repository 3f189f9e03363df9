"""Periodic kernel (counterpart of ``gpflow_tpu/kernels/periodic.py``).

The base kernel's ``K_r``/``K_r2`` act on the sine-warped distance, which is
another function of X than the one kernel K1 computes: a Periodic kernel
never launches K1. Its [N, M, D] warp is plain PyTorch, as the JAX package
leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from ..base import Parameter, input_to_tensor
from ..bijectors import positive
from ..utilities.ops import difference_matrix
from ..utilities.shapes import check_shapes, inherit_check_shapes
from .base import ActiveDims, Kernel
from .stationaries import IsotropicStationary

__all__ = ["Periodic"]


class Periodic(Kernel):
    """Makes an IsotropicStationary base kernel periodic through the warp
    u = (cos x, sin x) (MacKay 1998; ``periodic.py:20-62``):

        K(x, x') = base.K_r(sum_d |sin(pi d_d / period) / l_d|)    (if K_r)
        K(x, x') = base.K_r2(sum_d (sin(pi d_d / period) / l_d)^2) (otherwise)

    Its active dimensions are the base kernel's.
    """

    @check_shapes(
        "period: [broadcast n_active_dims]",
    )
    def __init__(self, base_kernel: IsotropicStationary, period: Any = 1.0) -> None:
        if not isinstance(base_kernel, IsotropicStationary):
            raise TypeError("Periodic requires an IsotropicStationary kernel as the `base_kernel`")
        super().__init__()
        self.base_kernel = base_kernel
        self.period = Parameter(period, transform=positive(), name="period")
        self.base_kernel._validate_ard_active_dims(self.period)

    @property
    def active_dims(self) -> Any:
        return self.base_kernel.active_dims

    @active_dims.setter
    def active_dims(self, value: ActiveDims) -> None:
        self.base_kernel.active_dims = value

    @inherit_check_shapes
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        return self.base_kernel.K_diag(X)

    @inherit_check_shapes
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        r = math.pi * difference_matrix(X, X2) / self.period.value
        scaled_sine = torch.sin(r) / self.base_kernel.lengthscales.value
        if hasattr(self.base_kernel, "K_r"):
            return self.base_kernel.K_r(torch.sum(torch.abs(scaled_sine), dim=-1))
        return self.base_kernel.K_r2(torch.sum(torch.square(scaled_sine), dim=-1))
