"""Kuu registrations (counterpart of ``gpflow_tpu/covariances/kuus.py``;
the (InducingPoints, Kernel) case only)."""
from __future__ import annotations

import torch

from ..inducing_variables import InducingPoints
from ..kernels import Kernel
from .dispatch import Kuu

__all__ = ["Kuu_kernel_inducingpoints"]


@Kuu.register(InducingPoints, Kernel)
def Kuu_kernel_inducingpoints(
    inducing_variable: InducingPoints, kernel: Kernel, *, jitter: float = 0.0
) -> torch.Tensor:
    """K(Z) + jitter I -> [M, M]."""
    Kzz = kernel(inducing_variable.Z.value)
    return Kzz + jitter * torch.eye(inducing_variable.num_inducing, dtype=Kzz.dtype, device=Kzz.device)
