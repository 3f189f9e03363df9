"""Kuf registrations (counterpart of ``gpflow_tpu/covariances/kufs.py``;
the (InducingPoints, Kernel) case only)."""
from __future__ import annotations

import torch

from ..inducing_variables import InducingPoints
from ..kernels import Kernel
from .dispatch import Kuf

__all__ = ["Kuf_kernel_inducingpoints"]


@Kuf.register(InducingPoints, Kernel, object)
def Kuf_kernel_inducingpoints(
    inducing_variable: InducingPoints, kernel: Kernel, Xnew: torch.Tensor
) -> torch.Tensor:
    """K(Z, Xnew) -> [M, batch..., N]."""
    return kernel(inducing_variable.Z.value, Xnew)
