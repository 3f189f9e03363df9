"""Kuf registrations (counterpart of ``gpflow_tpu/covariances/kufs.py``;
the (InducingPatches, Convolutional) case waits for the Convolutional
kernel)."""
from __future__ import annotations

import torch

from ..inducing_variables import InducingPoints, Multiscale
from ..kernels import Kernel, SquaredExponential
from ..utilities.shapes import check_shapes
from .dispatch import Kuf

__all__ = ["Kuf_kernel_inducingpoints", "Kuf_sqexp_multiscale"]


@Kuf.register(InducingPoints, Kernel, object)
@check_shapes("Xnew: [batch..., N, D]", "return: [M, batch..., N]")
def Kuf_kernel_inducingpoints(
    inducing_variable: InducingPoints, kernel: Kernel, Xnew: torch.Tensor
) -> torch.Tensor:
    """K(Z, Xnew) -> [M, batch..., N]."""
    return kernel(inducing_variable.Z.value, Xnew)


@Kuf.register(Multiscale, SquaredExponential, object)
@check_shapes("Xnew: [N, D]", "return: [M, N]")
def Kuf_sqexp_multiscale(
    inducing_variable: Multiscale, kernel: SquaredExponential, Xnew: torch.Tensor
) -> torch.Tensor:
    """The multiscale RBF's cross covariance (``kufs.py:47-60``)."""
    Xnew, _ = kernel.slice(Xnew, None)
    Zmu, Zlen = kernel.slice(inducing_variable.Z.value, inducing_variable.scales.value)
    lengthscales = kernel.lengthscales.value
    idlengthscales = lengthscales + Zlen
    d = inducing_variable._cust_square_dist(Xnew, Zmu, idlengthscales[None, :, :])
    scale = torch.prod(lengthscales / idlengthscales, 1).reshape(1, -1)
    return (kernel.variance.value * torch.exp(-0.5 * d) * scale).mT
