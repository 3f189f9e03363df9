"""Kuu registrations (counterpart of ``gpflow_tpu/covariances/kuus.py``)."""
from __future__ import annotations

import torch

from ..inducing_variables import InducingPatches, InducingPoints, Multiscale
from ..kernels import Convolutional, Kernel, SquaredExponential
from ..utilities.shapes import check_shapes
from .dispatch import Kuu

__all__ = ["Kuu_conv_patch", "Kuu_kernel_inducingpoints", "Kuu_sqexp_multiscale"]


@Kuu.register(InducingPoints, Kernel)
@check_shapes("return: [M, M]")
def Kuu_kernel_inducingpoints(
    inducing_variable: InducingPoints, kernel: Kernel, *, jitter: float = 0.0
) -> torch.Tensor:
    """K(Z) + jitter I -> [M, M]."""
    Kzz = kernel(inducing_variable.Z.value)
    return Kzz + jitter * torch.eye(inducing_variable.num_inducing, dtype=Kzz.dtype, device=Kzz.device)


@Kuu.register(Multiscale, SquaredExponential)
@check_shapes("return: [M, M]")
def Kuu_sqexp_multiscale(
    inducing_variable: Multiscale, kernel: SquaredExponential, *, jitter: float = 0.0
) -> torch.Tensor:
    """The multiscale RBF's closed form (``kuus.py:37-53``)."""
    Zmu, Zlen = kernel.slice(inducing_variable.Z.value, inducing_variable.scales.value)
    lengthscales = kernel.lengthscales.value
    idlengthscales2 = torch.square(lengthscales + Zlen)
    sc = torch.sqrt(idlengthscales2[None, ...] + idlengthscales2[:, None, ...] - lengthscales ** 2)
    d = inducing_variable._cust_square_dist(Zmu, Zmu, sc)
    Kzz = kernel.variance.value * torch.exp(-d / 2) * torch.prod(lengthscales / sc, 2)
    return Kzz + jitter * torch.eye(inducing_variable.num_inducing, dtype=Kzz.dtype, device=Kzz.device)


@Kuu.register(InducingPatches, Convolutional)
@check_shapes("return: [M, M]")
def Kuu_conv_patch(
    inducing_variable: InducingPatches, kernel: Convolutional, *, jitter: float = 0.0
) -> torch.Tensor:
    """The base kernel's K(Z) + jitter I in patch space -> [M, M]
    (``kuus.py:44-52``); on 2-D CUDA float32 patches, K1."""
    Kzz = kernel.base_kernel.K(inducing_variable.Z.value)
    return Kzz + jitter * torch.eye(inducing_variable.num_inducing, dtype=Kzz.dtype, device=Kzz.device)
