"""Kuf registrations (counterpart of ``gpflow_tpu/covariances/kufs.py``).

``Kuf_conv_patch`` computes the JAX package's function in another order.
There the base kernel takes the patches as a 3-D [N, P, S] input, which the
stationary kernels serve on their plain path, and XLA fuses that path on the
TPU. Eager PyTorch would make five or more full passes over the [M, N, P]
block each way, so the port flattens the patches to [N P, S], calls the base
kernel once on 2-D inputs (K1 on the card, K2 in a Matern kernel's
backward) and reshapes the result to [M, N, P]."""
from __future__ import annotations

import torch

from ..inducing_variables import InducingPatches, InducingPoints, Multiscale
from ..kernels import Convolutional, Kernel, SquaredExponential
from ..utilities.shapes import check_shapes
from .dispatch import Kuf

__all__ = ["Kuf_conv_patch", "Kuf_kernel_inducingpoints", "Kuf_sqexp_multiscale"]


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


@Kuf.register(InducingPatches, Convolutional, object)
@check_shapes("return: [M, N]")
def Kuf_conv_patch(
    inducing_variable: InducingPatches, kernel: Convolutional, Xnew: torch.Tensor
) -> torch.Tensor:
    """The weighted patch response sum_p w_p k(z_m, x_n^[p]) / P -> [M, N]
    (``kufs.py:41-50``), through one 2-D base-kernel call on the flattened
    patches."""
    Xp = kernel.get_patches(Xnew)  # [N, P, S]
    Z = inducing_variable.Z.value
    bigKzx = kernel.base_kernel.K(Z, Xp.reshape(-1, Xp.shape[-1]))  # [M, N P]
    bigKzx = bigKzx.reshape((Z.shape[0],) + Xp.shape[:-1])  # [M, N, P]
    return torch.matmul(bigKzx, kernel.weights.value) / kernel.num_patches
