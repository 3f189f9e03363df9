"""Multioutput Kuf registrations (counterpart of
``gpflow_tpu/covariances/multioutput/kufs.py``): [M, P, N, P] for the fully
correlated route, [M, N] for shared inducing points and a shared kernel,
[L, M, N] stacked over the latent GPs, and [M, L, N, P] for a
``LinearCoregionalization`` on the fallback route."""
from __future__ import annotations

from typing import Callable, Union

import torch

from ...inducing_variables import (
    FallbackSeparateIndependentInducingVariables,
    FallbackSharedIndependentInducingVariables,
    InducingPoints,
    SeparateIndependentInducingVariables,
    SharedIndependentInducingVariables,
)
from ...kernels import (
    LinearCoregionalization,
    MultioutputKernel,
    SeparateIndependent,
    SharedIndependent,
)
from ...utilities.shapes import check_shapes
from ..dispatch import Kuf

__all__ = [
    "Kuf_fallback_separate_linear_coregionalization",
    "Kuf_fallback_shared_linear_coregionalization",
    "Kuf_generic",
    "Kuf_separate_linear_coregionalization",
    "Kuf_separate_separate",
    "Kuf_separate_shared",
    "Kuf_shared_linear_coregionalization",
    "Kuf_shared_separate",
    "Kuf_shared_shared",
]


@Kuf.register(InducingPoints, MultioutputKernel, object)
@check_shapes("Xnew: [N, D]", "return: [M, P, N, P]")
def Kuf_generic(inducing_variable: InducingPoints, kernel: MultioutputKernel, Xnew: torch.Tensor) -> torch.Tensor:
    """Fully correlated [M, P, N, P] (``kufs.py:40-46``)."""
    return kernel(inducing_variable.Z.value, Xnew, full_cov=True, full_output_cov=True)


@Kuf.register(SharedIndependentInducingVariables, SharedIndependent, object)
@check_shapes("Xnew: [batch..., N, D]", "return: [M, batch..., N]")
def Kuf_shared_shared(
    inducing_variable: SharedIndependentInducingVariables, kernel: SharedIndependent, Xnew: torch.Tensor
) -> torch.Tensor:
    """[M, N] (``kufs.py:49-57``)."""
    return Kuf(inducing_variable.inducing_variable, kernel.kernel, Xnew)


@Kuf.register(SeparateIndependentInducingVariables, SharedIndependent, object)
@check_shapes("Xnew: [batch..., N, D]", "return: [L, M, batch..., N]")
def Kuf_separate_shared(
    inducing_variable: SeparateIndependentInducingVariables, kernel: SharedIndependent, Xnew: torch.Tensor
) -> torch.Tensor:
    """[L, M, N] (``kufs.py:60-70``)."""
    return torch.stack([Kuf(f, kernel.kernel, Xnew) for f in inducing_variable.inducing_variable_list], dim=0)


@Kuf.register(SharedIndependentInducingVariables, SeparateIndependent, object)
@check_shapes("Xnew: [batch..., N, D]", "return: [L, M, batch..., N]")
def Kuf_shared_separate(
    inducing_variable: SharedIndependentInducingVariables, kernel: SeparateIndependent, Xnew: torch.Tensor
) -> torch.Tensor:
    """[L, M, N] (``kufs.py:73-83``)."""
    return torch.stack([Kuf(inducing_variable.inducing_variable, k, Xnew) for k in kernel.kernels], dim=0)


def _kuf_pairs(inducing_variable: FallbackSeparateIndependentInducingVariables, kernel, Xnew: torch.Tensor) -> torch.Tensor:
    """[L, M, N]: latent kernel l against inducing set l."""
    n_iv = len(inducing_variable.inducing_variable_list)
    n_k = len(kernel.kernels)
    assert n_iv == n_k, f"Must have same number of inducing variables and kernels. Found {n_iv} and {n_k}."
    return torch.stack(
        [Kuf(f, k, Xnew) for f, k in zip(inducing_variable.inducing_variable_list, kernel.kernels)], dim=0
    )


@Kuf.register(SeparateIndependentInducingVariables, SeparateIndependent, object)
@check_shapes("Xnew: [batch..., N, D]", "return: [L, M, batch..., N]")
def Kuf_separate_separate(
    inducing_variable: SeparateIndependentInducingVariables, kernel: SeparateIndependent, Xnew: torch.Tensor
) -> torch.Tensor:
    """[L, M, N] (``kufs.py:86-102``)."""
    return _kuf_pairs(inducing_variable, kernel, Xnew)


def _fallback_Kuf(
    kuf_impl: Callable[..., torch.Tensor],
    inducing_variable: Union[FallbackSeparateIndependentInducingVariables, FallbackSharedIndependentInducingVariables],
    kernel: LinearCoregionalization,
    Xnew: torch.Tensor,
) -> torch.Tensor:
    """[M, L, N, P] = Kuf_latent[:, l, :, None] * W[None, l, None, :]
    (``kufs.py:105-117``)."""
    K = kuf_impl(inducing_variable, kernel, Xnew).permute(1, 0, 2)  # [M, L, N]
    return K[:, :, :, None] * kernel.W.value.mT[None, :, None, :]


@Kuf.register(FallbackSeparateIndependentInducingVariables, LinearCoregionalization, object)
@check_shapes("Xnew: [N, D]", "return: [M, L, N, P]")
def Kuf_fallback_separate_linear_coregionalization(
    inducing_variable: FallbackSeparateIndependentInducingVariables,
    kernel: LinearCoregionalization,
    Xnew: torch.Tensor,
) -> torch.Tensor:
    """[M, L, N, P] (``kufs.py:120-128``)."""
    return _fallback_Kuf(Kuf_separate_linear_coregionalization, inducing_variable, kernel, Xnew)


@Kuf.register(FallbackSharedIndependentInducingVariables, LinearCoregionalization, object)
@check_shapes("Xnew: [N, D]", "return: [M, L, N, P]")
def Kuf_fallback_shared_linear_coregionalization(
    inducing_variable: FallbackSharedIndependentInducingVariables,
    kernel: LinearCoregionalization,
    Xnew: torch.Tensor,
) -> torch.Tensor:
    """[M, L, N, P] (``kufs.py:131-139``)."""
    return _fallback_Kuf(Kuf_shared_linear_coregionalization, inducing_variable, kernel, Xnew)


@Kuf.register(SharedIndependentInducingVariables, LinearCoregionalization, object)
@check_shapes("Xnew: [batch..., N, D]", "return: [L, M, batch..., N]")
def Kuf_shared_linear_coregionalization(
    inducing_variable: SharedIndependentInducingVariables, kernel: LinearCoregionalization, Xnew: torch.Tensor
) -> torch.Tensor:
    """[L, M, N] (``kufs.py:142-152``)."""
    return torch.stack([Kuf(inducing_variable.inducing_variable, k, Xnew) for k in kernel.kernels], dim=0)


@Kuf.register(SeparateIndependentInducingVariables, LinearCoregionalization, object)
@check_shapes("Xnew: [batch..., N, D]", "return: [L, M, batch..., N]")
def Kuf_separate_linear_coregionalization(
    inducing_variable: SeparateIndependentInducingVariables, kernel: LinearCoregionalization, Xnew: torch.Tensor
) -> torch.Tensor:
    """[L, M, N] (``kufs.py:155-171``)."""
    return _kuf_pairs(inducing_variable, kernel, Xnew)
