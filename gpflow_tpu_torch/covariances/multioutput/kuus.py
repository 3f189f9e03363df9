"""Multioutput Kuu registrations (counterpart of
``gpflow_tpu/covariances/multioutput/kuus.py``): [M, P, M, P] for the
fully correlated route, [M, M] for shared inducing points and a shared
kernel, [L, M, M] stacked over the latent GPs otherwise."""
from __future__ import annotations

from typing import Union

import torch

from ...inducing_variables import (
    FallbackSeparateIndependentInducingVariables,
    FallbackSharedIndependentInducingVariables,
    InducingPoints,
)
from ...kernels import (
    IndependentLatent,
    LinearCoregionalization,
    MultioutputKernel,
    SeparateIndependent,
    SharedIndependent,
)
from ...utilities.shapes import check_shapes
from ..dispatch import Kuu

__all__ = [
    "Kuu_fallbace_separate",
    "Kuu_fallback_separate",
    "Kuu_fallback_separate_shared",
    "Kuu_fallback_shared",
    "Kuu_generic",
    "Kuu_shared_shared",
]


def _add_jitter(Kmm: torch.Tensor, jitter: float, M: int) -> torch.Tensor:
    """Kmm [L, M, M] + jitter I on each of the L blocks."""
    return Kmm + torch.eye(M, dtype=Kmm.dtype, device=Kmm.device)[None, :, :] * jitter


@Kuu.register(InducingPoints, MultioutputKernel)
@check_shapes("return: [M, P, M, P]")
def Kuu_generic(
    inducing_variable: InducingPoints, kernel: MultioutputKernel, *, jitter: float = 0.0
) -> torch.Tensor:
    """Fully correlated [M, P, M, P] (``kuus.py:35-44``)."""
    Kmm = kernel(inducing_variable.Z.value, full_cov=True, full_output_cov=True)
    M = Kmm.shape[0] * Kmm.shape[1]
    return Kmm + jitter * torch.eye(M, dtype=Kmm.dtype, device=Kmm.device).reshape(Kmm.shape)


@Kuu.register(FallbackSharedIndependentInducingVariables, SharedIndependent)
@check_shapes("return: [M, M]")
def Kuu_shared_shared(
    inducing_variable: FallbackSharedIndependentInducingVariables,
    kernel: SharedIndependent,
    *,
    jitter: float = 0.0,
) -> torch.Tensor:
    """[M, M] (``kuus.py:47-57``)."""
    Kmm = Kuu(inducing_variable.inducing_variable, kernel.kernel)
    return Kmm + jitter * torch.eye(inducing_variable.num_inducing, dtype=Kmm.dtype, device=Kmm.device)


@check_shapes("return: [L, M, M]")
def _kuu_fallback_shared(
    inducing_variable: FallbackSharedIndependentInducingVariables,
    kernel: Union[SeparateIndependent, IndependentLatent],
    *,
    jitter: float = 0.0,
) -> torch.Tensor:
    """[L, M, M]: each latent kernel on the shared inducing points
    (``kuus.py:60-77``)."""
    Kmm = torch.stack([Kuu(inducing_variable.inducing_variable, k) for k in kernel.kernels], dim=0)
    return _add_jitter(Kmm, jitter, inducing_variable.num_inducing)


Kuu_fallback_shared = _kuu_fallback_shared
Kuu.add((FallbackSharedIndependentInducingVariables, SeparateIndependent), _kuu_fallback_shared)
Kuu.add((FallbackSharedIndependentInducingVariables, IndependentLatent), _kuu_fallback_shared)


@Kuu.register(FallbackSeparateIndependentInducingVariables, SharedIndependent)
@check_shapes("return: [L, M, M]")
def Kuu_fallback_separate_shared(
    inducing_variable: FallbackSeparateIndependentInducingVariables,
    kernel: SharedIndependent,
    *,
    jitter: float = 0.0,
) -> torch.Tensor:
    """[L, M, M]: the shared kernel on each set of inducing points
    (``kuus.py:80-92``)."""
    Kmm = torch.stack([Kuu(f, kernel.kernel) for f in inducing_variable.inducing_variable_list], dim=0)
    return _add_jitter(Kmm, jitter, inducing_variable.num_inducing)


@check_shapes("return: [L, M, M]")
def _kuu_fallback_separate(
    inducing_variable: FallbackSeparateIndependentInducingVariables,
    kernel: Union[SeparateIndependent, LinearCoregionalization],
    *,
    jitter: float = 0.0,
) -> torch.Tensor:
    """[L, M, M]: latent kernel l on inducing set l (``kuus.py:95-114``)."""
    n_iv = len(inducing_variable.inducing_variable_list)
    n_k = len(kernel.kernels)
    assert n_iv == n_k, f"Must have same number of inducing variables and kernels. Found {n_iv} and {n_k}."
    Kmm = torch.stack(
        [Kuu(f, k) for f, k in zip(inducing_variable.inducing_variable_list, kernel.kernels)], dim=0
    )
    return _add_jitter(Kmm, jitter, inducing_variable.num_inducing)


Kuu_fallback_separate = _kuu_fallback_separate
# the JAX package exports this registration under a typo'd name too
# (``kuus.py:117-122``)
Kuu_fallbace_separate = _kuu_fallback_separate
Kuu.add((FallbackSeparateIndependentInducingVariables, SeparateIndependent), _kuu_fallback_separate)
Kuu.add((FallbackSeparateIndependentInducingVariables, LinearCoregionalization), _kuu_fallback_separate)
