"""Multioutput conditional registrations (counterpart of
``gpflow_tpu/conditionals/multioutput/conditionals.py``): each takes the
fused route of the posterior class its (inducing variable, kernel) pair
selects."""
from __future__ import annotations

from typing import Any, Optional, Type

import torch

from ...base import MeanAndVariance
from ...utilities.shapes import check_shapes
from ...inducing_variables import (
    FallbackSeparateIndependentInducingVariables,
    InducingVariables,
    FallbackSharedIndependentInducingVariables,
    InducingPoints,
    SeparateIndependentInducingVariables,
    SharedIndependentInducingVariables,
)
from ...kernels import (
    IndependentLatent,
    Kernel,
    LinearCoregionalization,
    MultioutputKernel,
    SeparateIndependent,
    SharedIndependent,
)
from ... import posteriors  # its classes are read at call time: posteriors imports this package
from ..dispatch import conditional

__all__ = [
    "coregionalization_conditional",
    "fallback_independent_latent_conditional",
    "inducing_point_conditional",
    "separate_independent_conditional",
    "shared_independent_conditional",
]


def _posterior_fused(
    posterior_class: Type[Any],
    Xnew: torch.Tensor,
    inducing_variable: InducingVariables,
    kernel: Kernel,
    f: torch.Tensor,
    q_sqrt: Optional[torch.Tensor],
    white: bool,
    full_cov: bool,
    full_output_cov: bool,
) -> MeanAndVariance:
    posterior = posterior_class(
        kernel, inducing_variable, f, q_sqrt,
        whiten=white, mean_function=None, precompute_cache=None,
    )
    return posterior.fused_predict_f(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)


@conditional.register(object, SharedIndependentInducingVariables, SharedIndependent, object)
@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_L...]",
    "f: [M, L]",
    "return[0]: [batch..., N, P]",
    "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
    "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
    "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
)
def shared_independent_conditional(
    Xnew: torch.Tensor,
    inducing_variable: SharedIndependentInducingVariables,
    kernel: SharedIndependent,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Kuu [M, M], Kuf [M, N] (``conditionals.py:61-81``)."""
    return _posterior_fused(
        posteriors.IndependentPosteriorMultiOutput, Xnew, inducing_variable, kernel, f, q_sqrt, white,
        full_cov, full_output_cov,
    )


@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_L...]",
    "f: [M, L]",
    "return[0]: [batch..., N, P]",
    "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
    "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
    "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
)
def separate_independent_conditional(
    Xnew: torch.Tensor,
    inducing_variable: InducingVariables,
    kernel: Kernel,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Kuu [L, M, M], Kuf [L, M, N] (``conditionals.py:89-104``)."""
    return _posterior_fused(
        posteriors.IndependentPosteriorMultiOutput, Xnew, inducing_variable, kernel, f, q_sqrt, white,
        full_cov, full_output_cov,
    )


conditional.add(
    (object, SeparateIndependentInducingVariables, SeparateIndependent, object),
    separate_independent_conditional,
)
conditional.add(
    (object, SharedIndependentInducingVariables, SeparateIndependent, object),
    separate_independent_conditional,
)
conditional.add(
    (object, SeparateIndependentInducingVariables, SharedIndependent, object),
    separate_independent_conditional,
)


@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_L...]",
    "f: [M, L]",
    "return[0]: [batch..., N, P]",
    "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
    "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
    "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
)
def fallback_independent_latent_conditional(
    Xnew: torch.Tensor,
    inducing_variable: InducingVariables,
    kernel: IndependentLatent,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Interdomain: Kuu [L, M, M], Kuf [M, L, N, P]
    (``conditionals.py:131-147``)."""
    return _posterior_fused(
        posteriors.FallbackIndependentLatentPosterior, Xnew, inducing_variable, kernel, f, q_sqrt, white,
        full_cov, full_output_cov,
    )


conditional.add(
    (object, FallbackSharedIndependentInducingVariables, IndependentLatent, object),
    fallback_independent_latent_conditional,
)
conditional.add(
    (object, FallbackSeparateIndependentInducingVariables, IndependentLatent, object),
    fallback_independent_latent_conditional,
)


@conditional.register(object, InducingPoints, MultioutputKernel, object)
@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_L...]",
    "f: [L, 1]",
    "return[0]: [batch..., N, P]",
    "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
    "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
    "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
)
def inducing_point_conditional(
    Xnew: torch.Tensor,
    inducing_variable: InducingPoints,
    kernel: MultioutputKernel,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Fully correlated: Kuu [M, P, M, P], Kuf [M, P, N, P]
    (``conditionals.py:171-189``)."""
    return _posterior_fused(
        posteriors.FullyCorrelatedPosterior, Xnew, inducing_variable, kernel, f, q_sqrt, white,
        full_cov, full_output_cov,
    )


@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_L...]",
    "f: [M, L]",
    "return[0]: [batch..., N, P]",
    "return[1]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    "return[1]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
    "return[1]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
    "return[1]: [batch..., N, P, N, P] if full_cov and full_output_cov",
)
def coregionalization_conditional(
    Xnew: torch.Tensor,
    inducing_variable: InducingVariables,
    kernel: LinearCoregionalization,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """Conditions in g-space then mixes with W
    (``conditionals.py:200-216``)."""
    return _posterior_fused(
        posteriors.LinearCoregionalizationPosterior, Xnew, inducing_variable, kernel, f, q_sqrt, white,
        full_cov, full_output_cov,
    )


conditional.add(
    (object, SharedIndependentInducingVariables, LinearCoregionalization, object),
    coregionalization_conditional,
)
conditional.add(
    (object, SeparateIndependentInducingVariables, LinearCoregionalization, object),
    coregionalization_conditional,
)
