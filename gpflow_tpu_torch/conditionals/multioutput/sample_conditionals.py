"""Multioutput sampling (counterpart of
``gpflow_tpu/conditionals/multioutput/sample_conditionals.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...inducing_variables import SeparateIndependentInducingVariables, SharedIndependentInducingVariables
from ...kernels import LinearCoregionalization, SeparateIndependent
from ...utilities.shapes import check_shapes
from ..dispatch import conditional, sample_conditional
from ..util import mix_latent_gp, sample_mvn

__all__ = ["_sample_conditional_coregionalization"]


@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_L...]",
    "f: [M, L]",
    "return[0]: [batch..., N, P] if num_samples is None",
    "return[0]: [batch..., num_samples, N, P] if num_samples is not None",
    "return[1]: [batch..., N, P]",
    "return[2]: [batch..., N, P] if (not full_cov) and (not full_output_cov)",
    "return[2]: [batch..., P, N, N] if full_cov and (not full_output_cov)",
    "return[2]: [batch..., N, P, P] if (not full_cov) and full_output_cov",
    "return[2]: [batch..., N, P, N, P] if full_cov and full_output_cov",
)
def _sample_conditional_coregionalization(
    Xnew: torch.Tensor,
    inducing_variable: object,
    kernel: LinearCoregionalization,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
    num_samples: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Samples the L latent GPs g and mixes them, f = g W^T
    (``sample_conditionals.py:35-89``). The latent GPs are independent, so
    ``full_cov`` and ``full_output_cov`` both hold: each latent's [N, N]
    covariance is sampled as one N-dimensional normal, and
    ``full_output_cov`` changes only the layout of the returned moments."""
    ind_conditional = conditional.dispatch_or_raise(
        object, SeparateIndependentInducingVariables, SeparateIndependent, object
    )
    g_mu, g_var = ind_conditional(
        Xnew, inducing_variable, kernel, f, white=white, q_sqrt=q_sqrt, full_cov=full_cov
    )  # g_mu [..., N, L]; g_var [..., N, L] or [..., L, N, N]
    if full_cov:
        g_sample = sample_mvn(g_mu.mT, g_var, True, num_samples=num_samples, generator=generator).mT
        g_var_mix = torch.movedim(g_var, -3, 0)  # [L, ..., N, N]
    else:
        g_sample = sample_mvn(g_mu, g_var, False, num_samples=num_samples, generator=generator)
        g_var_mix = g_var
    W = kernel.W.value
    f_mu, f_var = mix_latent_gp(W, g_mu, g_var_mix, full_cov, full_output_cov)
    f_sample = torch.tensordot(g_sample, W, dims=([g_sample.ndim - 1], [1]))
    return f_sample, f_mu, f_var


sample_conditional.add(
    (object, SharedIndependentInducingVariables, LinearCoregionalization, object),
    _sample_conditional_coregionalization,
)
sample_conditional.add(
    (object, SeparateIndependentInducingVariables, LinearCoregionalization, object),
    _sample_conditional_coregionalization,
)
