"""Single-output conditional registrations (counterpart of
``gpflow_tpu/conditionals/conditionals.py``): on inducing variables, through
the posterior class that ``get_posterior_class`` dispatches to, and on
function values at data points, through ``VGPPosterior``. Both take the
fused route (no cache)."""
from __future__ import annotations

from typing import Optional

import torch

from ..base import MeanAndVariance
from ..inducing_variables import InducingVariables
from ..kernels import Kernel
from ..utilities.shapes import check_shapes
from .dispatch import conditional

__all__ = ["_dense_conditional", "_sparse_conditional"]


@conditional.register(object, InducingVariables, Kernel, object)
@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_R...]",
    "f: [M, R]",
    "q_sqrt: [M, R] | [R, M, M]",
    "return[0]: [batch..., N, R]",
    "return[1]: [batch..., N, R] if (not full_cov) and (not full_output_cov)",
    "return[1]: [batch..., R, N, N] if full_cov and (not full_output_cov)",
    "return[1]: [batch..., N, R, R] if (not full_cov) and full_output_cov",
    "return[1]: [batch..., N, R, N, R] if full_cov and full_output_cov",
)
def _sparse_conditional(
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
    """Single-output sparse GP conditional: the dispatched posterior class's
    ``fused_predict_f`` (``conditionals.py:18-53``)."""
    from ..posteriors import get_posterior_class  # posteriors imports this package

    posterior_class = get_posterior_class(kernel, inducing_variable)
    posterior = posterior_class(
        kernel,
        inducing_variable,
        f,
        q_sqrt,
        whiten=white,
        mean_function=None,
        precompute_cache=None,
    )
    return posterior.fused_predict_f(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)


@conditional.register(object, object, Kernel, object)
@check_shapes(
    "Xnew: [batch..., N, D]",
    "X: [M, D]",
    "f: [M, R]",
    "q_sqrt: [M, R] | [R, M, M]",
    "return[0]: [batch..., N, R]",
    "return[1]: [batch..., N, R] if (not full_cov) and (not full_output_cov)",
    "return[1]: [batch..., R, N, N] if full_cov and (not full_output_cov)",
    "return[1]: [batch..., N, R, R] if (not full_cov) and full_output_cov",
    "return[1]: [batch..., N, R, N, R] if full_cov and full_output_cov",
)
def _dense_conditional(
    Xnew: torch.Tensor,
    X: torch.Tensor,
    kernel: Kernel,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
) -> MeanAndVariance:
    """GP conditional on function values f at data points X
    (``conditionals.py:56-85``)."""
    from ..posteriors import VGPPosterior

    posterior = VGPPosterior(
        kernel=kernel, X=X, q_mu=f, q_sqrt=q_sqrt, white=white, precompute_cache=None
    )
    return posterior.fused_predict_f(Xnew, full_cov=full_cov, full_output_cov=full_output_cov)
