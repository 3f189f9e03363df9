"""Sampling from conditionals (counterpart of
``gpflow_tpu/conditionals/sample_conditionals.py``)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..inducing_variables import InducingVariables
from ..kernels import Kernel
from ..utilities.shapes import check_shapes
from .dispatch import conditional, sample_conditional
from .util import sample_mvn

__all__ = ["_sample_conditional"]

SamplesMeanAndVariance = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


@check_shapes(
    "Xnew: [batch..., N, D]",
    "inducing_variable: [M, D, maybe_R...]",
    "f: [M, R]",
    "return[0]: [batch..., N, R] if num_samples is None",
    "return[0]: [batch..., num_samples, N, R] if num_samples is not None",
    "return[1]: [batch..., N, R]",
    "return[2]: [batch..., N, R] if (not full_cov) and (not full_output_cov)",
    "return[2]: [batch..., R, N, N] if full_cov and (not full_output_cov)",
    "return[2]: [batch..., N, R, R] if (not full_cov) and full_output_cov",
)
def _sample_conditional(
    Xnew: torch.Tensor,
    inducing_variable: object,
    kernel: Kernel,
    f: torch.Tensor,
    *,
    full_cov: bool = False,
    full_output_cov: bool = False,
    q_sqrt: Optional[torch.Tensor] = None,
    white: bool = False,
    num_samples: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> SamplesMeanAndVariance:
    """(samples, mean, cov) of the conditional at Xnew
    (``sample_conditionals.py:27-72``); the draws come from ``generator`` as
    in ``sample_mvn``."""
    if full_cov and full_output_cov:
        raise NotImplementedError("The combination of both `full_cov` and `full_output_cov` is not permitted.")

    mean, cov = conditional(
        Xnew, inducing_variable, kernel, f,
        q_sqrt=q_sqrt, white=white, full_cov=full_cov, full_output_cov=full_output_cov,
    )
    if full_cov:
        # mean [..., N, P] as [..., P, N] against cov [..., P, N, N]
        samples = sample_mvn(mean.mT, cov, True, num_samples=num_samples, generator=generator)
        samples = samples.mT  # [..., (S), N, P]
    else:
        samples = sample_mvn(mean, cov, full_output_cov, num_samples=num_samples, generator=generator)
    return samples, mean, cov


sample_conditional.add((object, object, Kernel, object), _sample_conditional)
sample_conditional.add((object, InducingVariables, Kernel, object), _sample_conditional)
