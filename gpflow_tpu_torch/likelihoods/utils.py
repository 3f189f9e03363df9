"""Likelihood helpers (counterpart of ``gpflow_tpu/likelihoods/utils.py``)."""
from __future__ import annotations

import math

import torch

from ..utilities.shapes import check_shapes

__all__ = ["inv_probit"]


@check_shapes(
    "x: [batch...]",
    "return: [batch...]",
)
def inv_probit(x: torch.Tensor) -> torch.Tensor:
    """The standard normal CDF squashed into (1e-3, 1 - 1e-3)
    (``gpflow_tpu/likelihoods/utils.py:17-20``)."""
    jitter = 1e-3  # keeps the output strictly between 0 and 1
    return 0.5 * (1.0 + torch.special.erf(x / math.sqrt(2.0))) * (1 - 2 * jitter) + jitter
