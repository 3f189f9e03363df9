"""Closed-form log densities (counterpart of ``gpflow_tpu/logdensities.py``;
``gaussian`` only so far, ROADMAP.md lists the rest)."""
from __future__ import annotations

import math

import torch

__all__ = ["gaussian"]


def gaussian(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """log N(x | mu, var), broadcast elementwise (``logdensities.py:33``)."""
    return -0.5 * (math.log(2.0 * math.pi) + torch.log(var) + torch.square(mu - x) / var)
