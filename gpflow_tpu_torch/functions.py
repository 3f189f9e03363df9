"""Functions and mean functions (counterpart of ``gpflow_tpu/functions.py``;
``Zero`` only so far)."""
from __future__ import annotations

import torch

from .base import Module

__all__ = ["Function", "MeanFunction", "Zero"]


class Function(Module):
    """``function(X: [batch..., N, D]) -> [batch..., N, Q]``; also used for
    input-dependent likelihood parameters."""

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("Implement the forward method for this function")


class MeanFunction(Function):
    """Marks Functions appropriate as GP mean functions."""


class Zero(MeanFunction):
    """y_i = 0."""

    def __init__(self, output_dim: int = 1) -> None:
        super().__init__()
        self.output_dim = output_dim

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.zeros(X.shape[:-1] + (self.output_dim,), dtype=X.dtype, device=X.device)
