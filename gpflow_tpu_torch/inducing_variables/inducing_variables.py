"""Inducing variables (counterpart of
``gpflow_tpu/inducing_variables/inducing_variables.py``)."""
from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

import torch

from ..base import Module, Parameter
from ..bijectors import positive
from ..utilities.shapes import check_shapes

__all__ = ["InducingPoints", "InducingPointsBase", "InducingVariables", "Multiscale"]


class InducingVariables(Module, abc.ABC):
    """Abstract base class for inducing variables."""

    @property
    @abc.abstractmethod
    def num_inducing(self) -> int:
        raise NotImplementedError

    def __len__(self) -> int:
        return self.num_inducing

    @property
    @abc.abstractmethod
    def shape(self) -> Optional[Tuple[int, ...]]:
        """Some variation of [M, D, P] (P = 1 for a single output)."""


class InducingPointsBase(InducingVariables):
    @check_shapes(
        "Z: [M, D]",
    )
    def __init__(self, Z: Any, name: Optional[str] = None) -> None:
        """:param Z: [M, D] initial positions of the inducing points."""
        super().__init__()
        if not isinstance(Z, Parameter):
            Z = Parameter(Z, name="Z")
        self.Z = Z
        if name is not None:
            self._name = name

    @property
    @check_shapes(
        "return: []",
    )
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    @property
    def shape(self) -> Optional[Tuple[int, ...]]:
        """[M, D, 1], the shape that contracts such as
        ``"inducing_variable: [M, D, maybe_R...]"`` read
        (``inducing_variables.py:53-58``)."""
        shape = self.Z.shape
        if not shape:
            return None
        return tuple(shape) + (1,)


class InducingPoints(InducingPointsBase):
    """Real-space inducing points."""


class Multiscale(InducingPointsBase):
    """Multi-scale inducing variables (Walder et al., NIPS 2009;
    ``inducing_variables.py:65-79``): centres Z [M, D] and positive widths
    ``scales`` [M, D]."""

    @check_shapes("Z: [M, D]", "scales: [M, D]")
    def __init__(self, Z: Any, scales: Any) -> None:
        super().__init__(Z)
        self.scales = Parameter(scales, transform=positive(), name="scales")

    @staticmethod
    @check_shapes("A: [N, D]", "B: [M, D]", "sc: [bcast..., M, D]", "return: [N, M]")
    def _cust_square_dist(A: torch.Tensor, B: torch.Tensor, sc: torch.Tensor) -> torch.Tensor:
        """Squared distance with per-point length scales: [N, M]."""
        return torch.sum(torch.square((A[:, None, :] - B[None, :, :]) / sc), 2)
