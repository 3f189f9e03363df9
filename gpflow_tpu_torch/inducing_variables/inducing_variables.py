"""Inducing variables (counterpart of
``gpflow_tpu/inducing_variables/inducing_variables.py``)."""
from __future__ import annotations

import abc
from typing import Any, Optional, Tuple

from ..base import Module, Parameter

__all__ = ["InducingPoints", "InducingPointsBase", "InducingVariables"]


class InducingVariables(Module, abc.ABC):
    """Abstract base class for inducing variables."""

    @property
    @abc.abstractmethod
    def num_inducing(self) -> int:
        raise NotImplementedError


class InducingPointsBase(InducingVariables):
    def __init__(self, Z: Any, name: Optional[str] = None) -> None:
        """:param Z: [M, D] initial positions of the inducing points."""
        super().__init__()
        if not isinstance(Z, Parameter):
            Z = Parameter(Z, name="Z")
        self.Z = Z
        if name is not None:
            self._name = name

    @property
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
