"""Model helpers (counterpart of ``gpflow_tpu/models/util.py``)."""
from __future__ import annotations

from typing import Any

from ..inducing_variables import InducingPoints, InducingVariables

__all__ = ["inducingpoint_wrapper"]


def inducingpoint_wrapper(inducing_variable: Any) -> InducingVariables:
    """Wraps a raw [M, D] array or tensor into InducingPoints."""
    if not isinstance(inducing_variable, InducingVariables):
        inducing_variable = InducingPoints(inducing_variable)
    return inducing_variable
