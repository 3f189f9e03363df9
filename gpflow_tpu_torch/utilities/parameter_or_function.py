"""Parameter-or-Function helper (counterpart of
``gpflow_tpu/utilities/parameter_or_function.py``). So far only the constant
case: a likelihood hyperparameter is a positive ``Parameter``;
input-dependent ``Function`` values are still to port (ROADMAP.md)."""
from __future__ import annotations

from typing import Any, Optional

import torch

from ..base import Parameter
from ..bijectors import positive

__all__ = ["evaluate_parameter_or_function", "prepare_parameter_or_function"]


def prepare_parameter_or_function(
    value: Any, *, lower_bound: Optional[float] = None, name: Optional[str] = None
) -> Parameter:
    """``value`` if it is a Parameter, else a Parameter bounded below by
    ``lower_bound``."""
    if isinstance(value, Parameter):
        return value
    return Parameter(value, transform=positive(lower=lower_bound), name=name)


def evaluate_parameter_or_function(value: Parameter, X: torch.Tensor) -> torch.Tensor:
    """The value at inputs X (constant for a Parameter)."""
    return value.value
