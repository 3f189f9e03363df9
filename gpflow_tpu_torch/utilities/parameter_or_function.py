"""Parameter-or-Function helper (counterpart of
``gpflow_tpu/utilities/parameter_or_function.py``): a likelihood
hyperparameter such as the noise variance is either a constant positive
``Parameter`` or an input-dependent ``Function``."""
from __future__ import annotations

from typing import Any, Optional, Union

import torch

from ..base import Parameter
from ..bijectors import positive
from .shapes import check_shapes

__all__ = [
    "ConstantOrFunction",
    "ParameterOrFunction",
    "evaluate_parameter_or_function",
    "prepare_parameter_or_function",
]

ConstantOrFunction = Union[Parameter, "Function"]  # noqa: F821 - forward ref
ParameterOrFunction = Union[Parameter, "Function"]  # noqa: F821


def prepare_parameter_or_function(
    value: Any, *, lower_bound: Optional[float] = None, name: Optional[str] = None
) -> ConstantOrFunction:
    """``value`` if it is a Function or a Parameter, else a Parameter bounded
    below by ``lower_bound``."""
    from ..functions import Function

    if isinstance(value, (Function, Parameter)):
        return value
    return Parameter(value, transform=positive(lower=lower_bound), name=name)


@check_shapes(
    "X: [batch..., N, D]",
    "return: [broadcast batch..., broadcast N, broadcast P]",
)
def evaluate_parameter_or_function(
    value: ConstantOrFunction,
    X: torch.Tensor,
    *,
    lower_bound: Optional[float] = None,
) -> torch.Tensor:
    """The value at inputs X: a Function's output, clamped below at
    ``lower_bound`` when given, or a Parameter's constant value."""
    from ..functions import Function

    if isinstance(value, Function):
        result = value(X)
        if lower_bound is not None:
            result = torch.clamp(result, min=lower_bound)
        return result
    return value.value if isinstance(value, Parameter) else torch.as_tensor(value)
