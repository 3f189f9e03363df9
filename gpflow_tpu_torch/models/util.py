"""Model helpers (counterpart of ``gpflow_tpu/models/util.py``)."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..base import Parameter
from ..config import default_device, default_float
from ..inducing_variables import InducingPoints, InducingVariables

__all__ = ["data_input_to_tensor", "inducingpoint_wrapper"]


def inducingpoint_wrapper(inducing_variable: Any) -> InducingVariables:
    """Wraps a raw [M, D] array or tensor into InducingPoints."""
    if not isinstance(inducing_variable, InducingVariables):
        inducing_variable = InducingPoints(inducing_variable)
    return inducing_variable


def data_input_to_tensor(structure: Any) -> Any:
    """Tensors on ``config.default_device()`` from a structure of arrays
    (tuples and lists are walked): floating data takes ``default_float()``,
    other data keeps its dtype, and Parameters pass through unchanged
    (``gpflow_tpu/models/util.py:39-54``)."""
    if isinstance(structure, Parameter):
        return structure
    if isinstance(structure, tuple):
        return tuple(data_input_to_tensor(x) for x in structure)
    if isinstance(structure, list):
        return [data_input_to_tensor(x) for x in structure]
    t = structure.detach() if isinstance(structure, torch.Tensor) else torch.as_tensor(np.asarray(structure))
    dtype = default_float() if t.is_floating_point() else t.dtype
    return t.to(device=default_device(), dtype=dtype)
