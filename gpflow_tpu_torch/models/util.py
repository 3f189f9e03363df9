"""Model helpers (counterpart of ``gpflow_tpu/models/util.py``)."""
from __future__ import annotations

from typing import Any, Callable, Iterator, Union

import numpy as np
import torch

from ..base import Module, Parameter
from ..config import default_device, default_float
from ..inducing_variables import InducingPoints, InducingVariables
from ..utilities.shapes import check_shapes
from .training_mixins import ExternalDataTrainingLossMixin, InternalDataTrainingLossMixin, RegressionData  # noqa: F401

# as ``gpflow_tpu/models/util.py:17-18``
InducingVariablesLike = Union[InducingVariables, torch.Tensor, np.ndarray]
InducingPointsLike = Union[InducingPoints, torch.Tensor, np.ndarray]

__all__ = [
    "data_input_to_tensor",
    "inducingpoint_wrapper",
    "maximum_log_likelihood_objective",
    "training_loss",
    "training_loss_closure",
]


def inducingpoint_wrapper(inducing_variable: InducingVariablesLike) -> InducingVariables:
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


@check_shapes(
    "data[0]: [N, D]",
    "data[1]: [N, P]",
    "return: []",
)
def maximum_log_likelihood_objective(model: Module, data: RegressionData) -> torch.Tensor:
    """The model's objective: on its own data for a model that keeps it (the
    ``data`` argument is then not read), else on ``data``
    (``gpflow_tpu/models/util.py:62-67``)."""
    if isinstance(model, InternalDataTrainingLossMixin):
        return model.maximum_log_likelihood_objective()
    return model.maximum_log_likelihood_objective(data)


@check_shapes(
    "data[0]: [N, D]",
    "data[1]: [N, P]",
    "return: []",
)
def training_loss(model: Module, data: RegressionData) -> torch.Tensor:
    """The model's training loss, on its own data or on ``data``
    (``gpflow_tpu/models/util.py:70-79``)."""
    if isinstance(model, InternalDataTrainingLossMixin):
        return model.training_loss()
    return model.training_loss(data)


@check_shapes(
    "data[0]: [N, D]",
    "data[1]: [N, P]",
)
def training_loss_closure(
    model: Module,
    data: Union[RegressionData, Iterator[RegressionData]],
    **closure_kwargs: Any,
) -> Callable[[], torch.Tensor]:
    """A zero-argument loss closure for ``Scipy().minimize``, on the model's
    own data or on ``data`` (``gpflow_tpu/models/util.py:82-93``)."""
    if isinstance(model, InternalDataTrainingLossMixin):
        return model.training_loss_closure(**closure_kwargs)
    return model.training_loss_closure(data, **closure_kwargs)
