"""Training-loss mixins (counterpart of ``gpflow_tpu/models/training_mixins.py``).

``training_loss_closure(compile=True)`` (the default) returns a closure
backed by ``_compile.jit`` over the whole model: its tensors and the
batch are the trace's inputs and its structure and statics the key, so the
loss is traced once (for minibatches, once per batch shape) and replayed at
every later call, its gradient carried back to the model's parameters
through autograd (``gpflow_tpu/models/training_mixins.py:34-75``)."""
from __future__ import annotations

from typing import Callable, Iterator, Tuple, TypeVar, Union

import torch

from .._compile import jit
from ..base import InputData, OutputData, RegressionData, input_to_tensor
from ..utilities.shapes import check_shapes

__all__ = ["Data", "ExternalDataTrainingLossMixin", "InternalDataTrainingLossMixin"]

LossClosure = Callable[[], torch.Tensor]
# as ``gpflow_tpu/models/training_mixins.py:23``
Data = TypeVar("Data", RegressionData, InputData, OutputData)


class InternalDataTrainingLossMixin:
    """For models that keep their data (GPR; ``training_mixins.py:26-42``)."""

    @check_shapes(
        "return: []",
    )
    def training_loss(self) -> torch.Tensor:
        """The loss on the model's own data."""
        return self._training_loss()

    def training_loss_closure(self, *, compile: bool = True) -> LossClosure:
        """A zero-argument loss closure: with ``compile``, the traced loss of
        the model; else the bound ``training_loss``."""
        if not compile:
            return self.training_loss
        loss = jit(_internal_loss)
        closure = lambda: loss(self)  # noqa: E731
        closure.traced = loss
        return closure


class ExternalDataTrainingLossMixin:
    """For models that take their data per call, as minibatches (SVGP;
    ``training_mixins.py:45-82``)."""

    @check_shapes(
        "data[0]: [N, D]",
        "data[1]: [N, P]",
        "return: []",
    )
    def training_loss(self, data: RegressionData) -> torch.Tensor:
        """The loss on one batch (X [N, D], Y [N, P])."""
        return self._training_loss(input_to_tensor(self, data))

    def training_loss_closure(
        self,
        data: Union[RegressionData, Iterator[RegressionData]],
        *,
        compile: bool = True,
    ) -> LossClosure:
        """A zero-argument loss closure. ``data`` is either a fixed (X, Y)
        pair or an iterator of minibatches, of which each call takes the
        next. With ``compile`` one trace serves every batch of one shape."""
        training_loss = self.training_loss
        traced = None
        if compile:
            traced = jit(_external_loss)
            training_loss = lambda batch: traced(self, batch)  # noqa: E731
        # an iterator is a stream of minibatches; any other (X, Y) pair is fixed data
        if hasattr(data, "__next__"):
            closure = lambda: training_loss(next(data))  # noqa: E731
        else:
            data = tuple(data)
            closure = lambda: training_loss(data)  # noqa: E731
        closure.traced = traced
        return closure


def _internal_loss(model: InternalDataTrainingLossMixin) -> torch.Tensor:
    return model._training_loss()


def _external_loss(model: ExternalDataTrainingLossMixin, batch: RegressionData) -> torch.Tensor:
    return model._training_loss(batch)
