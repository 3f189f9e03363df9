"""Training-loss mixins (counterpart of ``gpflow_tpu/models/training_mixins.py``).

``compile=True`` is accepted for the JAX package's signature and changes
nothing: losses run eagerly. ``torch.compile`` is not put around them because
the covariance kernels are launched through ctypes, which it cannot trace."""
from __future__ import annotations

from typing import Callable, Iterator, Tuple, TypeVar, Union

import torch

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
        """A zero-argument loss closure: the bound ``training_loss``."""
        del compile
        return self.training_loss


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
        pair or an iterator of minibatches, of which each call takes the next."""
        del compile
        if hasattr(data, "__next__"):
            return lambda: self.training_loss(next(data))
        data = tuple(data)
        return lambda: self.training_loss(data)
