"""Training-loss mixins (counterpart of ``gpflow_tpu/models/training_mixins.py``;
the external-data one so far, the internal-data one comes with GPR)."""
from __future__ import annotations

from typing import Callable, Iterator, Tuple, Union

import torch

__all__ = ["ExternalDataTrainingLossMixin"]

RegressionData = Tuple[torch.Tensor, torch.Tensor]
LossClosure = Callable[[], torch.Tensor]


class ExternalDataTrainingLossMixin:
    """For models that take their data per call, as minibatches (SVGP;
    ``training_mixins.py:45-82``)."""

    def training_loss(self, data: RegressionData) -> torch.Tensor:
        """The loss on one batch (X [N, D], Y [N, P])."""
        return self._training_loss(data)

    def training_loss_closure(
        self,
        data: Union[RegressionData, Iterator[RegressionData]],
        *,
        compile: bool = True,
    ) -> LossClosure:
        """A zero-argument loss closure. ``data`` is either a fixed (X, Y)
        pair or an iterator of minibatches, of which each call takes the next.

        ``compile`` is accepted for the JAX package's signature and changes
        nothing: the closure runs eagerly either way. ``torch.compile`` is
        not put around it because the covariance kernels are launched through
        ctypes, which it cannot trace."""
        del compile
        if hasattr(data, "__next__"):
            return lambda: self.training_loss(next(data))
        data = tuple(data)
        return lambda: self.training_loss(data)
