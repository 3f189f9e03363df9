"""Training driver for minibatch models such as SVGP (counterpart of
``gpflow_tpu/parallel/trainer.py``; one device so far).

A step is one forward and backward pass of the model's
``_training_loss(batch)`` and one optimizer step on its trainable
parameters, which are the model's own tensors and change in place. The
steps of ``run_steps`` and ``run_steps_sampled`` are queued without waiting
for the device: no loss or Cholesky failure is read on the host inside them,
and the losses come back as one device tensor.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from ..base import Module

__all__ = ["DataParallelTrainer", "OptimizerFactory", "adam"]

OptimizerFactory = Callable[[Sequence[torch.nn.Parameter]], torch.optim.Optimizer]


def adam(learning_rate: float = 1e-2) -> OptimizerFactory:
    """Adam with ``optax.adam``'s defaults (b1 0.9, b2 0.999, eps 1e-8): the
    same update, -lr * m_hat / (sqrt(v_hat) + eps), up to rounding."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"DataParallelTrainer: {what} is not ported yet (one device only); see ROADMAP.md"
    )


class DataParallelTrainer:
    """Runs optimization steps of a model with an
    ``ExternalDataTrainingLossMixin``-style ``_training_loss(batch)`` on the
    device that holds its parameters.

    :param model: the model (e.g. SVGP). Its trainable parameters are
        optimized in place; frozen ones (``set_trainable(..., False)``) stay.
    :param optimizer: a callable from the parameters to a
        ``torch.optim.Optimizer``; default ``adam(1e-2)``, the counterpart of
        ``optax.adam(1e-2)``.
    :param mesh: must be None: the mesh, the natural-gradient modes and the
        latent axis need more than one device and raise.
    """

    def __init__(
        self,
        model: Module,
        optimizer: Optional[OptimizerFactory] = None,
        mesh: Any = None,
        *,
        natgrad_gamma: Optional[float] = None,
        latent_axis: Optional[str] = None,
        natgrad_fused: bool = False,
    ) -> None:
        if mesh is not None:
            raise _not_ported("a device mesh")
        if natgrad_gamma is not None or natgrad_fused:
            raise _not_ported("the natural-gradient step")
        if latent_axis is not None:
            raise _not_ported("a latent mesh axis")
        self.model = model
        params = [p.unconstrained for p in model.trainable_parameters]
        if not params:
            raise ValueError("Model has no trainable parameters")
        self.device = params[0].device
        self.optimizer = (optimizer if optimizer is not None else adam(1e-2))(params)
        self._staged_data: Optional[Tuple[torch.Tensor, ...]] = None
        self._sample_counter = 0

    def _to_device(self, arrays: Sequence[Any]) -> Tuple[torch.Tensor, ...]:
        """Tensors on the model's device; arrays already there are not copied."""
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)

    def _train_step(self, batch: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.model._training_loss(batch)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def step(self, batch: Tuple[Any, ...]) -> torch.Tensor:
        """One optimization step on (X [B, D], Y [B, P]); returns the loss
        before the step, on the device."""
        return self._train_step(self._to_device(batch))

    def run_steps(self, batches: Tuple[Any, ...]) -> torch.Tensor:
        """K steps on stacked batches X [K, B, D], Y [K, B, P]; returns the
        per-step losses [K] on the device. Batches already on the model's
        device are used as they are, without a host transfer."""
        X, Y = self._to_device(batches)
        return torch.stack([self._train_step((X[k], Y[k])) for k in range(X.shape[0])])

    def stage_data(self, data: Tuple[Any, ...]) -> None:
        """Places the whole training set (X [N, D], Y [N, P]) on the model's
        device, once, for ``run_steps_sampled``."""
        self._staged_data = self._to_device(data)

    def run_steps_sampled(
        self, n_steps: int, batch_size: int, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """``n_steps`` steps, each on a minibatch drawn uniformly with
        replacement from the staged data, the indices drawn on the device
        with ``generator`` (a ``torch.Generator`` on the model's device;
        by default one seeded with the count of earlier calls). Returns the
        per-step losses [n_steps] on the device."""
        if self._staged_data is None:
            raise ValueError("Call stage_data(data) before run_steps_sampled")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self._sample_counter)
            self._sample_counter += 1
        X, Y = self._staged_data
        idx = torch.randint(0, X.shape[0], (n_steps, batch_size), device=self.device, generator=generator)
        return torch.stack([self._train_step((X.index_select(0, i), Y.index_select(0, i))) for i in idx])

    def loss(self, batch: Tuple[Any, ...]) -> torch.Tensor:
        """The loss on one batch, without a step."""
        with torch.no_grad():
            return self.model._training_loss(self._to_device(batch)).detach()

    def finalize(self) -> None:
        """Nothing to write back: the steps update the model's parameters in
        place. Kept for the JAX package's API, where it copies them out of
        the device state."""
