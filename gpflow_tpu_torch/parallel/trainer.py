"""Training driver for minibatch models such as SVGP (counterpart of
``gpflow_tpu/parallel/trainer.py``; one device so far).

A step is one forward and backward pass of the model's
``_training_loss(batch)`` and one optimizer step on its trainable
parameters, which are the model's own tensors and change in place. With
``natgrad_gamma`` the variational parameters (q_mu, q_sqrt) take a
natural-gradient step instead, and the optimizer handles the rest. The steps
of ``run_steps`` and ``run_steps_sampled`` are queued without waiting for
the device: no loss, Cholesky failure or rejected natural-gradient step is
read on the host inside them, and the losses come back as one device tensor.
``state_dict``/``load_state_dict`` and ``save_state``/``load_state`` snapshot
and restore the optimization state (``gpflow_tpu/parallel/trainer.py:454-523``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..base import Module, Parameter
from ..optimizers.natgrad import NaturalGradient

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
    :param mesh: must be None: the mesh and the latent axis need more than
        one device and raise.
    :param natgrad_gamma: if set, the model's q_mu and full-covariance q_sqrt
        ([L, M, M]) take a natural-gradient step of this size each step
        (``NaturalGradient`` with ``XiNat``), and the optimizer handles only
        the other parameters. By default the step is sequential, as GPflow's
        recipe: the natural-gradient step, then the optimizer's gradient at
        the new q(u), with a second forward and backward pass; the loss
        returned is the one of that second pass.
    :param natgrad_fused: take both gradients from one forward and backward
        pass at the same point (a simultaneous update); the loss returned is
        the one before the step. Requires ``natgrad_gamma``.
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
        if latent_axis is not None:
            raise _not_ported("a latent mesh axis")
        if natgrad_fused and natgrad_gamma is None:
            raise ValueError(
                "natgrad_fused=True requires natgrad_gamma (there is no "
                "natural-gradient step to fuse without it)"
            )
        self.model = model
        self.natgrad_gamma = natgrad_gamma
        self.natgrad_fused = natgrad_fused
        train_params: List[Parameter] = list(model.trainable_parameters)
        self._vparams: Tuple[Parameter, ...] = ()
        if natgrad_gamma is not None:
            q_mu = getattr(model, "q_mu", None)
            q_sqrt = getattr(model, "q_sqrt", None)
            if q_mu is None or q_sqrt is None or q_sqrt.value.ndim != 3:
                raise ValueError(
                    "natgrad_gamma requires the model to have q_mu and a "
                    "full-covariance q_sqrt ([L, M, M])"
                )
            if not (q_mu.trainable and q_sqrt.trainable):
                raise ValueError("natgrad_gamma requires q_mu and q_sqrt to be trainable")
            self._vparams = (q_mu, q_sqrt)
            train_params = [p for p in train_params if p is not q_mu and p is not q_sqrt]
            self._natgrad = NaturalGradient(gamma=natgrad_gamma)
        self._params = [p.unconstrained for p in train_params]
        if not self._params and not self._vparams:
            raise ValueError("Model has no trainable parameters")
        self.device = (self._params or [p.unconstrained for p in self._vparams])[0].device
        self._factory = optimizer if optimizer is not None else adam(1e-2)
        self.optimizer = self._factory(self._params) if self._params else None
        self._rejections = torch.zeros((), dtype=torch.int64, device=self.device)
        self._staged_data: Optional[Tuple[torch.Tensor, ...]] = None
        self._sample_counter = 0

    @property
    def natgrad_rejections(self) -> int:
        """The number of natural-gradient steps rejected so far (the step
        left the negative-definite cone and the state was kept; see
        ``NaturalGradient._natgrad_values_with_ok``). A count that keeps
        growing means ``natgrad_gamma`` is too large. The count is kept on
        the device; reading it waits for the steps queued before."""
        return int(self._rejections)

    def _to_device(self, arrays: Sequence[Any]) -> Tuple[torch.Tensor, ...]:
        """Tensors on the model's device; arrays already there are not copied."""
        return tuple(torch.as_tensor(a).to(self.device) for a in arrays)

    def _optimizer_step(self, grads: Sequence[torch.Tensor]) -> None:
        for p, g in zip(self._params, grads):
            p.grad = g
        self.optimizer.step()

    def _natgrad_step(self, vgrads: Sequence[torch.Tensor]) -> None:
        """The natural-gradient step on (q_mu, q_sqrt) from the gradients of
        their unconstrained tensors; a rejection adds one to the device
        count."""
        q_mu, q_sqrt = self._vparams
        ok = self._natgrad._natgrad_apply_gradients(vgrads[0], vgrads[1], q_mu, q_sqrt)
        self._rejections += (~ok).to(torch.int64)

    def _train_step(self, batch: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        if not self._vparams:
            self.optimizer.zero_grad(set_to_none=True)
            loss = self.model._training_loss(batch)
            loss.backward()
            self.optimizer.step()
            return loss.detach()
        vleaves = [p.unconstrained for p in self._vparams]
        if self.natgrad_fused and self._params:
            # one forward and backward pass for both gradient sets
            loss = self.model._training_loss(batch)
            grads = torch.autograd.grad(loss, vleaves + self._params)
            self._natgrad_step(grads[:2])
            self._optimizer_step(grads[2:])
            return loss.detach()
        # the natural-gradient step at the current hyperparameters, then
        # the optimizer's gradient at the new q(u)
        self._natgrad_step(torch.autograd.grad(self.model._training_loss(batch), vleaves))
        if not self._params:
            with torch.no_grad():
                return self.model._training_loss(batch)
        loss = self.model._training_loss(batch)
        self._optimizer_step(torch.autograd.grad(loss, self._params))
        return loss.detach()

    def step(self, batch: Tuple[Any, ...]) -> torch.Tensor:
        """One optimization step on (X [B, D], Y [B, P]); returns the loss
        on the device (see ``natgrad_gamma`` for which loss)."""
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

    def _optimizer_state(self) -> Dict[int, Dict[str, torch.Tensor]]:
        """The optimizer's state by parameter index, as ``torch.optim`` keeps
        it. Before the first step, the state that step starts from, as
        optax's ``init`` gives it: the structure of a copy's state after one
        step with zero gradients, every tensor zero (for Adam: step 0 and
        zero moments)."""
        if self.optimizer is None:
            return {}
        state = self.optimizer.state_dict()["state"]
        if len(state) == len(self._params):
            return state
        copies = [torch.zeros_like(p, requires_grad=True) for p in self._params]
        probe = self._factory(copies)
        for c in copies:
            c.grad = torch.zeros_like(c)
        probe.step()
        return {i: {k: torch.zeros_like(v) for k, v in s.items()} for i, s in probe.state_dict()["state"].items()}

    def _state_leaves(self) -> List[torch.Tensor]:
        """The trainable unconstrained parameters, the natural-gradient ones
        (q_mu, q_sqrt) and the optimizer's state (by parameter, its entries
        by name), in that order."""
        opt = self._optimizer_state()
        return ([p.detach() for p in self._params] + [p.unconstrained.detach() for p in self._vparams]
                + [opt[i][k] for i in sorted(opt) for k in sorted(opt[i])])

    def state_dict(self) -> Dict[str, np.ndarray]:
        """A host snapshot of the optimization state: the trainable
        parameters, the natural-gradient parameters and the optimizer's
        state, as ``leaf_XXXX`` numpy arrays. Like the JAX package, it holds
        no sampling counter: ``run_steps_sampled`` after a restore draws as a
        fresh trainer does unless it is given a generator."""
        return {f"leaf_{i:04d}": t.detach().cpu().numpy().copy() for i, t in enumerate(self._state_leaves())}

    def load_state_dict(self, host_state: Dict[str, Any]) -> None:
        """Restores a ``state_dict`` snapshot into this trainer, each leaf in
        the dtype and on the device of this trainer's own."""
        leaves = self._state_leaves()
        saved = [np.asarray(host_state[k]) for k in sorted(host_state)]
        if len(saved) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(saved)} leaves, trainer state has "
                f"{len(leaves)} — model/optimizer structure mismatch"
            )
        placed = []
        for cur, new in zip(leaves, saved):
            if tuple(cur.shape) != tuple(new.shape):
                raise ValueError(
                    f"checkpoint leaf shape {new.shape} != trainer leaf "
                    f"shape {tuple(cur.shape)}"
                )
            placed.append(torch.as_tensor(new).to(device=cur.device, dtype=cur.dtype))
        n_params = len(self._params) + len(self._vparams)
        with torch.no_grad():
            for p, new in zip(self._params + [p.unconstrained for p in self._vparams], placed):
                p.copy_(new)
        if self.optimizer is not None:
            opt = self._optimizer_state()
            rest = iter(placed[n_params:])
            self.optimizer.load_state_dict({
                "state": {i: {k: next(rest) for k in sorted(opt[i])} for i in sorted(opt)},
                "param_groups": self.optimizer.state_dict()["param_groups"],
            })

    def save_state(self, path: str) -> None:
        """Saves ``state_dict`` to the npz file ``path`` (``.npz`` is added
        where missing)."""
        np.savez(path if path.endswith(".npz") else path + ".npz", **self.state_dict())

    def load_state(self, path: str) -> None:
        """Restores a ``save_state`` file into this trainer."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as npz:
            self.load_state_dict({k: npz[k] for k in npz.files})
