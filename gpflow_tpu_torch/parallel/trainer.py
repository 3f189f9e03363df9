"""Data-parallel training driver for minibatch models such as SVGP
(counterpart of ``gpflow_tpu/parallel/trainer.py``).

A step is one forward and backward pass of the model's
``_training_loss(batch)`` and one optimizer step on its trainable
parameters, which are the model's own tensors and change in place. With
``natgrad_gamma`` the variational parameters (q_mu, q_sqrt) take a
natural-gradient step instead, and the optimizer handles the rest. The steps
of ``run_steps`` and ``run_steps_sampled`` are queued without waiting for
the device: no loss, Cholesky failure or rejected natural-gradient step is
read on the host inside them, and the losses come back as one device tensor.
Without a mesh a whole step (the loss, the gradients, the natural-gradient
step written into q_mu and q_sqrt, and the optimizer's update of the
parameters and of its own state) is traced once per batch signature by
``_compile.jit`` and replayed at every step of ``step``, ``run_steps`` and
``run_steps_sampled`` (``gpflow_tpu/parallel/trainer.py:189-323``). The
update is ``_optim.Update``'s for ``torch.optim.Adam`` and
``torch.optim.SGD``, over the optimizer's own state; any other optimizer
class (or option) steps with ``step()`` outside the trace. On a mesh the
step runs eagerly, through the same update.

With a ``mesh`` (``make_mesh``), every rank of the mesh runs the trainer on
the same global batches (SPMD). The data axis splits each batch's rows over
its ranks: the loss is KL - scale * all_reduce(sum of this rank's
variational expectations). Each rank's gradients are those of the lifted
objective of ``gpflow_tpu_torch._sharding``; one all-reduce of them all a
step (one more over a latent axis), divided by the mesh's size, leaves the
global gradient of every parameter, and so the same step, on every rank.
A ``latent_axis`` splits q_mu [M, L] by columns and
q_sqrt [L, M, M] over its ranks: each rank holds its L/l latent GPs'
variational parameters (and their optimizer state), forms Kuu, the
Choleskys and the conditionals of those only, and gathers the [B/d, L/l]
marginals that the mixing needs; the KL and the natural-gradient
conversions run on the local latent GPs. The model's q_mu and q_sqrt then
change at ``finalize``. ``state_dict``/``load_state_dict`` and
``save_state``/``load_state`` hold the state in its whole (host) form, so a
state saved on one mesh shape restores onto another
(``gpflow_tpu/parallel/trainer.py:446-523``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .._compile import jit
from .._optim import Update
from .._sharding import Blocks, with_layout
from ..base import Module, Parameter
from ..optimizers.natgrad import NaturalGradient
from ..posteriors import IndependentPosteriorMultiOutput, PrecomputeCacheType
from .mesh import DEFAULT_AXIS, _holds_this_rank

__all__ = ["DataParallelTrainer", "OptimizerFactory", "adam"]

OptimizerFactory = Callable[[Sequence[torch.nn.Parameter]], torch.optim.Optimizer]


def adam(learning_rate: float = 1e-2) -> OptimizerFactory:
    """Adam with ``optax.adam``'s defaults (b1 0.9, b2 0.999, eps 1e-8): the
    same update, -lr * m_hat / (sqrt(v_hat) + eps), up to rounding."""
    return lambda params: torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)


class DataParallelTrainer:
    """Runs optimization steps of a model with an
    ``ExternalDataTrainingLossMixin``-style ``_training_loss(batch)``.

    :param model: the model (e.g. SVGP). Its trainable parameters are
        optimized in place; frozen ones (``set_trainable(..., False)``) stay.
    :param optimizer: a callable from the parameters to a
        ``torch.optim.Optimizer``; default ``adam(1e-2)``, the counterpart of
        ``optax.adam(1e-2)``.
    :param mesh: a ``DeviceMesh`` from ``make_mesh``; its ``axis_name`` axis
        splits each batch's rows. None (the default) trains on the device
        that holds the model's parameters, with no collective: the JAX
        package's default is a mesh over every device. A rank that the mesh
        leaves out trains as with None (``_holds_this_rank``), and its
        ``save_state`` writes nothing.
    :param donate: accepted for the JAX package's signature: the steps
        already update the parameters and the optimizer state in place.
    :param natgrad_gamma: if set, the model's q_mu and full-covariance q_sqrt
        ([L, M, M]) take a natural-gradient step of this size each step
        (``NaturalGradient`` with ``XiNat``), and the optimizer handles only
        the other parameters. By default the step is sequential, as GPflow's
        recipe: the natural-gradient step, then the optimizer's gradient at
        the new q(u), with a second forward and backward pass; the loss
        returned is the one of that second pass.
    :param latent_axis: a second axis of ``mesh`` over which the latent GPs'
        variational state is split (see the module's docstring).
    :param natgrad_fused: take both gradients from one forward and backward
        pass at the same point (a simultaneous update); the loss returned is
        the one before the step. Requires ``natgrad_gamma``.
    """

    def __init__(
        self,
        model: Module,
        optimizer: Optional[OptimizerFactory] = None,
        mesh: Any = None,
        axis_name: str = DEFAULT_AXIS,
        donate: bool = True,
        natgrad_gamma: Optional[float] = None,
        latent_axis: Optional[str] = None,
        natgrad_fused: bool = False,
    ) -> None:
        if natgrad_fused and natgrad_gamma is None:
            raise ValueError(
                "natgrad_fused=True requires natgrad_gamma (there is no "
                "natural-gradient step to fuse without it)"
            )
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (see make_mesh), got {type(mesh).__name__}")
        # a rank that the mesh leaves out trains the whole batch with no collective
        self._outside = mesh is not None and not _holds_this_rank(mesh)
        names = (axis_name,) if mesh is None else tuple(mesh.mesh_dim_names or ())
        if self._outside:
            mesh = None
        self.model = model
        self.mesh = mesh
        self.axis_name = axis_name
        self.donate = donate
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
        if not train_params and not self._vparams:
            raise ValueError("Model has no trainable parameters")

        self._rows: Optional[Blocks] = None
        self._latents: Optional[Blocks] = None
        # latent-split Parameter -> (this rank's block of its unconstrained tensor, the latent dimension)
        self._split: Dict[int, Tuple[torch.nn.Parameter, int]] = {}
        self._groups: Tuple[Any, ...] = ()  # the mesh's groups but the latent axis's
        if latent_axis is not None and latent_axis not in names:
            raise ValueError(
                f"latent_axis {latent_axis!r} is not an axis of the mesh "
                f"{names}; build it with "
                f'make_mesh(shape={{"data": d, "latent": l}})'
            )
        if mesh is not None:
            self._setup_mesh(mesh, names, latent_axis)

        self._train_params = tuple(train_params)
        self._params = [self._leaf(p) for p in train_params]
        # the step without a mesh, traced once per batch signature (and gamma) and replayed
        self._traced = jit(self._model_step)
        self.device = (self._params or [self._leaf(p) for p in self._vparams])[0].device
        self._factory = optimizer if optimizer is not None else adam(1e-2)
        self.optimizer = self._factory(self._params) if self._params else None
        self._update = Update.of(self.optimizer, self._params)  # None: the optimizer steps outside the trace
        self._rejections = torch.zeros((), dtype=torch.int64, device=self.device)
        self._staged_data: Optional[Tuple[torch.Tensor, ...]] = None
        self._sample_counter = 0

    def _setup_mesh(self, mesh: Any, names: Tuple[str, ...], latent_axis: Optional[str]) -> None:
        model = self.model
        if self.axis_name not in names:
            raise ValueError(f"axis_name {self.axis_name!r} is not an axis of the mesh {names}")
        device_type = next(model.parameters()).device.type
        if device_type != mesh.device_type:
            raise ValueError(f"the model's parameters are on {device_type}, the mesh is over {mesh.device_type}")
        self._rows = Blocks.over(mesh.get_group(self.axis_name))
        self._groups = tuple(mesh.get_group(n) for n in names if n != latent_axis)
        if latent_axis is not None:
            q_mu = getattr(model, "q_mu", None)
            q_sqrt = getattr(model, "q_sqrt", None)
            if q_mu is None or q_sqrt is None:
                raise ValueError(
                    "latent_axis requires a model with (q_mu, q_sqrt) "
                    "variational parameters (e.g. SVGP)"
                )
            L = q_sqrt.shape[0] if q_sqrt.ndim == 3 else q_sqrt.shape[-1]
            latents = Blocks.over(mesh.get_group(latent_axis), L, "number of latent GPs")
            posterior = getattr(model, "posterior", None)
            if posterior is None or (latents.size > 1 and not isinstance(
                    posterior(PrecomputeCacheType.NOCACHE), IndependentPosteriorMultiOutput)):
                raise ValueError(
                    "latent_axis splits the independent latent GPs of an SVGP (SharedIndependent, "
                    "SeparateIndependent or LinearCoregionalization over shared or separate inducing points)"
                )
            self._latents = latents
            # q_mu [M, L] and a diagonal q_sqrt [M, L] split by columns, a full q_sqrt [L, ...] by its first axis
            for p, dim in ((q_mu, 1), (q_sqrt, 0 if q_sqrt.ndim == 3 else 1)):
                local = latents.local(p.unconstrained.detach(), dim).clone()
                self._split[id(p)] = (torch.nn.Parameter(local, requires_grad=p.trainable), dim)

    def _leaf(self, p: Parameter) -> torch.Tensor:
        """The tensor that this trainer updates for ``p``: this rank's block
        where the latent GPs are split, else ``p``'s own."""
        split = self._split.get(id(p))
        return p.unconstrained if split is None else split[0]

    @contextlib.contextmanager
    def _on_mesh(self) -> Iterator[None]:
        """The model as this rank sees it inside a step: its row and latent
        blocks, and this rank's latent-GP tensors in q_mu's and q_sqrt's
        place."""
        if self.mesh is None:
            yield
            return
        model = self.model
        originals = []
        model._row_blocks = self._rows
        if self._latents is not None:
            model._latent_blocks = self._latents
        for p in (model.q_mu, model.q_sqrt) if self._split else ():
            originals.append((p, p._parameters["unconstrained"]))
            p._parameters["unconstrained"] = self._split[id(p)][0]
        try:
            yield
        finally:
            for p, original in originals:
                p._parameters["unconstrained"] = original
            del model._row_blocks
            if self._latents is not None:
                del model._latent_blocks

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

    def _optimizer_step(self, grads: Sequence[Optional[torch.Tensor]]) -> None:
        """The update outside a trace: ``_update``'s, else ``step()``."""
        if self._update is not None:
            self._update.step(grads)
            return
        for p, g in zip(self._params, grads):
            p.grad = g
        self.optimizer.step()

    def _natgrad_step(self, vgrads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The natural-gradient step on (q_mu, q_sqrt) from the gradients of
        their unconstrained tensors; returns the acceptance flag. Where the
        latent GPs are split, the ranks take or reject the step together."""
        q_mu, q_sqrt = self._vparams
        agree = None if self._latents is None else self._latents.all_true
        return self._natgrad._natgrad_apply_gradients(vgrads[0], vgrads[1], q_mu, q_sqrt, agree=agree)

    def _train_step(self, batch: Tuple[torch.Tensor, ...]) -> torch.Tensor:
        """One step: without a mesh the traced step replayed (``_traced``),
        the optimizer's update inside it where it has an ``Update``; on a
        mesh the step run eagerly, then the update. A rejected
        natural-gradient step is added to the device count."""
        if self.mesh is None:
            gamma = None if self.natgrad_gamma is None else self._natgrad.gamma
            update = None if self._update is None else (*self._update.prepare(), self._update.statics())
            loss, grads, ok, present, buffers = self._traced(self.model, batch, gamma, update)
            if update is not None:
                self._update.commit(present, buffers)
        else:
            with self._on_mesh():
                loss, grads, ok = self._step_on(batch)
        if grads is not None:
            self._optimizer_step(grads)
        if ok is not None:
            self._rejections += (~ok).to(torch.int64)
        return loss

    def _grads(self, loss: torch.Tensor, leaves: Sequence[torch.Tensor]) -> Sequence[Optional[torch.Tensor]]:
        """The gradients of ``leaves``; on a mesh the global ones: this
        rank's gradients of the lifted objective (``_sharding``) summed over
        the ranks that hold each leaf and divided by the mesh's size. They
        are summed in one flat tensor, the latent-split leaves first: one
        all-reduce of it all over every axis but the latent one and, for the
        leaves that every latent rank holds whole, one more of its tail over
        the latent axis. A leaf this rank did not read (another latent GP's
        kernel) counts 0; without a mesh such a leaf has no gradient (None),
        and the optimizer leaves it, as after ``backward()``."""
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        if self.mesh is None:
            return grads
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
        split = {id(local) for local, _ in self._split.values()}
        order = sorted(range(len(leaves)), key=lambda i: id(leaves[i]) not in split)
        sizes = [grads[i].numel() for i in order]
        flat = torch.cat([grads[i].reshape(-1) for i in order])
        for group in self._groups:
            dist.all_reduce(flat, group=group)
        n_split = sum(n for i, n in zip(order, sizes) if id(leaves[i]) in split)
        if self._latents is not None and n_split < flat.numel():
            dist.all_reduce(flat[n_split:], group=self._latents.group)
        flat = flat / self.mesh.size()
        out = list(grads)
        for i, g in zip(order, torch.split(flat, sizes)):
            out[i] = with_layout(g.view(grads[i].shape), grads[i])
        return out

    def _step_on(
        self, batch: Tuple[torch.Tensor, ...]
    ) -> Tuple[torch.Tensor, Optional[Sequence[Optional[torch.Tensor]]], Optional[torch.Tensor]]:
        """A step's part before the optimizer's update: the loss, the
        optimizer's gradients (None without parameters for it) and the
        natural-gradient step's acceptance flag (None without it), with
        (q_mu, q_sqrt) written in place. It reads every tensor through the
        model's Parameters, so that it traces."""
        leaves = [self._leaf(p) for p in self._train_params]
        if not self._vparams:
            loss = self.model._training_loss(batch)
            return loss.detach(), self._grads(loss, leaves), None
        vleaves = [p.unconstrained for p in self._vparams]
        if self.natgrad_fused and leaves:
            # one forward and backward pass for both gradient sets
            loss = self.model._training_loss(batch)
            grads = self._grads(loss, vleaves + leaves)
            return loss.detach(), grads[2:], self._natgrad_step(grads[:2])
        # the natural-gradient step at the current hyperparameters, then
        # the optimizer's gradient at the new q(u)
        ok = self._natgrad_step(self._grads(self.model._training_loss(batch), vleaves))
        if not leaves:
            with torch.no_grad():
                return self.model._training_loss(batch), None, ok
        loss = self.model._training_loss(batch)
        return loss.detach(), self._grads(loss, leaves), ok

    def _model_step(self, model: Module, batch: Tuple[torch.Tensor, ...], gamma: Optional[float],
                    update: Optional[Tuple[Any, Any, Any]]) -> Tuple[Any, ...]:
        """A step as a function of the model (the trace's inputs) and the
        batch; ``gamma``, the natural-gradient step's size that the body
        reads, is a static of the key. ``_step_on``'s loss, gradients and
        acceptance flag; with ``update`` (the optimizer's state and this
        step's scalars from ``Update.prepare``, which are inputs, and its
        hyperparameters, statics) the update too, which takes the gradients
        (None in their place) and gives which parameters had one and SGD's
        new momentum buffers for ``Update.commit``."""
        del model, gamma
        loss, grads, ok = self._step_on(batch)
        if update is None:
            return loss, grads, ok, (), ()
        state, scalars, _ = update
        # the leaves as the body sees them: the trace's tensors, updated in place
        present, buffers = self._update.apply([self._leaf(p) for p in self._train_params], grads, state, scalars)
        return loss, None, ok, present, buffers

    def _row_block(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        if self._rows is None:
            return t
        return Blocks.over(self._rows.group, t.shape[dim], "the batch's rows").local(t, dim)

    def shard(self, batch: Tuple[Any, ...]) -> Tuple[torch.Tensor, ...]:
        """This rank's rows of a batch (X [B, D], Y [B, P]) on the model's
        device: the block of B/d rows that the data axis gives it (all of
        them without a mesh). The result is what ``step(...,
        presharded=True)`` takes."""
        return tuple(self._row_block(t, 0) for t in self._to_device(batch))

    def shard_stacked(self, batches: Tuple[Any, ...]) -> Tuple[torch.Tensor, ...]:
        """``shard`` for stacked batches [K, B, ...]: this rank's rows of
        each, to prefetch ahead of ``run_steps(..., presharded=True)``."""
        return tuple(self._row_block(t, 1) for t in self._to_device(batches))

    def step(self, batch: Tuple[Any, ...], presharded: bool = False) -> torch.Tensor:
        """One optimization step on (X [B, D], Y [B, P]) (with
        ``presharded``, this rank's rows from ``shard``); returns the loss on
        the device (see ``natgrad_gamma`` for which loss)."""
        return self._train_step(batch if presharded else self.shard(batch))

    def run_steps(self, batches: Tuple[Any, ...], presharded: bool = False) -> torch.Tensor:
        """K steps on stacked batches X [K, B, D], Y [K, B, P] (with
        ``presharded``, from ``shard_stacked``); returns the per-step losses
        [K] on the device. Batches already on the model's device are used as
        they are, without a host transfer."""
        X, Y = batches if presharded else self.shard_stacked(batches)
        return torch.stack([self._train_step((X[k], Y[k])) for k in range(X.shape[0])])

    def stage_data(self, data: Tuple[Any, ...]) -> None:
        """Places the whole training set (X [N, D], Y [N, P]) on the model's
        device, once, for ``run_steps_sampled``; every rank holds all of it."""
        self._staged_data = self._to_device(data)

    def run_steps_sampled(
        self, n_steps: int, batch_size: int, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """``n_steps`` steps, each on a minibatch of ``batch_size`` rows drawn
        uniformly with replacement from the staged data, the indices drawn
        on the device with ``generator`` (a ``torch.Generator`` on the
        model's device; by default one seeded with the count of earlier
        calls). On a mesh every rank draws the same global indices from its
        own generator, seeded alike, and steps on its block of them. Returns
        the per-step losses [n_steps] on the device."""
        if self._staged_data is None:
            raise ValueError("Call stage_data(data) before run_steps_sampled")
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(self._sample_counter)
            self._sample_counter += 1
        X, Y = self._staged_data
        idx = torch.randint(0, X.shape[0], (n_steps, batch_size), device=self.device, generator=generator)
        idx = self._row_block(idx, 1)
        return torch.stack([self._train_step((X.index_select(0, i), Y.index_select(0, i))) for i in idx])

    def loss(self, batch: Tuple[Any, ...], presharded: bool = False) -> torch.Tensor:
        """The loss on one batch, without a step."""
        batch = batch if presharded else self.shard(batch)
        with torch.no_grad(), self._on_mesh():
            return self.model._training_loss(batch).detach()

    def finalize(self) -> None:
        """Writes the latent-split variational parameters, gathered, back
        into the model. Without a latent axis nothing is left to write: the
        steps update the model's parameters in place."""
        with torch.no_grad():
            for p in (self.model.q_mu, self.model.q_sqrt) if self._split else ():
                local, dim = self._split[id(p)]
                p.unconstrained.copy_(self._latents.gather(local.detach(), dim))

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

    def _state_leaves(self) -> List[Tuple[torch.Tensor, Optional[int]]]:
        """The trainable unconstrained parameters, the natural-gradient ones
        (q_mu, q_sqrt) and the optimizer's state (by parameter, its entries
        by name), in that order, each with the dimension along which it is
        split over the latent axis (None: whole on every rank)."""
        train = [p for p in self.model.trainable_parameters if all(p is not v for v in self._vparams)]
        dims = [self._split.get(id(p), (None, None))[1] for p in train]
        leaves = [(t.detach(), d) for t, d in zip(self._params, dims)]
        leaves += [(self._leaf(p).detach(), self._split.get(id(p), (None, None))[1]) for p in self._vparams]
        opt = self._optimizer_state()
        for i in sorted(opt):
            for k in sorted(opt[i]):
                same = opt[i][k].shape == self._params[i].shape
                leaves.append((opt[i][k], dims[i] if same else None))
        return leaves

    def state_dict(self) -> Dict[str, np.ndarray]:
        """A host snapshot of the optimization state: the trainable
        parameters, the natural-gradient parameters and the optimizer's
        state, as ``leaf_XXXX`` numpy arrays in their whole form (the latent
        GPs' blocks gathered from every rank; a collective on a mesh). Like
        the JAX package, it holds no sampling counter: ``run_steps_sampled``
        after a restore draws as a fresh trainer does unless it is given a
        generator."""
        return {
            f"leaf_{i:04d}": (t if d is None else self._latents.gather(t.contiguous(), d)).cpu().numpy().copy()
            for i, (t, d) in enumerate(self._state_leaves())
        }

    def load_state_dict(self, host_state: Dict[str, Any]) -> None:
        """Restores a ``state_dict`` snapshot into this trainer, each leaf in
        the dtype and on the device of this trainer's own and, where the
        latent GPs are split, this rank's block of it: the saving trainer's
        mesh may have had another shape."""
        leaves = self._state_leaves()
        saved = [np.asarray(host_state[k]) for k in sorted(host_state)]
        if len(saved) != len(leaves):
            raise ValueError(
                f"checkpoint has {len(saved)} leaves, trainer state has "
                f"{len(leaves)} — model/optimizer structure mismatch"
            )
        placed = []
        for (cur, dim), new in zip(leaves, saved):
            new = torch.as_tensor(new).to(device=cur.device, dtype=cur.dtype)
            if dim is not None and new.ndim == cur.ndim and new.shape[dim] == cur.shape[dim] * self._latents.size:
                new = self._latents.local(new, dim)
            if tuple(cur.shape) != tuple(new.shape):
                raise ValueError(
                    f"checkpoint leaf shape {tuple(new.shape)} != trainer leaf "
                    f"shape {tuple(cur.shape)}"
                )
            placed.append(new)
        n_params = len(self._params) + len(self._vparams)
        with torch.no_grad():
            for p, new in zip(self._params + [self._leaf(p) for p in self._vparams], placed):
                p.copy_(new)
        if self.optimizer is not None:
            opt = self._optimizer_state()
            rest = iter(placed[n_params:])
            self.optimizer.load_state_dict({
                "state": {i: {k: next(rest).clone() for k in sorted(opt[i])} for i in sorted(opt)},
                "param_groups": self.optimizer.state_dict()["param_groups"],
            })

    def _mesh_groups(self) -> Tuple[Any, ...]:
        return tuple(self.mesh.get_group(n) for n in self.mesh.mesh_dim_names)

    def save_state(self, path: str) -> None:
        """Saves ``state_dict`` to the npz file ``path`` (``.npz`` is added
        where missing). On a mesh every rank gathers, the mesh's first rank
        writes, and every rank returns once the file is written."""
        host = self.state_dict()
        writer = not self._outside and (self.mesh is None or dist.get_rank() == int(self.mesh.mesh.reshape(-1)[0]))
        if writer:
            np.savez(path if path.endswith(".npz") else path + ".npz", **host)
        if self.mesh is not None:
            for group in self._mesh_groups():
                dist.barrier(group=group)

    def load_state(self, path: str) -> None:
        """Restores a ``save_state`` file into this trainer."""
        with np.load(path if path.endswith(".npz") else path + ".npz") as npz:
            self.load_state_dict({k: npz[k] for k in npz.files})
