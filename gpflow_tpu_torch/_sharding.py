"""Rows and latent GPs of a model split over ``torch.distributed`` groups:
the differentiable collectives of ``parallel/`` and the records that tell a
model which block its rank holds.

Every rank runs the same program (SPMD) and ends with the same loss L,
computed from its own block of rows (or of latent GPs) and collectives. The
gradient rule: an all-reduce or all-gather reduces its cotangent over the
same group in the backward pass, and a Parameter's cotangent is summed
over the ranks that hold the Parameter and divided by the size W of the
mesh: at each read of a Parameter of a model split by
``shard_internal_data`` (``ReadHook``), or once a step over the trainer's
gradients (``DataParallelTrainer``). The result is, for every Parameter,
the gradient of the lifted objective (1/W) sum_r L_r with respect to the
whole set of copies of the Parameter, which is dL/dtheta: so every rank
holds the global gradient, as XLA's sharded program gives it in the JAX
package. Replicated computations need no care; only the collectives
below may combine ranks. With one rank every collective copies and every
scale is 1, so a one-rank mesh computes the same bits as no mesh.

The order of the collectives must be the same on every rank: every rank
calls the same entry points with arguments of the same shapes.

Every collective here traces (``_compile.jit``, the trainer's step, its
loss, ``sharded_predict_f``): the trace holds its ``c10d`` op and its wait,
in place on the tensors it is given as eagerly (a view, a list of
outputs), and a replay runs them. ``Blocks`` and ``ReadHook`` are frozen
records, statics of a trace's key compared by value (the group, the rank,
the sizes).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

import torch
import torch.distributed as dist


def _reduced(t: torch.Tensor, groups: Sequence[Any]) -> torch.Tensor:
    """The sum of ``t`` over each of ``groups`` in turn, in a new tensor of
    ``t``'s layout: an operation downstream then meets the strides it would
    meet without the mesh (a matmul's kernel, and so its rounding, can
    depend on them)."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(out, group=group)
    return with_layout(out, t)


def with_layout(values: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``values`` in a tensor of ``like``'s strides (itself where they agree)."""
    if values.stride() == like.stride():
        return values
    return torch.empty_like(like).copy_(values)


class _AllReduce(torch.autograd.Function):
    """Sum over ``group``; the backward sums the cotangent over it too."""

    @staticmethod
    def forward(ctx: Any, t: torch.Tensor, group: Any) -> torch.Tensor:
        ctx.group = group
        return _reduced(t, (group,))

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None]:
        return _reduced(g, (ctx.group,)), None


class _AllGather(torch.autograd.Function):
    """The ranks' equal blocks concatenated along ``dim`` in rank order; the
    backward sums the cotangent over the group and keeps this rank's block."""

    @staticmethod
    def forward(ctx: Any, t: torch.Tensor, group: Any, dim: int) -> torch.Tensor:
        size = dist.get_world_size(group)
        ctx.group, ctx.dim, ctx.block = group, dim, t.shape[dim]
        ctx.start = dist.get_rank(group) * t.shape[dim]
        local = t.detach().contiguous()
        parts = [torch.empty_like(local) for _ in range(size)]
        dist.all_gather(parts, local, group=group)
        return with_layout(parts[0], t) if size == 1 else torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None, None]:
        return _reduced(g, (ctx.group,)).narrow(ctx.dim, ctx.start, ctx.block), None, None


class _ReadGradient(torch.autograd.Function):
    """Identity; the backward sums the cotangent over ``groups`` in turn and
    divides it by ``world``."""

    @staticmethod
    def forward(ctx: Any, t: torch.Tensor, groups: Tuple[Any, ...], world: int) -> torch.Tensor:
        ctx.groups, ctx.world = groups, world
        return t.view_as(t)

    @staticmethod
    def backward(ctx: Any, g: torch.Tensor) -> Tuple[torch.Tensor, None, None]:
        return _reduced(g, ctx.groups) / ctx.world, None, None


@dataclasses.dataclass(frozen=True)
class ReadHook:
    """The read rule of a Parameter of a sharded model: its cotangent is
    summed over ``groups`` (the groups whose ranks hold other copies of it)
    and divided by ``world``, the number of ranks of the mesh."""

    groups: Tuple[Any, ...]
    world: int

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if not (t.requires_grad and torch.is_grad_enabled()):
            return t
        return _ReadGradient.apply(t, self.groups, self.world)


@dataclasses.dataclass(frozen=True)
class Blocks:
    """This rank's block of a dimension split evenly over ``group``: block
    ``rank`` of ``size``, each of ``count // size`` entries (``count`` 0:
    a dimension whose length each call brings, such as a batch's rows)."""

    group: Any
    rank: int
    size: int
    count: int

    @classmethod
    def over(cls, group: Any, count: int = 0, what: str = "") -> "Blocks":
        size = dist.get_world_size(group)
        if count % size:
            raise ValueError(f"{what} ({count}) must be divisible by the mesh axis size ({size})")
        return cls(group, dist.get_rank(group), size, count)

    @property
    def start(self) -> int:
        return self.rank * (self.count // self.size)

    def local(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's block of a whole tensor (a view)."""
        return t.narrow(dim, self.start, self.count // self.size)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``t``, differentiable."""
        return _AllReduce.apply(t, self.group)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's block of ``t`` along ``dim``, in rank order."""
        return _AllGather.apply(t, self.group, dim)

    def all_true(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean tensor that is true where it is true on every rank."""
        t = flag.to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.group)
        return t.bool()


class _Whole:
    """The record of a model that is not split: every operation is the
    identity, so its arithmetic is that of the code without a mesh."""

    size = 1
    start = 0

    @staticmethod
    def local(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    @staticmethod
    def sum(t: torch.Tensor) -> torch.Tensor:
        return t

    @staticmethod
    def gather(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t

    @staticmethod
    def all_true(flag: torch.Tensor) -> torch.Tensor:
        return flag


WHOLE = _Whole()


def rows_of(module: Any) -> Any:
    """The row blocks of a model whose data rows (or minibatch rows) are
    split over a mesh axis, else ``WHOLE``."""
    rows = module.__dict__.get("_row_blocks")
    return WHOLE if rows is None else rows


def kernel_rows(module: Any, kernel: Any, X: torch.Tensor) -> torch.Tensor:
    """K(X, X) of the whole X [N, D]; where ``module``'s rows are split, each
    rank builds its rows K(X_block, X) and the blocks are gathered (the
    Cholesky that follows needs the whole matrix on every rank)."""
    rows = rows_of(module)
    if rows is WHOLE:
        return kernel(X)
    return rows.gather(kernel(rows.local(X), X))


def share_blocks(source: Any, target: Any) -> None:
    """Gives ``target`` (a posterior built from ``source``) the row and
    latent-GP blocks of ``source``."""
    for name in ("_row_blocks", "_latent_blocks"):
        blocks = source.__dict__.get(name)
        if blocks is not None:
            setattr(target, name, blocks)


def latents_of(module: Any) -> Any:
    """The latent-GP blocks of a model whose latent GPs are split over a
    mesh axis, else ``WHOLE``."""
    latents = module.__dict__.get("_latent_blocks")
    return WHOLE if latents is None else latents
