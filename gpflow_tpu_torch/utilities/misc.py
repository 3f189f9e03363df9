"""Misc utilities (counterpart of ``gpflow_tpu/utilities/misc.py``)."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Sequence, Union

import torch

from ..base import Module, Parameter
from ..config import default_device, default_float, default_int
from .shapes import check_shapes

__all__ = [
    "is_variable",
    "positive_parameter",
    "set_trainable",
    "to_default_float",
    "to_default_int",
    "training_loop",
]

OptimizerFactory = Callable[[Sequence[torch.nn.Parameter]], torch.optim.Optimizer]


def _to_default(x: Any, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, Parameter):
        x = x.value
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return torch.as_tensor(x, dtype=dtype, device=default_device())


@check_shapes(
    "x: [any...]",
    "return: [any...]",
)
def to_default_int(x: Any) -> torch.Tensor:
    """``x`` as a tensor of ``default_int()`` (``gpflow_tpu/utilities/misc.py:24-29``):
    a tensor keeps its device, anything else goes to ``config.default_device()``."""
    return _to_default(x, default_int())


@check_shapes(
    "x: [any...]",
    "return: [any...]",
)
def to_default_float(x: Any) -> torch.Tensor:
    """``x`` as a tensor of ``default_float()`` (``gpflow_tpu/utilities/misc.py:32-37``):
    a tensor keeps its device, anything else goes to ``config.default_device()``."""
    return _to_default(x, default_float())


def set_trainable(model: Union[Module, Parameter, Iterable[Union[Module, Parameter]]], flag: bool) -> None:
    """Sets the trainability of every Parameter under ``model``
    (``gpflow_tpu/utilities/misc.py:40``); a frozen Parameter's
    unconstrained tensor has ``requires_grad=False``."""
    if isinstance(model, Module):
        for p in model.all_parameters:
            p.trainable = flag
        return
    for m in model:
        set_trainable(m, flag)


def is_variable(t: Any) -> bool:
    """True if ``t`` is trainable state, a Parameter
    (``gpflow_tpu/utilities/misc.py:54-57``)."""
    return isinstance(t, Parameter)


def positive_parameter(value: Any) -> Parameter:
    """``value`` as a Parameter with the ``positive()`` transform; a
    Parameter is returned as it is (``gpflow_tpu/utilities/misc.py:60-65``)."""
    from ..bijectors import positive

    if isinstance(value, Parameter):
        return value
    return Parameter(value, transform=positive())


def training_loop(
    closure: Callable[[], torch.Tensor],
    optimizer: Optional[OptimizerFactory] = None,
    var_list: Optional[Iterable[Parameter]] = None,
    maxiter: int = 1000,
    compile: bool = False,
    learning_rate: float = 0.01,
    use_scan: bool = False,
) -> torch.Tensor:
    """Optimizes the Parameters that ``closure`` reads for ``maxiter`` steps
    (``gpflow_tpu/utilities/misc.py:68-151``) and returns the [maxiter] loss
    history, each loss taken before its step's update.

    ``closure`` is a zero-argument callable returning the loss, such as
    ``model.training_loss``, ``model.training_loss_closure(data)`` or a
    lambda. ``var_list`` defaults to the trainable parameters of the object a
    bound-method closure belongs to; any other closure needs it. Each step
    differentiates the loss with respect to ``var_list``'s unconstrained
    tensors only and lets the optimizer update them in place. ``optimizer`` is
    a factory from those tensors to a ``torch.optim.Optimizer``; by default
    ``parallel.adam(learning_rate)``, optax's Adam (0.9, 0.999, 1e-8).

    The steps are queued without waiting for the device: no loss is read on
    the host, and the history comes back as one tensor on the loss's device.
    ``use_scan=True`` keeps the JAX package's contract (the same history,
    and a ``ValueError`` together with ``compile=True``) and runs the same
    loop: torch has no scan to fuse the steps into. ``compile`` is accepted
    and the loss runs eagerly.
    """
    if var_list is not None:
        params = tuple(var_list)
    else:
        model = getattr(closure, "__self__", None)
        if model is None:
            raise ValueError(
                "training_loop needs `var_list` when `closure` is not a bound "
                "method (it cannot infer which parameters to optimize)"
            )
        params = tuple(model.trainable_parameters)
    if use_scan and compile:
        raise ValueError(
            "training_loop(use_scan=True) takes no `compile`: "
            "pass compile=False (the default)"
        )
    if optimizer is None:
        from ..parallel.trainer import adam

        optimizer = adam(learning_rate)
    tensors = [p.unconstrained for p in params]
    opt = optimizer(tensors)
    losses = []
    for _ in range(maxiter):
        loss = closure()
        grads = torch.autograd.grad(loss, tensors, allow_unused=True, materialize_grads=True)
        for t, g in zip(tensors, grads):
            t.grad = g
        opt.step()
        losses.append(loss.detach())
    for t in tensors:
        t.grad = None
    if losses:
        return torch.stack(losses)
    device = tensors[0].device if tensors else default_device()
    return torch.zeros((0,), dtype=default_float(), device=device)
