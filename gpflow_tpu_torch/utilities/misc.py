"""Misc utilities (counterpart of ``gpflow_tpu/utilities/misc.py``;
``set_trainable`` and ``to_default_float`` so far)."""
from __future__ import annotations

from typing import Any, Iterable, Union

import torch

from ..base import Module, Parameter
from ..config import default_device, default_float

__all__ = ["set_trainable", "to_default_float"]


def to_default_float(x: Any) -> torch.Tensor:
    """``x`` as a tensor of ``default_float()`` (``gpflow_tpu/utilities/misc.py:36``):
    a tensor keeps its device, anything else goes to ``config.default_device()``."""
    if isinstance(x, torch.Tensor):
        return x.to(default_float())
    return torch.as_tensor(x, dtype=default_float(), device=default_device())


def set_trainable(model: Union[Module, Parameter, Iterable[Union[Module, Parameter]]], flag: bool) -> None:
    """Sets the trainability of every Parameter under ``model``
    (``gpflow_tpu/utilities/misc.py:40``); a frozen Parameter's
    unconstrained tensor has ``requires_grad=False``."""
    if isinstance(model, Module):
        for p in model.modules():
            if isinstance(p, Parameter):
                p.trainable = flag
        return
    for m in model:
        set_trainable(m, flag)
