"""Misc utilities (counterpart of ``gpflow_tpu/utilities/misc.py``;
``set_trainable`` only so far)."""
from __future__ import annotations

from typing import Iterable, Union

from ..base import Module, Parameter

__all__ = ["set_trainable"]


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
