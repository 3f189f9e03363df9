"""``Module`` and ``Parameter`` (counterpart of ``gpflow_tpu/base.py``).

A ``Module`` is a ``torch.nn.Module``. A ``Parameter`` is a small module that
holds the unconstrained value as a ``torch.nn.Parameter`` together with its
bijector, and exposes the constrained value as ``.value``. A Parameter is
built on ``config.default_device()`` (the card unless the caller asks for
another device); models move between devices and dtypes with ``.to()``. A
Parameter that is not trainable has ``requires_grad=False``;
``Module.trainable_parameters`` lists the trainable ones, whose
``unconstrained`` tensors an optimizer takes.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .bijectors import Bijector, Identity
from .config import as_torch_dtype, default_device, default_float

__all__ = ["MeanAndVariance", "Module", "Parameter"]

MeanAndVariance = Tuple[torch.Tensor, torch.Tensor]


class Module(nn.Module):
    """Base class of kernels, likelihoods, inducing variables and models."""

    @property
    def name(self) -> str:
        return getattr(self, "_name", None) or type(self).__name__.lower()

    @property
    def trainable_parameters(self) -> Tuple["Parameter", ...]:
        """The trainable Parameters under this module, in registration order
        (``gpflow_tpu/base.py:725-731``)."""
        return tuple(m for m in self.modules() if isinstance(m, Parameter) and m.trainable)

    @property
    def trainable_variables(self) -> Tuple["Parameter", ...]:
        """Alias of ``trainable_parameters`` (``gpflow_tpu/base.py:729``), the
        name an optimizer such as ``Scipy`` is handed."""
        return self.trainable_parameters


def _to_tensor(value: Any, dtype: Any, device: Optional[torch.device] = None) -> torch.Tensor:
    """A fresh tensor holding ``value``. With ``dtype=None``, a tensor or
    numpy array that carries a float dtype keeps it; Python scalars, lists and
    integer arrays take ``default_float()``, as ``gpflow_tpu/base.py:133-158``
    does."""
    if isinstance(value, Parameter):
        value = value.value.detach()
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if dtype is None:
            dtype = t.dtype if t.is_floating_point() else default_float()
        return t.to(device=device if device is not None else t.device,
                    dtype=as_torch_dtype(dtype), copy=True)
    has_explicit_dtype = isinstance(value, (np.ndarray, np.generic))
    arr = np.asarray(value)
    if dtype is None:
        dtype = arr.dtype if has_explicit_dtype and np.issubdtype(arr.dtype, np.floating) else default_float()
    return torch.tensor(arr, dtype=as_torch_dtype(dtype), device=device)


def _validate_finite(value: torch.Tensor, name: str) -> None:
    if not bool(torch.all(torch.isfinite(value))):
        raise ValueError(f"Parameter {name!r}: assigned value contains NaN or Inf")


class Parameter(Module):
    """A constrained parameter: ``value = transform.forward(unconstrained)``.

    Construction and ``assign`` take constrained values, check them (shape,
    NaN/Inf, and the transform's domain through the unconstrained value) and
    store the unconstrained tensor. ``trainable`` (default True, or the
    source's when ``value`` is a Parameter) is the unconstrained tensor's
    ``requires_grad``.
    """

    def __init__(
        self,
        value: Any,
        *,
        transform: Optional[Bijector] = None,
        trainable: Optional[bool] = None,
        dtype: Any = None,
        name: Optional[str] = None,
    ) -> None:
        super().__init__()
        if trainable is None:
            trainable = value.trainable if isinstance(value, Parameter) else True
        self.transform = transform if transform is not None else Identity()
        self._name = name or "parameter"
        unconstrained = self.transform.inverse(_to_tensor(value, dtype, default_device()))
        _validate_finite(unconstrained, self.name)
        self.unconstrained = nn.Parameter(unconstrained, requires_grad=bool(trainable))

    @property
    def trainable(self) -> bool:
        return self.unconstrained.requires_grad

    @trainable.setter
    def trainable(self, flag: bool) -> None:
        self.unconstrained.requires_grad_(bool(flag))

    @property
    def value(self) -> torch.Tensor:
        return self.transform.forward(self.unconstrained)

    @property
    def shape(self) -> torch.Size:
        return self.unconstrained.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.unconstrained.dtype

    @property
    def device(self) -> torch.device:
        return self.unconstrained.device

    def numpy(self) -> np.ndarray:
        """A copy of the constrained value (never a view of the parameter's
        storage, which the optimizer updates in place)."""
        return np.array(self.value.detach().cpu())

    def _prepare_assign(self, value: Any) -> torch.Tensor:
        """The unconstrained tensor for a constrained ``value``, checked,
        without changing the parameter."""
        constrained = _to_tensor(value, self.dtype, self.device)
        if constrained.shape != self.shape:
            raise ValueError(
                f"Parameter {self.name!r}: cannot assign value of shape "
                f"{tuple(constrained.shape)} to parameter of shape {tuple(self.shape)}"
            )
        unconstrained = self.transform.inverse(constrained)
        _validate_finite(unconstrained, self.name)
        return unconstrained

    def _set_unconstrained(self, unconstrained: torch.Tensor) -> None:
        with torch.no_grad():
            self.unconstrained.copy_(unconstrained)

    def assign(self, value: Any) -> None:
        """Assigns a new constrained value."""
        self._set_unconstrained(self._prepare_assign(value))

    def extra_repr(self) -> str:
        return (
            f"name={self.name!r}, transform={self.transform.name}, trainable={self.trainable}, "
            f"shape={tuple(self.shape)}, dtype={self.dtype}"
        )
