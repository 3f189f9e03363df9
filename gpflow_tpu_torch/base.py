"""``Module`` and ``Parameter`` (counterpart of ``gpflow_tpu/base.py``).

A ``Module`` is a ``torch.nn.Module``. A ``Parameter`` is a small module that
holds the unconstrained value as a ``torch.nn.Parameter`` together with its
bijector and an optional prior, and exposes the constrained value as
``.value``. A Parameter is built on ``config.default_device()`` (the card
unless the caller asks for another device); models move between devices and
dtypes with ``.to()``. A Parameter that is not trainable has
``requires_grad=False``; ``Module.trainable_parameters`` lists the trainable
ones, whose ``unconstrained`` tensors an optimizer takes. ``functionalize``
turns a closure over Parameters into a pure function of their unconstrained
values, and ``capture_parameter_reads`` lists the Parameters a block reads.
"""
from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from .bijectors import Bijector, Identity
from .config import as_torch_dtype, default_device, default_float

if TYPE_CHECKING:  # priors -> logdensities -> utilities, whose __init__ imports this module
    from .priors import Prior

__all__ = [
    "AnyNDArray",
    "InputData",
    "MeanAndVariance",
    "Module",
    "OutputData",
    "Parameter",
    "PriorOn",
    "RegressionData",
    "TensorData",
    "TensorLike",
    "TensorType",
    "Transform",
    "capture_parameter_reads",
    "functionalize",
]

# type aliases (``gpflow_tpu/base.py:46-60``)
TensorType = Union[np.ndarray, torch.Tensor, "Parameter"]
# a tuple of types is a union signature when registering with a Dispatcher
TensorLike: Tuple[type, ...] = (object,)
AnyNDArray = np.ndarray
TensorData = Union[np.ndarray, torch.Tensor, "Parameter"]
Transform = Union[Bijector]
MeanAndVariance = Tuple[torch.Tensor, torch.Tensor]
# what models take as data
InputData = TensorType
OutputData = TensorType
RegressionData = Tuple[InputData, OutputData]


class PriorOn(enum.Enum):
    """Where a parameter's prior density is evaluated (``gpflow_tpu/base.py:63-70``)."""

    CONSTRAINED = "constrained"
    UNCONSTRAINED = "unconstrained"


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


# The open ``capture_parameter_reads`` blocks, innermost last: each read of a
# Parameter's value is appended to the innermost one's list.
_PARAM_READ_CAPTURE: List[List["Parameter"]] = []


class capture_parameter_reads:
    """Collects every Parameter whose value is read inside the block
    (``value`` or ``log_prior_density``); afterwards ``.parameters`` holds
    them in first-read order, each once (``gpflow_tpu/base.py:80-100``)."""

    def __enter__(self) -> "capture_parameter_reads":
        self._raw: List["Parameter"] = []
        _PARAM_READ_CAPTURE.append(self._raw)
        self.parameters: List["Parameter"] = []
        return self

    def __exit__(self, *exc: Any) -> None:
        _PARAM_READ_CAPTURE.pop()
        seen: set = set()
        for p in self._raw:
            if id(p) not in seen:
                seen.add(id(p))
                self.parameters.append(p)


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
    store the unconstrained tensor. ``trainable`` (default True) is a flag of
    the Parameter, mirrored in the unconstrained tensor's ``requires_grad``.
    ``prior`` (a ``priors.Prior`` or None) is evaluated on the constrained
    value or, with ``prior_on=PriorOn.UNCONSTRAINED``, on the unconstrained
    one. Built from another Parameter, the new one inherits its
    ``trainable``, ``prior`` and ``prior_on`` unless they are given.
    """

    def __init__(
        self,
        value: Any,
        *,
        transform: Optional[Bijector] = None,
        prior: Optional[Prior] = None,
        prior_on: Optional[Union[str, PriorOn]] = None,
        trainable: Optional[bool] = None,
        dtype: Any = None,
        name: Optional[str] = None,
    ) -> None:
        super().__init__()
        if isinstance(value, Parameter):
            trainable = value.trainable if trainable is None else trainable
            prior = value.prior if prior is None else prior
            prior_on = value.prior_on if prior_on is None else prior_on
        self.transform = transform if transform is not None else Identity()
        self.prior = prior
        self.prior_on = PriorOn.CONSTRAINED if prior_on is None else prior_on
        self._name = name or "parameter"
        unconstrained = self.transform.inverse(_to_tensor(value, dtype, default_device()))
        _validate_finite(unconstrained, self.name)
        self._trainable = True if trainable is None else bool(trainable)
        self.unconstrained = nn.Parameter(unconstrained, requires_grad=self._trainable)

    @property
    def trainable(self) -> bool:
        return self._trainable

    @trainable.setter
    def trainable(self, flag: bool) -> None:
        self._trainable = bool(flag)
        self.unconstrained.requires_grad_(self._trainable)

    @property
    def prior_on(self) -> PriorOn:
        return self._prior_on

    @prior_on.setter
    def prior_on(self, value: Union[str, PriorOn]) -> None:
        self._prior_on = PriorOn(value)

    @property
    def value(self) -> torch.Tensor:
        if _PARAM_READ_CAPTURE:
            _PARAM_READ_CAPTURE[-1].append(self)
        return self.transform.forward(self.unconstrained)

    @property
    def shape(self) -> torch.Size:
        """The constrained value's shape (that of ``unconstrained`` but for a
        reshaping transform such as ``FillTriangular``)."""
        return self.transform.forward_shape(self.unconstrained.shape)

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
        # compared in unconstrained space, where a reshaping transform's
        # inverse has put the value
        unconstrained = self.transform.inverse(constrained)
        if unconstrained.shape != self.unconstrained.shape:
            raise ValueError(
                f"Parameter {self.name!r}: cannot assign value of shape "
                f"{tuple(constrained.shape)} to parameter of shape {tuple(self.shape)}"
            )
        _validate_finite(unconstrained, self.name)
        return unconstrained

    def _set_unconstrained(self, unconstrained: torch.Tensor) -> None:
        with torch.no_grad():
            self.unconstrained.copy_(unconstrained)

    def assign(self, value: Any) -> None:
        """Assigns a new constrained value."""
        self._set_unconstrained(self._prepare_assign(value))

    def assign_unconstrained(self, value: Any) -> None:
        """Assigns a new unconstrained value, unchecked
        (``gpflow_tpu/base.py:335-336``)."""
        self._set_unconstrained(_to_tensor(value, self.dtype, self.device))

    def log_prior_density(self) -> torch.Tensor:
        """The log prior density of the parameter, summed over its elements,
        with the change-of-variables term when the prior is on the
        unconstrained value (``gpflow_tpu/base.py:338-353``); 0 without a
        prior."""
        if _PARAM_READ_CAPTURE:
            _PARAM_READ_CAPTURE[-1].append(self)
        if self.prior is None:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        if self.prior_on is PriorOn.CONSTRAINED:
            return torch.sum(self.prior.log_prob(self.value))
        x = self.unconstrained
        return torch.sum(self.prior.log_prob(x)) - torch.sum(self.transform.forward_log_det_jacobian(x))

    def extra_repr(self) -> str:
        prior = "None" if self.prior is None else self.prior.name
        return (
            f"name={self.name!r}, transform={self.transform.name}, prior={prior}, trainable={self.trainable}, "
            f"shape={tuple(self.shape)}, dtype={self.dtype}"
        )


def functionalize(
    closure: Callable[[], Any], parameters: Sequence[Parameter]
) -> Callable[[Sequence[torch.Tensor]], Any]:
    """A pure function of the parameters' unconstrained values from a
    zero-argument ``closure`` that reads them (``gpflow_tpu/base.py:107-130``):
    each call puts the given tensors in the parameters' place, calls
    ``closure`` and puts the parameters' own tensors back, also when
    ``closure`` raises. The parameters' values never change."""

    def fn(unconstrained: Sequence[torch.Tensor]) -> Any:
        originals = [p._parameters["unconstrained"] for p in parameters]
        try:
            for p, u in zip(parameters, unconstrained):
                p._parameters["unconstrained"] = u
            return closure()
        finally:
            for p, o in zip(parameters, originals):
                p._parameters["unconstrained"] = o

    return fn
