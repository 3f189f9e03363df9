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
import itertools
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
    def all_parameters(self) -> Tuple["Parameter", ...]:
        """Every Parameter under this module, trainable or not, in
        registration order: the JAX package's ``Module.parameters``
        (``gpflow_tpu/base.py:718-723``), whose name here is torch's
        ``nn.Module.parameters()``, which ``torch.optim`` uses."""
        return tuple(m for m in self.modules() if isinstance(m, Parameter))

    @property
    def trainable_parameters(self) -> Tuple["Parameter", ...]:
        """The trainable Parameters under this module, in registration order
        (``gpflow_tpu/base.py:725-731``)."""
        return tuple(p for p in self.all_parameters if p.trainable)

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


def _module_device(module: nn.Module) -> torch.device:
    """The device of a module's first parameter or buffer, else
    ``config.default_device()``."""
    for t in itertools.chain(module.parameters(), module.buffers()):
        return t.device
    return default_device()


def input_to_tensor(module: nn.Module, value: Any) -> Any:
    """An argument of a public entry point as the computation takes it
    (``TensorType`` admits numpy arrays): a numpy array or a Python scalar
    becomes a tensor on the module's device, floating values (and Python
    scalars) in ``default_float()`` and integer or boolean arrays in their
    own dtype, as ``data_input_to_tensor`` builds a model's data; a tensor,
    a Parameter or None passes through as it is, with no copy, no move and
    no host synchronisation. Tuples and lists are walked."""
    if value is None or isinstance(value, (torch.Tensor, Parameter)):
        return value
    if isinstance(value, (tuple, list)):
        items = [input_to_tensor(module, v) for v in value]
        return type(value)(*items) if hasattr(value, "_fields") else type(value)(items)
    arr = np.asarray(value)
    floating = isinstance(value, (int, float)) or np.issubdtype(arr.dtype, np.floating)
    dtype = default_float() if floating else as_torch_dtype(arr.dtype)
    return torch.as_tensor(arr, dtype=dtype, device=_module_device(module))


def _validate_declared_shape(
    actual: Tuple[int, ...], declared: Optional[Sequence[Optional[int]]], name: str, kind: str
) -> None:
    """Checks a shape against a declared one whose None entries match any
    size (``gpflow_tpu/base.py:449-468``)."""
    if declared is None:
        return
    declared = tuple(declared)
    if len(declared) != len(actual) or any(d is not None and int(d) != a for d, a in zip(declared, actual)):
        raise ValueError(
            f"Parameter {name!r}: declared {kind} shape {declared} does not match actual shape {actual}."
        )


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
    ``trainable``, ``prior`` and ``prior_on`` unless they are given. A
    Parameter of a model split over a mesh carries a read rule
    (``_read_hook``, set by ``parallel/``) that each read of ``value``
    applies to the unconstrained tensor.
    """

    _read_hook: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

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
        unconstrained_value: Any = None,
        unconstrained_shape: Optional[Sequence[Optional[int]]] = None,
        constrained_shape: Optional[Sequence[Optional[int]]] = None,
        shape: Optional[Sequence[Optional[int]]] = None,
    ) -> None:
        """``unconstrained_value`` builds the Parameter from its
        unconstrained value instead of ``value`` (pass None as ``value``);
        ``unconstrained_shape`` and ``constrained_shape`` (or ``shape`` for
        both) declare shapes, None matching any size, which the value must
        have (``gpflow_tpu/base.py:187-250``)."""
        super().__init__()
        if isinstance(value, Parameter):
            trainable = value.trainable if trainable is None else trainable
            prior = value.prior if prior is None else prior
            prior_on = value.prior_on if prior_on is None else prior_on
        self._transform = transform if transform is not None else Identity()
        self.prior = prior
        self.prior_on = PriorOn.CONSTRAINED if prior_on is None else prior_on
        self._name = name or "parameter"
        if unconstrained_value is not None:
            if value is not None:
                raise ValueError(
                    "Pass either `value` or `unconstrained_value` to Parameter, "
                    "not both (the `value` would be silently ignored)."
                )
            unconstrained = _to_tensor(unconstrained_value, dtype, default_device())
        else:
            unconstrained = self.transform.inverse(_to_tensor(value, dtype, default_device()))
        _validate_finite(unconstrained, self.name)
        if shape is not None:
            if unconstrained_shape is not None or constrained_shape is not None:
                raise ValueError("Cannot set both `shape` and `unconstrained_shape` or `constrained_shape`.")
            unconstrained_shape = constrained_shape = shape
        _validate_declared_shape(tuple(unconstrained.shape), unconstrained_shape, self.name, "unconstrained")
        constrained = tuple(self.transform.forward_shape(unconstrained.shape))
        _validate_declared_shape(constrained, constrained_shape, self.name, "constrained")
        self._trainable = True if trainable is None else bool(trainable)
        self.unconstrained = nn.Parameter(unconstrained, requires_grad=self._trainable)

    @property
    def transform(self) -> Bijector:
        return self._transform

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
    def unconstrained_variable(self) -> torch.Tensor:
        """The unconstrained tensor, under the JAX package's name
        (``gpflow_tpu/base.py:277-280``)."""
        if _PARAM_READ_CAPTURE:
            _PARAM_READ_CAPTURE[-1].append(self)
        return self.unconstrained

    @property
    def value(self) -> torch.Tensor:
        if _PARAM_READ_CAPTURE:
            _PARAM_READ_CAPTURE[-1].append(self)
        u = self.unconstrained
        if self._read_hook is not None:
            u = self._read_hook(u)
        return self.transform.forward(u)

    @property
    def shape(self) -> torch.Size:
        """The constrained value's shape (that of ``unconstrained`` but for a
        reshaping transform such as ``FillTriangular``)."""
        return self.transform.forward_shape(self.unconstrained.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.unconstrained.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return self.unconstrained.device

    def numpy(self) -> np.ndarray:
        """A copy of the constrained value (never a view of the parameter's
        storage, which the optimizer updates in place)."""
        return np.array(self.value.detach().cpu())

    def __array__(self, dtype: Any = None, copy: Optional[bool] = None) -> np.ndarray:
        """``np.asarray(parameter)``: the constrained value, as ``numpy()``
        gives it (``gpflow_tpu/base.py:358-360``)."""
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

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
