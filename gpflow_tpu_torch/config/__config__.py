"""Process-global configuration (counterpart of ``gpflow_tpu/config/__config__.py``).

Holds the default float type (float64, as in the JAX package), the default
integer type (int64, the type of class labels and indices), the default
device (``"cuda"``: parameters and data are built on the card unless the
caller asks for another device, as in ``set_default_device("cpu")`` or
``as_context(Config(device="cpu"))``; with no card, building raises torch's
own error and nothing falls back to the CPU), the dtype-matched Cholesky
jitter (1e-6 for float64, 1e-4 otherwise: in float32 a
well-conditioned M ~ 1000 RBF Gram matrix routinely has a minimum eigenvalue
below -1e-5 after rounding), the positive bijector ("softplus" or "exp"),
the lower bounds of positive parameters and the summary table's format.

Each setting but the device can be set before the import through the
environment, as in the JAX package: ``GPFLOW_INT``, ``GPFLOW_FLOAT``,
``GPFLOW_POSITIVE_BIJECTOR``, ``GPFLOW_POSITIVE_MINIMUM``,
``GPFLOW_LIKELIHOOD_POSITIVE_MINIMUM``, ``GPFLOW_SUMMARY_FMT`` and
``GPFLOW_JITTER``; a value that cannot be read raises ``TypeError``.

Float32 matrix products run in exact IEEE fp32: ``apply_environment_tiers``,
which the package calls on import, turns TF32 off for matmuls and cuDNN
unless ``GPFLOW_TPU_FAST_MATMUL`` asks for the fast tier.
"""
from __future__ import annotations

import contextlib
import dataclasses
import enum
import os
from typing import Any, Generator, Mapping, Optional, Union

import numpy as np
import torch

# as ``gpflow_tpu/config/__config__.py:23``
Float = Union[float]

__all__ = [
    "Config",
    "Float",
    "apply_environment_tiers",
    "as_context",
    "as_torch_dtype",
    "config",
    "default_device",
    "default_float",
    "default_int",
    "default_jitter",
    "default_likelihood_positive_minimum",
    "default_positive_bijector",
    "default_positive_minimum",
    "default_summary_fmt",
    "positive_bijector_type_map",
    "set_config",
    "set_default_device",
    "set_default_float",
    "set_default_int",
    "set_default_jitter",
    "set_default_likelihood_positive_minimum",
    "set_default_positive_bijector",
    "set_default_positive_minimum",
    "set_default_summary_fmt",
    "use_exact_f32_matmul",
]


def as_torch_dtype(value: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(value, torch.dtype):
        return value
    return torch.from_numpy(np.empty(0, dtype=np.dtype(value))).dtype


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


class _Values(enum.Enum):
    """The settings read from the environment, each as ``GPFLOW_<NAME>``
    (``gpflow_tpu/config/__config__.py:50-66``)."""

    INT = "int"
    FLOAT = "float"
    POSITIVE_BIJECTOR = "positive_bijector"
    POSITIVE_MINIMUM = "positive_minimum"
    LIKELIHOOD_POSITIVE_MINIMUM = "likelihood_positive_minimum"
    SUMMARY_FMT = "summary_fmt"
    JITTER = "jitter"

    @property
    def env_name(self) -> str:
        return f"GPFLOW_{self.name}"


_POSITIVE_BIJECTOR_NAMES = ("softplus", "exp")


def _valid_summary_fmts() -> list:
    """The accepted ``summary_fmt`` values: None (plain), "notebook" (an HTML
    table in a notebook) and every format of ``tabulate``."""
    fmts: list = [None, "notebook", "simple", "grid", "fancy_grid", "html", "plain"]
    try:
        import tabulate
    except ImportError:
        return fmts
    return fmts + list(tabulate.tabulate_formats)


def _default(value: _Values) -> Any:
    """The environment's value of a setting, checked, else its default
    (``gpflow_tpu/config/__config__.py:72-105``)."""
    rv = os.getenv(value.env_name)
    if rv is None:
        if value is _Values.JITTER:
            return _dtype_matched_jitter(_default(_Values.FLOAT))
        return {
            _Values.INT: torch.int64,
            _Values.FLOAT: torch.float64,
            _Values.POSITIVE_BIJECTOR: "softplus",
            _Values.POSITIVE_MINIMUM: 0.0,
            _Values.LIKELIHOOD_POSITIVE_MINIMUM: 1e-6,
            _Values.SUMMARY_FMT: "fancy_grid",
        }[value]
    if value in (_Values.INT, _Values.FLOAT):
        try:
            dtype = as_torch_dtype(rv)
        except TypeError:
            raise TypeError(f"Config cannot recognize {value.value} type {rv!r}.")
        if not (_is_integer(dtype) if value is _Values.INT else dtype.is_floating_point):
            raise TypeError(f"Config cannot recognize {value.value} type {rv!r}.")
        return dtype
    if value in (_Values.POSITIVE_MINIMUM, _Values.LIKELIHOOD_POSITIVE_MINIMUM, _Values.JITTER):
        try:
            return float(rv)
        except ValueError:
            raise TypeError(f"Config cannot set the {value.value} value with non float type {rv!r}.")
    if value is _Values.POSITIVE_BIJECTOR and rv not in _POSITIVE_BIJECTOR_NAMES:
        raise TypeError(
            "Config cannot set the passed value as a default positive bijector. "
            f"Available options: {set(_POSITIVE_BIJECTOR_NAMES)}"
        )
    if value is _Values.SUMMARY_FMT and rv not in _valid_summary_fmts():
        raise TypeError(f"Config cannot recognize summary_fmt {rv!r}.")
    return rv


def _dtype_matched_jitter(float_dtype: torch.dtype) -> float:
    return 1e-6 if float_dtype == torch.float64 else 1e-4


def _field(value: _Values) -> Any:
    return dataclasses.field(default_factory=lambda: _default(value))


@dataclasses.dataclass(frozen=True)
class Config:
    """Immutable snapshot of all settings. Each default is the environment's
    value where it sets one. ``jitter=None`` resolves to ``GPFLOW_JITTER``
    if set, else from the float type, so ``Config(float=torch.float32)`` gets
    1e-4."""

    # the JAX package's fields in its order (``gpflow_tpu/config/__config__.py:119-139``), then the device
    int: torch.dtype = _field(_Values.INT)
    float: torch.dtype = _field(_Values.FLOAT)
    jitter: Optional[float] = None
    positive_bijector: str = _field(_Values.POSITIVE_BIJECTOR)
    positive_minimum: float = _field(_Values.POSITIVE_MINIMUM)
    likelihood_positive_minimum: float = _field(_Values.LIKELIHOOD_POSITIVE_MINIMUM)
    summary_fmt: Optional[str] = _field(_Values.SUMMARY_FMT)
    device: Union[str, torch.device] = "cuda"

    def __post_init__(self) -> None:
        object.__setattr__(self, "float", as_torch_dtype(self.float))
        object.__setattr__(self, "int", as_torch_dtype(self.int))
        object.__setattr__(self, "device", torch.device(self.device))
        if self.jitter is None:
            explicit = os.getenv(_Values.JITTER.env_name) is not None
            jitter = _default(_Values.JITTER) if explicit else _dtype_matched_jitter(self.float)
            object.__setattr__(self, "jitter", jitter)


_config = Config()
# A jitter set through the environment or ``set_default_jitter`` no longer
# follows the float type (``gpflow_tpu/config/__config__.py:205-226``).
_jitter_explicit = os.getenv(_Values.JITTER.env_name) is not None


def config() -> Config:
    return _config


def set_config(new_config: Config) -> None:
    global _config
    _config = new_config


def _replace(**kwargs: Any) -> None:
    set_config(dataclasses.replace(config(), **kwargs))


def default_float() -> torch.dtype:
    return config().float


def default_int() -> torch.dtype:
    """The integer type of class labels and indices (``__config__.py:166``)."""
    return config().int


def default_device() -> torch.device:
    """The device on which parameters and data are built (``"cuda"`` unless
    set otherwise)."""
    return config().device


def default_jitter() -> float:
    return config().jitter


def default_positive_bijector() -> str:
    return config().positive_bijector


def default_positive_minimum() -> float:
    return config().positive_minimum


def default_likelihood_positive_minimum() -> float:
    return config().likelihood_positive_minimum


def default_summary_fmt() -> Optional[str]:
    return config().summary_fmt


def set_default_int(value_type: Any) -> None:
    dtype = as_torch_dtype(value_type)
    if not _is_integer(dtype):
        raise TypeError(f"{value_type} is not an integer dtype")
    _replace(int=dtype)


def set_default_float(value_type: Any) -> None:
    """Sets the default float type. The jitter follows the type (1e-6 for
    float64, 1e-4 otherwise) unless it was set explicitly, as in
    ``gpflow_tpu/config/__config__.py:205-217``."""
    dtype = as_torch_dtype(value_type)
    if not dtype.is_floating_point:
        raise TypeError(f"{value_type} is not a float dtype")
    kwargs: dict = {"float": dtype}
    if not _jitter_explicit and config().jitter == _dtype_matched_jitter(config().float):
        kwargs["jitter"] = _dtype_matched_jitter(dtype)
    _replace(**kwargs)


def set_default_device(device: Union[str, torch.device]) -> None:
    """Sets the device on which parameters and data are built, e.g. "cpu"."""
    _replace(device=torch.device(device))


def set_default_jitter(value: float) -> None:
    global _jitter_explicit
    if value < 0:
        raise ValueError("Jitter must be non-negative")
    _jitter_explicit = True
    _replace(jitter=float(value))


def positive_bijector_type_map() -> dict:
    """Name -> bijector class of the positive transform
    (``gpflow_tpu/config/__config__.py:229-234``)."""
    from .. import bijectors

    return {"softplus": bijectors.Softplus, "exp": bijectors.Exp}


def set_default_positive_bijector(value: str) -> None:
    value = value.lower()
    if value not in _POSITIVE_BIJECTOR_NAMES:
        raise ValueError(f"positive_bijector must be one of {_POSITIVE_BIJECTOR_NAMES}")
    _replace(positive_bijector=value)


def set_default_positive_minimum(value: float) -> None:
    if value < 0:
        raise ValueError("positive_minimum must be non-negative")
    _replace(positive_minimum=float(value))


def set_default_likelihood_positive_minimum(value: float) -> None:
    if value < 0:
        raise ValueError("likelihood_positive_minimum must be non-negative")
    _replace(likelihood_positive_minimum=float(value))


def set_default_summary_fmt(value: Optional[str]) -> None:
    fmts = _valid_summary_fmts()
    if value not in fmts:
        raise ValueError(f"Summary does not support '{value}' format; valid: {fmts}")
    _replace(summary_fmt=value)


@contextlib.contextmanager
def as_context(temporary_config: Optional[Config] = None) -> Generator[None, None, None]:
    """Swaps the global config for the duration of the block, and restores
    whether the jitter was set explicitly."""
    global _jitter_explicit
    current, current_explicit = config(), _jitter_explicit
    try:
        set_config(temporary_config or current)
        yield
    finally:
        set_config(current)
        _jitter_explicit = current_explicit


def use_exact_f32_matmul() -> None:
    """Float32 matmuls and convolutions in full IEEE fp32: TF32 keeps 10
    mantissa bits, which breaks the cancellations the Cholesky-based
    conditionals rely on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _use_tf32_matmul() -> None:
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("high")


_FALSY = ("0", "", "false", "False")


def apply_environment_tiers(environ: Optional[Mapping[str, str]] = None) -> None:
    """Sets the float32 matmul tier from ``environ`` (``os.environ`` by
    default), as ``gpflow_tpu/__init__.py:12-39`` does at import:

    * ``GPFLOW_TPU_FAST_MATMUL`` unset or "0" (also "", "false", "False"):
      exact IEEE fp32 (``use_exact_f32_matmul``), safe for every model;
    * any other value ("high", "1"): TF32 for matmuls and cuDNN on CUDA.
      TF32 keeps 10 mantissa bits, coarser than the JAX package's "high"
      (3-pass bf16, ~1e-5 relative); torch has no tier between the two.

    ``GPFLOW_TPU_DISABLE_X64`` is accepted and switches nothing: torch keeps
    float64 without a global switch. ``JAX_DEFAULT_MATMUL_PRECISION`` is
    JAX's own and not read."""
    environ = os.environ if environ is None else environ
    if environ.get("GPFLOW_TPU_FAST_MATMUL", "0") in _FALSY:
        use_exact_f32_matmul()
    else:
        _use_tf32_matmul()
