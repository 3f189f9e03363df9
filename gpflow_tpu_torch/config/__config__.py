"""Process-global configuration (counterpart of ``gpflow_tpu/config/__config__.py``).

Holds the default float type (float64, as in the JAX package), the default
integer type (int64, the type of class labels and indices), the default
device (``"cuda"``: parameters and data are built on the card unless the
caller asks for another device, as in ``set_default_device("cpu")`` or
``as_context(Config(device="cpu"))``; with no card, building raises torch's
own error and nothing falls back to the CPU), the dtype-matched Cholesky
jitter (1e-6 for float64, 1e-4 otherwise: in float32 a
well-conditioned M ~ 1000 RBF Gram matrix routinely has a minimum eigenvalue
below -1e-5 after rounding) and the lower bounds of positive parameters.

Float32 matrix products run in exact IEEE fp32: ``use_exact_f32_matmul``
turns TF32 off for matmuls and cuDNN, and the package calls it on import.
The JAX package's environment-variable tiers are not ported yet.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Generator, Optional, Union

import numpy as np
import torch

__all__ = [
    "Config",
    "as_context",
    "as_torch_dtype",
    "config",
    "default_device",
    "default_float",
    "default_int",
    "default_jitter",
    "default_likelihood_positive_minimum",
    "default_positive_minimum",
    "set_config",
    "set_default_device",
    "set_default_float",
    "set_default_jitter",
    "use_exact_f32_matmul",
]


def as_torch_dtype(value: Any) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(value, torch.dtype):
        return value
    return torch.from_numpy(np.empty(0, dtype=np.dtype(value))).dtype


def _dtype_matched_jitter(float_dtype: torch.dtype) -> float:
    return 1e-6 if float_dtype == torch.float64 else 1e-4


@dataclasses.dataclass(frozen=True)
class Config:
    """Immutable snapshot of all settings. ``jitter=None`` resolves from the
    float type, so ``Config(float=torch.float32)`` gets 1e-4."""

    float: torch.dtype = torch.float64
    int: torch.dtype = torch.int64
    device: Union[str, torch.device] = "cuda"
    jitter: Optional[float] = None
    positive_minimum: float = 0.0
    likelihood_positive_minimum: float = 1e-6

    def __post_init__(self) -> None:
        object.__setattr__(self, "float", as_torch_dtype(self.float))
        object.__setattr__(self, "int", as_torch_dtype(self.int))
        object.__setattr__(self, "device", torch.device(self.device))
        if self.jitter is None:
            object.__setattr__(self, "jitter", _dtype_matched_jitter(self.float))


_config = Config()
_jitter_explicit = False


def config() -> Config:
    return _config


def set_config(new_config: Config) -> None:
    global _config
    _config = new_config


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


def default_positive_minimum() -> float:
    return config().positive_minimum


def default_likelihood_positive_minimum() -> float:
    return config().likelihood_positive_minimum


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
    set_config(dataclasses.replace(config(), **kwargs))


def set_default_device(device: Union[str, torch.device]) -> None:
    """Sets the device on which parameters and data are built, e.g. "cpu"."""
    set_config(dataclasses.replace(config(), device=torch.device(device)))


def set_default_jitter(value: float) -> None:
    global _jitter_explicit
    if value < 0:
        raise ValueError("Jitter must be non-negative")
    _jitter_explicit = True
    set_config(dataclasses.replace(config(), jitter=float(value)))


@contextlib.contextmanager
def as_context(temporary_config: Optional[Config] = None) -> Generator[None, None, None]:
    """Swaps the global config for the duration of the block."""
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
