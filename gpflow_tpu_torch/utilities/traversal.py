"""Parameter paths, bulk assignment and copies (counterpart of
``gpflow_tpu/utilities/traversal.py``)."""
from __future__ import annotations

import copy as _copy
import re
from typing import Any, Dict, Mapping, Optional, TypeVar

import numpy as np
from torch import nn

from ..base import Parameter

__all__ = [
    "deepcopy",
    "freeze",
    "load_jax_values",
    "multiple_assign",
    "parameter_dict",
    "read_values",
    "reset_cache_bijectors",
    "select_dict_parameters_with_prior",
]

M = TypeVar("M", bound=nn.Module)


_LIST_INDEX = re.compile(r"\.(\d+)(?=\.|$)")


def _jax_path(name: str) -> str:
    """``named_modules``' ``kernel.kernels.0.variance`` as the JAX package
    writes it, ``.kernel.kernels[0].variance``: an all-digit segment is an
    ``nn.ModuleList`` index (``traversal.py:67-70``)."""
    return _LIST_INDEX.sub(r"[\1]", f".{name}")


def parameter_dict(m: nn.Module) -> Dict[str, Parameter]:
    """Maps paths such as ``.kernel.lengthscales`` or
    ``.kernel.kernels[0].variance`` to the module's Parameters, in the JAX
    package's path format (``traversal.py:89-93``)."""
    return {_jax_path(name): p for name, p in m.named_modules() if isinstance(p, Parameter)}


def select_dict_parameters_with_prior(m: nn.Module) -> Dict[str, Parameter]:
    """The Parameters that carry a prior, keyed by path (``traversal.py:117-119``)."""
    return {k: p for k, p in parameter_dict(m).items() if p.prior is not None}


def read_values(m: nn.Module) -> Dict[str, np.ndarray]:
    """Constrained parameter values as numpy arrays, keyed by path."""
    return {k: p.numpy() for k, p in parameter_dict(m).items()}


def load_jax_values(model: nn.Module, values: Mapping[str, Any]) -> None:
    """Assigns constrained values, keyed by path, into ``model``: exactly the
    dict that ``gpflow_tpu.utilities.read_values(jax_model)`` returns for the
    counterpart JAX model. Each value is cast to its parameter's dtype and
    device.

    Atomic: an unknown path, a missing path, a shape mismatch or a value
    outside a parameter's domain raises before any parameter changes."""
    params = parameter_dict(model)
    unknown = sorted(set(values) - set(params))
    missing = sorted(set(params) - set(values))
    if unknown or missing:
        raise KeyError(f"paths do not match the model: unknown {unknown}, missing {missing}")
    prepared = [(params[path], params[path]._prepare_assign(np.asarray(v))) for path, v in values.items()]
    for p, unconstrained in prepared:
        p._set_unconstrained(unconstrained)


def multiple_assign(m: nn.Module, vars_dict: Mapping[str, Any]) -> None:
    """Assigns constrained values to the parameters at some of ``m``'s paths
    (``traversal.py:101-114``). Atomic: every path and value is checked (an
    unknown path raises ``KeyError``; a wrong shape, NaN or a value outside
    a parameter's domain raises ``ValueError``) before the first parameter
    changes."""
    params = parameter_dict(m)
    prepared = []
    for path, value in vars_dict.items():
        if path not in params:
            raise KeyError(f"No parameter at path {path!r}; available: {sorted(params)}")
        prepared.append((params[path], params[path]._prepare_assign(value)))
    for p, unconstrained in prepared:
        p._set_unconstrained(unconstrained)


def reset_cache_bijectors(input_module: M) -> M:
    """Returns the module (``traversal.py:122-127``): the port's bijectors
    keep no cache to clear before a copy."""
    return input_module


def deepcopy(m: M, memo: Optional[Dict[int, Any]] = None) -> M:
    """A deep copy of a module tree (``traversal.py:130-134``)."""
    return _copy.deepcopy(reset_cache_bijectors(m), memo)


def freeze(m: M) -> M:
    """A deep copy of ``m`` with every parameter non-trainable
    (``traversal.py:137-147``)."""
    frozen = deepcopy(m)
    for p in frozen.modules():
        if isinstance(p, Parameter):
            p.trainable = False
    return frozen
