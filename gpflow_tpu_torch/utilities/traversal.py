"""Parameter paths and bulk assignment (counterpart of
``gpflow_tpu/utilities/traversal.py``)."""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
from torch import nn

from ..base import Parameter

__all__ = ["load_jax_values", "parameter_dict", "read_values", "select_dict_parameters_with_prior"]


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
