"""Checkpoints of a module's parameter values (counterpart of
``gpflow_tpu/utilities/checkpoints.py``).

A checkpoint is the npz file of ``read_values``: each key a parameter's path,
each value its constrained value. A file that the JAX package's
``read_values`` and ``np.savez`` write loads into the counterpart model of
the port, and the port's loads into the JAX package's ``multiple_assign``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from torch import nn

from .traversal import multiple_assign, parameter_dict, read_values

__all__ = ["load_checkpoint", "save_checkpoint"]


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, module: nn.Module) -> None:
    """Saves every parameter value of ``module`` to ``path`` (``.npz`` is
    added where missing)."""
    np.savez(_npz_path(path), **read_values(module))


def load_checkpoint(path: str, module: nn.Module) -> Dict[str, np.ndarray]:
    """Restores the values saved at ``path`` into ``module``, at the paths it
    has (a partial or forward-compatible load, ``checkpoints.py:50-55``), all
    of them or none (``multiple_assign``); returns every value in the file."""
    with np.load(_npz_path(path)) as npz:
        values = {k: npz[k] for k in npz.files}
    params = parameter_dict(module)
    multiple_assign(module, {k: v for k, v in values.items() if k in params})
    return values
