"""Quadrature (counterpart of ``gpflow_tpu/quadrature``; the deprecated
functions of ``deprecated.py`` wait, ROADMAP.md)."""
from .base import GaussianQuadrature
from .gauss_hermite import (
    NDiagGHQuadrature,
    gh_points_and_weights,
    list_to_flat_grid,
    ndgh_points_and_weights,
    repeat_as_list,
    reshape_Z_dZ,
)

__all__ = [
    "GaussianQuadrature",
    "NDiagGHQuadrature",
    "gh_points_and_weights",
    "list_to_flat_grid",
    "ndgh_points_and_weights",
    "repeat_as_list",
    "reshape_Z_dZ",
]
