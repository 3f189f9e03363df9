"""Quadrature (counterpart of ``gpflow_tpu/quadrature``)."""
from .base import GaussianQuadrature
from .deprecated import hermgauss, mvhermgauss, mvnquad, ndiag_mc, ndiagquad
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
    "hermgauss",
    "list_to_flat_grid",
    "mvhermgauss",
    "mvnquad",
    "ndgh_points_and_weights",
    "ndiag_mc",
    "ndiagquad",
    "repeat_as_list",
    "reshape_Z_dZ",
]
