"""Hand-written kernels and factorization helpers."""
from .linalg import chol_and_inverse, cholesky, cholesky_mm, mvn_logp, sym_jitter, triangular_inverse
from .pallas_distance import (
    PALLAS_FAMILIES,
    get_pallas_enabled,
    launch_counts,
    pallas_available,
    rbf_kernel_matrix,
    scaled_squared_distance,
    set_pallas_enabled,
    stationary_forward,
    stationary_kernel_matrix,
    stationary_wgrad,
)

__all__ = [
    "PALLAS_FAMILIES",
    "chol_and_inverse",
    "cholesky",
    "cholesky_mm",
    "get_pallas_enabled",
    "launch_counts",
    "mvn_logp",
    "pallas_available",
    "rbf_kernel_matrix",
    "scaled_squared_distance",
    "set_pallas_enabled",
    "stationary_forward",
    "stationary_kernel_matrix",
    "stationary_wgrad",
    "sym_jitter",
    "triangular_inverse",
]
