"""Hand-written kernels and factorization helpers."""
from .linalg import chol_and_inverse, sym_jitter, triangular_inverse
from .pallas_distance import (
    PALLAS_FAMILIES,
    launch_counts,
    pallas_available,
    stationary_forward,
    stationary_kernel_matrix,
)

__all__ = [
    "PALLAS_FAMILIES",
    "chol_and_inverse",
    "launch_counts",
    "pallas_available",
    "stationary_forward",
    "stationary_kernel_matrix",
    "sym_jitter",
    "triangular_inverse",
]
