from .base import ActiveDims, Kernel
from .stationaries import (
    Exponential,
    IsotropicStationary,
    Matern12,
    Matern32,
    Matern52,
    RationalQuadratic,
    SquaredExponential,
    Stationary,
)

__all__ = [
    "ActiveDims",
    "Exponential",
    "IsotropicStationary",
    "Kernel",
    "Matern12",
    "Matern32",
    "Matern52",
    "RationalQuadratic",
    "SquaredExponential",
    "Stationary",
]
