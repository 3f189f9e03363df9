from .base import ActiveDims, Kernel
from .stationaries import IsotropicStationary, SquaredExponential, Stationary

__all__ = ["ActiveDims", "IsotropicStationary", "Kernel", "SquaredExponential", "Stationary"]
