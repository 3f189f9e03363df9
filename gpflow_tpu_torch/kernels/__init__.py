from .base import ActiveDims, Combination, Kernel, Product, ReducingCombination, Sum
from .linears import Linear, Polynomial
from .periodic import Periodic
from .statics import Bias, Constant, Static, White
from .stationaries import (
    AnisotropicStationary,
    Cosine,
    Exponential,
    IsotropicStationary,
    Matern12,
    Matern32,
    Matern52,
    RationalQuadratic,
    SquaredExponential,
    Stationary,
)

#: Alias (``gpflow_tpu/kernels/__init__.py``)
RBF = SquaredExponential

__all__ = [
    "ActiveDims",
    "AnisotropicStationary",
    "Bias",
    "Combination",
    "Constant",
    "Cosine",
    "Exponential",
    "IsotropicStationary",
    "Kernel",
    "Linear",
    "Matern12",
    "Matern32",
    "Matern52",
    "Periodic",
    "Polynomial",
    "Product",
    "RBF",
    "RationalQuadratic",
    "ReducingCombination",
    "SquaredExponential",
    "Static",
    "Stationary",
    "Sum",
    "White",
]
