from .base import ActiveDims, Combination, Kernel, Product, ReducingCombination, Sum
from .categorical import Categorical
from .changepoints import ChangePoints
from .convolutional import Convolutional
from .linears import Linear, Polynomial
from .misc import ArcCosine, Coregion
from .multioutput import (
    IndependentLatent,
    LinearCoregionalization,
    MultioutputKernel,
    SeparateIndependent,
    SharedIndependent,
)
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
    "ArcCosine",
    "Bias",
    "Categorical",
    "ChangePoints",
    "Combination",
    "Constant",
    "Convolutional",
    "Coregion",
    "Cosine",
    "Exponential",
    "IndependentLatent",
    "IsotropicStationary",
    "Kernel",
    "Linear",
    "LinearCoregionalization",
    "Matern12",
    "Matern32",
    "Matern52",
    "MultioutputKernel",
    "Periodic",
    "Polynomial",
    "Product",
    "RBF",
    "RationalQuadratic",
    "ReducingCombination",
    "SeparateIndependent",
    "SharedIndependent",
    "SquaredExponential",
    "Static",
    "Stationary",
    "Sum",
    "White",
]
