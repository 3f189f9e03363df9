"""Kernel expectations and psi statistics (counterpart of
``gpflow_tpu/expectations/``): ``expectation(p, obj1, obj2)`` computes
<obj1(x) obj2(x)>_p(x) for a Gaussian p over inputs, analytically where a
registration exists, else by Gauss-Hermite quadrature."""
from . import (  # noqa: F401 - imported to register the implementations
    cross_kernels,
    linears,
    mean_functions,
    misc,
    products,
    quadratures,
    squared_exponentials,
    sums,
)
from .expectations import expectation, quadrature_expectation

__all__ = ["expectation", "quadrature_expectation"]
