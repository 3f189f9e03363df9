"""Alias module of ``functions`` (counterpart of ``gpflow_tpu/mean_functions.py``)."""
from .functions import (
    Additive,
    Constant,
    Function,
    Identity,
    Linear,
    MeanFunction,
    Polynomial,
    Product,
    SwitchedFunction,
    SwitchedMeanFunction,
    Zero,
)

__all__ = [
    "Additive",
    "Constant",
    "Function",
    "Identity",
    "Linear",
    "MeanFunction",
    "Polynomial",
    "Product",
    "SwitchedFunction",
    "SwitchedMeanFunction",
    "Zero",
]
