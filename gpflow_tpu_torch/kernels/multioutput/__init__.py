from .kernels import (
    IndependentLatent,
    LinearCoregionalization,
    MultioutputKernel,
    SeparateIndependent,
    SharedIndependent,
)

__all__ = [
    "IndependentLatent",
    "LinearCoregionalization",
    "MultioutputKernel",
    "SeparateIndependent",
    "SharedIndependent",
]
