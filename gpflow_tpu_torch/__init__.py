"""gpflow_tpu_torch: the PyTorch/CUDA port of gpflow_tpu.

The port imports torch and numpy only. Its modules mirror ``gpflow_tpu``'s
paths and public names; so far it covers SVGP serving with a
SquaredExponential kernel (ROADMAP.md lists what is still to port). On a
CUDA device, covariance matrices come from the hand-written kernel K1
(``gpflow_tpu_torch.ops.pallas_distance``).

Parameters live wherever the model is moved with ``.to(device)``; there is
no global default device. Float32 matmuls run in exact IEEE fp32 (TF32 off).
"""
from . import (
    bijectors,
    conditionals,
    config,
    covariances,
    functions,
    inducing_variables,
    kernels,
    likelihoods,
    models,
    ops,
    posteriors,
    utilities,
)
from .base import Module, Parameter

config.use_exact_f32_matmul()

__all__ = [
    "Module",
    "Parameter",
    "bijectors",
    "conditionals",
    "config",
    "covariances",
    "functions",
    "inducing_variables",
    "kernels",
    "likelihoods",
    "models",
    "ops",
    "posteriors",
    "utilities",
]
