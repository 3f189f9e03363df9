"""gpflow_tpu_torch: the PyTorch/CUDA port of gpflow_tpu.

The port imports torch, numpy and scipy (for ``optimizers.Scipy``) only.
Its modules mirror ``gpflow_tpu``'s paths and public names; so far it trains
an SVGP (``elbo``, ``training_loss``, ``parallel.DataParallelTrainer``, with
natural gradients for the non-conjugate likelihoods) and fits an exact GPR
(``log_marginal_likelihood``, ``optimizers.Scipy``), the sparse SGPR,
GPRFITC and CGLB, and the VGP and VGPOpperArchambeau through the
single-output ``conditionals.conditional``, with stationary, Linear, static
and Periodic kernels, their sums and products, and mean functions, and
multiclass SVGPs (``MultiClass``, ``Softmax``) over several latent GPs with
the rest of the JAX package's likelihoods, multioutput SVGPs, and the
Bayesian models GPMC and SGPMC with parameter priors, sampled by
``optimizers.run_hmc``, and the GPLVM and Bayesian GPLVM through the psi
statistics of ``expectations`` (with ``conditionals.uncertain_conditional``),
and serves them, also as exported artifacts (``utilities.serving``), with
``utilities.training_loop``, ``monitor``, ``utilities.print_summary`` and
``utilities.profile`` around them, and splits them over the ranks of a
``torch.distributed`` mesh (``parallel``). Public entry points take numpy
arrays as well as tensors. Shape contracts
(``utilities.check_shapes``) are off unless switched on. On a CUDA device, covariance matrices come from the hand-written
kernel K1 and the gradients of the exponential and Matern families from K2
(``gpflow_tpu_torch.ops.pallas_distance``).

Parameters and model data are built on ``config.default_device()``, which is
``"cuda"`` unless the caller asks for another device
(``config.set_default_device("cpu")``); importing the package needs no card.
The subpackages of models, kernels and the rest load on first use.

The environment sets the tiers at import (``config.apply_environment_tiers``,
as ``gpflow_tpu/__init__.py:12-39``): float32 matmuls run in exact IEEE fp32
(TF32 off) unless ``GPFLOW_TPU_FAST_MATMUL`` is "high" or "1", which allows
TF32; ``GPFLOW_TPU_DISABLE_X64`` is accepted and switches nothing.
``GPFLOW_TPU_PALLAS`` ("0" or "1") turns the kernels off or on where
``ops.set_pallas_enabled`` has not, and ``GPFLOW_<NAME>`` sets the
defaults of ``config``.
"""
import importlib
from typing import Any

from . import bijectors, ci_utils, config, ops, utilities
from .base import Module, Parameter, PriorOn, TensorType
from .config import default_float, default_int, default_jitter
from .utilities import set_trainable
from .versions import __version__

config.apply_environment_tiers()

# Imported on first use, so that a process that only serves an exported
# artifact (``utilities.serving``) loads no model code.
_SUBPACKAGES = (
    "conditionals",
    "covariances",
    "expectations",
    "experimental",
    "functions",
    "inducing_variables",
    "kernels",
    "kullback_leiblers",
    "likelihoods",
    "logdensities",
    "mean_functions",
    "models",
    "monitor",
    "optimizers",
    "parallel",
    "posteriors",
    "priors",
    "probability_distributions",
    "quadrature",
)


def __getattr__(name: str) -> Any:
    if name in _SUBPACKAGES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "Module",
    "Parameter",
    "PriorOn",
    "TensorType",
    "__version__",
    "bijectors",
    "ci_utils",
    "conditionals",
    "config",
    "covariances",
    "default_float",
    "default_int",
    "default_jitter",
    "expectations",
    "experimental",
    "functions",
    "inducing_variables",
    "kernels",
    "kullback_leiblers",
    "likelihoods",
    "logdensities",
    "mean_functions",
    "models",
    "monitor",
    "ops",
    "optimizers",
    "parallel",
    "posteriors",
    "priors",
    "probability_distributions",
    "quadrature",
    "set_trainable",
    "utilities",
]
