"""Optimizers and samplers (counterpart of ``gpflow_tpu/optimizers``:
``Scipy``, ``NaturalGradient``, ``SamplingHelper`` and ``run_hmc``)."""
from .mcmc import SamplingHelper, run_hmc
from .natgrad import NaturalGradient, XiNat, XiSqrtMeanVar, XiTransform
from .scipy import Scipy

__all__ = ["NaturalGradient", "SamplingHelper", "Scipy", "XiNat", "XiSqrtMeanVar", "XiTransform", "run_hmc"]
