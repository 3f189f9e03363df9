"""Optimizers (counterpart of ``gpflow_tpu/optimizers``; ``Scipy`` and
``NaturalGradient`` so far)."""
from .natgrad import NaturalGradient, XiNat, XiSqrtMeanVar, XiTransform
from .scipy import Scipy

__all__ = ["NaturalGradient", "Scipy", "XiNat", "XiSqrtMeanVar", "XiTransform"]
