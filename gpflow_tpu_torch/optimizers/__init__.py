"""Optimizers (counterpart of ``gpflow_tpu/optimizers``; ``Scipy`` so far)."""
from .scipy import Scipy

__all__ = ["Scipy"]
