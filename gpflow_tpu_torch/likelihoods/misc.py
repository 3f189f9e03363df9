"""Other likelihoods (counterpart of ``gpflow_tpu/likelihoods/misc.py``)."""
from __future__ import annotations

from .base import MonteCarloLikelihood
from .scalar_continuous import Gaussian

__all__ = ["GaussianMC"]


class GaussianMC(MonteCarloLikelihood, Gaussian):
    """Gaussian noise with Monte-Carlo expectations in place of the closed
    forms, for demonstration (``misc.py:11-13``)."""
