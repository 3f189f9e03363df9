from .base import Likelihood, ScalarLikelihood
from .scalar_continuous import Gaussian

__all__ = ["Gaussian", "Likelihood", "ScalarLikelihood"]
