from .base import DEFAULT_NUM_GAUSS_HERMITE_POINTS, Likelihood, QuadratureLikelihood, ScalarLikelihood
from .scalar_continuous import Gaussian
from .scalar_discrete import Bernoulli, Ordinal, Poisson
from .utils import inv_probit

__all__ = [
    "Bernoulli",
    "DEFAULT_NUM_GAUSS_HERMITE_POINTS",
    "Gaussian",
    "Likelihood",
    "Ordinal",
    "Poisson",
    "QuadratureLikelihood",
    "ScalarLikelihood",
    "inv_probit",
]
