from .model import BayesianModel, GPModel
from .svgp import SVGP
from .training_mixins import ExternalDataTrainingLossMixin
from .util import inducingpoint_wrapper

__all__ = ["BayesianModel", "ExternalDataTrainingLossMixin", "GPModel", "SVGP", "inducingpoint_wrapper"]
