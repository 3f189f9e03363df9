from .gpr import GPR, GPR_deprecated, GPR_with_posterior
from .model import BayesianModel, GPModel
from .svgp import SVGP
from .training_mixins import ExternalDataTrainingLossMixin, InternalDataTrainingLossMixin
from .util import data_input_to_tensor, inducingpoint_wrapper

__all__ = [
    "BayesianModel",
    "ExternalDataTrainingLossMixin",
    "GPModel",
    "GPR",
    "GPR_deprecated",
    "GPR_with_posterior",
    "InternalDataTrainingLossMixin",
    "SVGP",
    "data_input_to_tensor",
    "inducingpoint_wrapper",
]
