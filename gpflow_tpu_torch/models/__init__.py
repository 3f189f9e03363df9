from .cglb import CGLB, NystromPreconditioner, cglb_conjugate_gradient
from .gplvm import GPLVM, BayesianGPLVM
from .gpmc import GPMC
from .gpr import GPR, GPR_deprecated, GPR_with_posterior
from .model import BayesianModel, GPModel
from .sgpmc import SGPMC
from .sgpr import GPRFITC, SGPR, SGPR_deprecated, SGPR_with_posterior, SGPRBase_deprecated
from .svgp import SVGP, SVGP_deprecated, SVGP_with_posterior
from .training_mixins import ExternalDataTrainingLossMixin, InternalDataTrainingLossMixin
from .util import (
    data_input_to_tensor,
    inducingpoint_wrapper,
    maximum_log_likelihood_objective,
    training_loss,
    training_loss_closure,
)
from .vgp import VGP, VGP_deprecated, VGP_with_posterior, VGPOpperArchambeau, update_vgp_data

__all__ = [
    "BayesianGPLVM",
    "BayesianModel",
    "CGLB",
    "ExternalDataTrainingLossMixin",
    "GPLVM",
    "GPMC",
    "GPModel",
    "GPR",
    "GPRFITC",
    "GPR_deprecated",
    "GPR_with_posterior",
    "InternalDataTrainingLossMixin",
    "NystromPreconditioner",
    "SGPMC",
    "SGPR",
    "SGPRBase_deprecated",
    "SGPR_deprecated",
    "SGPR_with_posterior",
    "SVGP",
    "SVGP_deprecated",
    "SVGP_with_posterior",
    "VGP",
    "VGPOpperArchambeau",
    "VGP_deprecated",
    "VGP_with_posterior",
    "cglb_conjugate_gradient",
    "data_input_to_tensor",
    "inducingpoint_wrapper",
    "maximum_log_likelihood_objective",
    "training_loss",
    "training_loss_closure",
    "update_vgp_data",
]
