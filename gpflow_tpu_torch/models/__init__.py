from .model import GPModel
from .svgp import SVGP
from .util import inducingpoint_wrapper

__all__ = ["GPModel", "SVGP", "inducingpoint_wrapper"]
