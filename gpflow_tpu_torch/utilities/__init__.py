from .misc import set_trainable, to_default_float
from .model_utils import add_likelihood_noise_cov, add_noise_cov, assert_params_false
from .multipledispatch import Dispatcher
from .ops import square_distance
from .parameter_or_function import evaluate_parameter_or_function, prepare_parameter_or_function
from .traversal import load_jax_values, parameter_dict, read_values

__all__ = [
    "Dispatcher",
    "add_likelihood_noise_cov",
    "add_noise_cov",
    "assert_params_false",
    "evaluate_parameter_or_function",
    "load_jax_values",
    "parameter_dict",
    "prepare_parameter_or_function",
    "read_values",
    "set_trainable",
    "square_distance",
    "to_default_float",
]
