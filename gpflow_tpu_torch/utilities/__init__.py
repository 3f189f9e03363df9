from .misc import set_trainable, to_default_float
from .model_utils import add_likelihood_noise_cov, add_noise_cov, assert_params_false
from .multipledispatch import Dispatcher
from .ops import square_distance
from .parameter_or_function import evaluate_parameter_or_function, prepare_parameter_or_function
from .shapes import (
    ShapeError,
    check_shape,
    check_shapes,
    get_enable_check_shapes,
    inherit_check_shapes,
    register_get_shape,
    set_enable_check_shapes,
)
from .traversal import load_jax_values, parameter_dict, read_values, select_dict_parameters_with_prior

__all__ = [
    "Dispatcher",
    "ShapeError",
    "add_likelihood_noise_cov",
    "add_noise_cov",
    "assert_params_false",
    "check_shape",
    "check_shapes",
    "evaluate_parameter_or_function",
    "get_enable_check_shapes",
    "inherit_check_shapes",
    "load_jax_values",
    "parameter_dict",
    "prepare_parameter_or_function",
    "read_values",
    "register_get_shape",
    "select_dict_parameters_with_prior",
    "set_enable_check_shapes",
    "set_trainable",
    "square_distance",
    "to_default_float",
]
