from .bucketing import bucket_size_for, bucketize, pad_to_bucket
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
from .traversal import (
    deepcopy,
    freeze,
    load_jax_values,
    multiple_assign,
    parameter_dict,
    read_values,
    reset_cache_bijectors,
    select_dict_parameters_with_prior,
)
from .checkpoints import load_checkpoint, save_checkpoint
from .serving import ServedModel, export_serving, load_serving

__all__ = [
    "Dispatcher",
    "ServedModel",
    "ShapeError",
    "add_likelihood_noise_cov",
    "add_noise_cov",
    "assert_params_false",
    "bucket_size_for",
    "bucketize",
    "check_shape",
    "check_shapes",
    "deepcopy",
    "evaluate_parameter_or_function",
    "export_serving",
    "freeze",
    "get_enable_check_shapes",
    "inherit_check_shapes",
    "load_checkpoint",
    "load_jax_values",
    "load_serving",
    "multiple_assign",
    "pad_to_bucket",
    "parameter_dict",
    "prepare_parameter_or_function",
    "read_values",
    "register_get_shape",
    "reset_cache_bijectors",
    "save_checkpoint",
    "select_dict_parameters_with_prior",
    "set_enable_check_shapes",
    "set_trainable",
    "square_distance",
    "to_default_float",
]
