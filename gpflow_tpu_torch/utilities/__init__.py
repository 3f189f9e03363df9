from typing import Any

from . import bijectors
from .bucketing import bucket_size_for, bucketize, pad_to_bucket
from .misc import (
    is_variable,
    positive_parameter,
    set_trainable,
    to_default_float,
    to_default_int,
    training_loop,
)
from .model_utils import add_likelihood_noise_cov, add_noise_cov, assert_params_false
from .multipledispatch import Dispatcher
from .ops import (
    broadcasting_elementwise,
    difference_matrix,
    eye,
    leading_transpose,
    pca_reduce,
    square_distance,
)
from .parameter_or_function import evaluate_parameter_or_function, prepare_parameter_or_function
from .profiling import annotate, profile
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
    leaf_components,
    load_jax_values,
    multiple_assign,
    parameter_dict,
    print_summary,
    read_values,
    reset_cache_bijectors,
    select_dict_parameters_with_prior,
    tabulate_module_summary,
    traverse_module,
)
from .checkpoints import load_checkpoint, save_checkpoint
from .serving import ServedModel, export_serving, load_serving

__all__ = [
    "Dispatcher",
    "ServedModel",
    "ShapeError",
    "add_likelihood_noise_cov",
    "add_noise_cov",
    "annotate",
    "assert_params_false",
    "bijectors",
    "broadcasting_elementwise",
    "bucket_size_for",
    "bucketize",
    "check_shape",
    "check_shapes",
    "deepcopy",
    "difference_matrix",
    "evaluate_parameter_or_function",
    "export_serving",
    "eye",
    "freeze",
    "get_enable_check_shapes",
    "inherit_check_shapes",
    "is_variable",
    "leading_transpose",
    "leaf_components",
    "load_checkpoint",
    "load_jax_values",
    "load_serving",
    "multiple_assign",
    "pad_to_bucket",
    "parameter_dict",
    "pca_reduce",
    "positive",
    "positive_parameter",
    "prepare_parameter_or_function",
    "print_summary",
    "profile",
    "read_values",
    "register_get_shape",
    "reset_cache_bijectors",
    "save_checkpoint",
    "select_dict_parameters_with_prior",
    "set_enable_check_shapes",
    "set_trainable",
    "square_distance",
    "tabulate_module_summary",
    "to_default_float",
    "to_default_int",
    "training_loop",
    "traverse_module",
    "triangular",
    "triangular_size",
]


def __getattr__(name: str) -> Any:
    # positive, triangular and triangular_size live in the package's
    # bijectors, whose shape contract imports utilities.shapes: resolving
    # them lazily breaks the import cycle (see utilities/bijectors.py)
    if name in ("positive", "triangular", "triangular_size"):
        from .. import bijectors as _bijectors

        return getattr(_bijectors, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
