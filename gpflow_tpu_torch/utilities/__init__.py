from .misc import set_trainable
from .multipledispatch import Dispatcher
from .ops import square_distance
from .parameter_or_function import evaluate_parameter_or_function, prepare_parameter_or_function
from .traversal import load_jax_values, parameter_dict, read_values

__all__ = [
    "Dispatcher",
    "evaluate_parameter_or_function",
    "load_jax_values",
    "parameter_dict",
    "prepare_parameter_or_function",
    "read_values",
    "set_trainable",
    "square_distance",
]
