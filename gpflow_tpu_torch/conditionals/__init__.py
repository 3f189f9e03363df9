from .util import (
    base_conditional,
    base_conditional_with_lm,
    expand_independent_outputs,
    inv_solve,
    set_inv_solve,
)

__all__ = [
    "base_conditional",
    "base_conditional_with_lm",
    "expand_independent_outputs",
    "inv_solve",
    "set_inv_solve",
]
