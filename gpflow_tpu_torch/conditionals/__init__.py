from . import conditionals as _conditionals_impl  # registers the single-output conditionals
from . import multioutput  # registers the multioutput conditionals
from .dispatch import conditional, sample_conditional
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
    "conditional",
    "expand_independent_outputs",
    "inv_solve",
    "multioutput",
    "sample_conditional",
    "set_inv_solve",
]
