from . import conditionals as _conditionals_impl  # registers the single-output conditionals
from . import multioutput  # registers the multioutput conditionals
from . import sample_conditionals as _sample_impl  # registers sampling
from .dispatch import conditional, sample_conditional
from .util import (
    base_conditional,
    base_conditional_with_lm,
    expand_independent_outputs,
    inv_solve,
    sample_mvn,
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
    "sample_mvn",
    "set_inv_solve",
    "uncertain_conditional",
]


def __getattr__(name: str):
    # uncertain_conditional needs the expectations, which import the
    # covariances and kernels: loaded on first use, as the JAX package does
    if name == "uncertain_conditional":
        from .uncertain_conditionals import uncertain_conditional

        return uncertain_conditional
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
