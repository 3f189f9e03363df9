"""Multioutput inducing variables (counterpart of
``gpflow_tpu/inducing_variables/multioutput/inducing_variables.py``).

The Fallback classes take the generic interdomain route (Kuu [L, M, M], Kuf
[M, L, N, P]); their non-fallback subclasses opt in to the cheaper
``IndependentPosteriorMultiOutput`` route. A separate list of inducing
variables is an ``nn.ModuleList``, so its parameters' paths read
``.inducing_variable.inducing_variable_list[i].Z``.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

from torch import nn

from ...utilities.shapes import check_shapes
from ..inducing_variables import InducingVariables

__all__ = [
    "FallbackSeparateIndependentInducingVariables",
    "FallbackSharedIndependentInducingVariables",
    "MultioutputInducingVariables",
    "SeparateIndependentInducingVariables",
    "SharedIndependentInducingVariables",
]


class MultioutputInducingVariables(InducingVariables):
    """Base class (``inducing_variables.py:25-30``)."""

    @property
    def inducing_variables(self) -> Tuple[InducingVariables, ...]:
        raise NotImplementedError


class FallbackSharedIndependentInducingVariables(MultioutputInducingVariables):
    """One set of inducing variables shared by every latent process, on the
    generic route (``inducing_variables.py:33-55``)."""

    @check_shapes("inducing_variable: [M, D, 1]")
    def __init__(self, inducing_variable: InducingVariables) -> None:
        super().__init__()
        self.inducing_variable = inducing_variable

    @property
    @check_shapes(
        "return: []",
    )
    def num_inducing(self) -> int:
        return self.inducing_variable.num_inducing

    @property
    def inducing_variables(self) -> Tuple[InducingVariables, ...]:
        return (self.inducing_variable,)

    @property
    def shape(self) -> Optional[Tuple[Optional[int], ...]]:
        inner = self.inducing_variable.shape
        if inner is None:
            return inner
        return tuple(inner[:2]) + (None,)


class FallbackSeparateIndependentInducingVariables(MultioutputInducingVariables):
    """One set of inducing variables per latent process, on the generic route;
    every set holds the same number M (``inducing_variables.py:58-89``)."""

    @check_shapes("inducing_variable_list[all]: [., D, 1]")
    def __init__(self, inducing_variable_list: Sequence[InducingVariables]) -> None:
        super().__init__()
        self.inducing_variable_list = nn.ModuleList(inducing_variable_list)

    @property
    @check_shapes(
        "return: []",
    )
    def num_inducing(self) -> int:
        nums = {iv.num_inducing for iv in self.inducing_variable_list}
        if len(nums) != 1:
            raise ValueError(
                "'num_inducing' does not make sense when children have different numbers of inducing points."
            )
        return next(iter(nums))

    @property
    def inducing_variables(self) -> Tuple[InducingVariables, ...]:
        return tuple(self.inducing_variable_list)

    @property
    def shape(self) -> Optional[Tuple[Optional[int], ...]]:
        inner = self.inducing_variable_list[0].shape
        if inner is None:
            return inner
        for iv in self.inducing_variable_list[1:]:
            if inner != iv.shape:
                return None
        return tuple(inner[:2]) + (len(self.inducing_variable_list),)


class SharedIndependentInducingVariables(FallbackSharedIndependentInducingVariables):
    """Opts in to the independent-outputs conditional
    (``inducing_variables.py:92-94``)."""


class SeparateIndependentInducingVariables(FallbackSeparateIndependentInducingVariables):
    """Opts in to the independent-outputs conditional
    (``inducing_variables.py:97-98``)."""
