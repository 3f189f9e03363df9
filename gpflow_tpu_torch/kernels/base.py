"""Kernel base classes (counterpart of ``gpflow_tpu/kernels/base.py``).

``kernel(X, X2)`` gives K(X, X2) [..., N, ..., M], ``kernel(X)`` gives K(X, X)
and ``kernel(X, full_cov=False)`` its diagonal [..., N]; inputs are first
cut to ``active_dims``. ``k1 + k2`` and ``k1 * k2`` build a ``Sum`` and a
``Product``, whose terms are an ``nn.ModuleList`` (so every term's
parameters are the model's); nested sums and products of one type flatten.
"""
from __future__ import annotations

import abc
from functools import reduce
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..base import Module, Parameter, input_to_tensor
from ..utilities.shapes import check_shapes

__all__ = [
    "ActiveDims",
    "Combination",
    "Kernel",
    "Product",
    "ReducingCombination",
    "Sum",
]

ActiveDims = Union[slice, Sequence[int]]
NormalizedActiveDims = Union[slice, Tuple[int, ...]]


def _columns(X: torch.Tensor, dims: NormalizedActiveDims) -> torch.Tensor:
    """X[..., dims] without a Python list as the index, which torch would
    copy to X's device and so synchronise the host with a CUDA device: a
    view where the dims are evenly spaced and ascending, else a stack of
    column views."""
    if isinstance(dims, slice):
        return X[..., dims]
    if not dims:
        return X[..., 0:0]
    step = dims[1] - dims[0] if len(dims) > 1 else 1
    if step > 0 and min(dims) >= 0 and all(b - a == step for a, b in zip(dims, dims[1:])):
        if dims[-1] >= X.shape[-1]:
            raise IndexError(f"active dim {dims[-1]} is out of bounds for inputs with {X.shape[-1]} columns")
        return X[..., dims[0]:dims[-1] + 1:step]
    return torch.stack([X[..., d] for d in dims], dim=-1)


class Kernel(Module, metaclass=abc.ABCMeta):
    """The basic kernel class; manages active dimensions."""

    def __init__(self, active_dims: Optional[ActiveDims] = None, name: Optional[str] = None) -> None:
        super().__init__()
        self._active_dims = self._normalize_active_dims(active_dims)
        if name is not None:
            self._name = name

    @staticmethod
    def _normalize_active_dims(value: Optional[ActiveDims]) -> NormalizedActiveDims:
        if value is None:
            return slice(None, None, None)
        if isinstance(value, slice):
            return value
        return tuple(int(v) for v in np.asarray(value, dtype=int).reshape(-1))

    @property
    def active_dims(self) -> NormalizedActiveDims:
        return self._active_dims

    @active_dims.setter
    def active_dims(self, value: ActiveDims) -> None:
        self._active_dims = self._normalize_active_dims(value)

    def on_separate_dims(self, other: "Kernel") -> bool:
        """True if the two kernels act on provably disjoint dimensions
        (conservative for slices; ``base.py:62-67``)."""
        if isinstance(self.active_dims, slice) or isinstance(other.active_dims, slice):
            return False
        return not bool(set(self.active_dims) & set(other.active_dims))

    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return[0]: [batch..., N, I]",
        "return[1]: [batch2..., N2, I]",
    )
    def slice(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Selects the ``active_dims`` columns of X and X2."""
        X = _columns(X, self.active_dims)
        if X2 is not None:
            X2 = _columns(X2, self.active_dims)
        return X, X2

    def slice_cov(self, cov: torch.Tensor) -> torch.Tensor:
        """The ``active_dims`` rows and columns of covariances [..., N, D, D];
        a [N, D] diagonal is first expanded to full matrices
        (``gpflow_tpu/kernels/base.py:93-105``). List dims are taken as
        views, as in ``slice``, never by a list index."""
        if cov.ndim == 2:
            cov = torch.diag_embed(cov)
        dims = self.active_dims
        if isinstance(dims, slice):
            return cov[..., dims, dims]
        return _columns(_columns(cov, dims).mT, dims).mT

    @check_shapes(
        "ard_parameter: [any...]",
    )
    def _validate_ard_active_dims(self, ard_parameter: Parameter) -> None:
        if isinstance(self.active_dims, slice):
            return
        shape = ard_parameter.shape
        if len(shape) > 0 and shape[0] != len(self.active_dims):
            raise ValueError(
                f"Size of `active_dims` {self.active_dims} does not match "
                f"size of ard parameter ({shape[0]})"
            )

    @abc.abstractmethod
    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, batch2..., N2] if X2 is not None",
        "return: [batch..., N, N] if X2 is None",
    )
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    @abc.abstractmethod
    @check_shapes(
        "X: [batch..., N, D]",
        "return: [batch..., N]",
    )
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @check_shapes(
        "X: [batch..., N, D]",
        "X2: [batch2..., N2, D]",
        "return: [batch..., N, batch2..., N2] if full_cov and (X2 is not None)",
        "return: [batch..., N, N] if full_cov and (X2 is None)",
        "return: [batch..., N] if not full_cov",
    )
    def forward(
        self,
        X: torch.Tensor,
        X2: Optional[torch.Tensor] = None,
        *,
        full_cov: bool = True,
        presliced: bool = False,
    ) -> torch.Tensor:
        if (not full_cov) and (X2 is not None):
            raise ValueError("Ambiguous inputs: `not full_cov` and `X2` are not compatible.")
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        if not presliced:
            X, X2 = self.slice(X, X2)
        if not full_cov:
            return self.K_diag(X)
        return self.K(X, X2)

    def __add__(self, other: "Kernel") -> "Kernel":
        return Sum([self, other])

    def __mul__(self, other: "Kernel") -> "Kernel":
        return Product([self, other])


class Combination(Kernel):
    """Combines a list of kernels, held in the ``nn.ModuleList``
    ``kernels``; a nested combination of the same type is flattened into it
    (``base.py:162-194``)."""

    def __init__(self, kernels: Sequence[Kernel], name: Optional[str] = None) -> None:
        super().__init__(name=name)
        if not all(isinstance(k, Kernel) for k in kernels):
            raise TypeError("can only combine Kernel instances")
        self._set_kernels(kernels)

    def _set_kernels(self, kernels: Sequence[Kernel]) -> None:
        kernels_list: List[Kernel] = []
        for k in kernels:
            if isinstance(k, self.__class__):
                kernels_list.extend(k.kernels)
            else:
                kernels_list.append(k)
        self.kernels = nn.ModuleList(kernels_list)

    @property
    def on_separate_dimensions(self) -> bool:
        """True if no two terms share an active dimension (False whenever a
        term's active dimensions are a slice)."""
        if any(isinstance(k.active_dims, slice) for k in self.kernels):
            return False
        dimlist = [set(k.active_dims) for k in self.kernels]
        for i, dims_i in enumerate(dimlist):
            for dims_j in dimlist[i + 1:]:
                if dims_i & dims_j:
                    return False
        return True


class ReducingCombination(Combination):
    """Reduces its terms' outputs. Like the JAX package it overrides
    ``forward`` with no inherited contract: a Sum or Product may combine
    kernels whose outputs have other shapes than the single-output one."""

    def forward(
        self,
        X: torch.Tensor,
        X2: Optional[torch.Tensor] = None,
        *,
        full_cov: bool = True,
        presliced: bool = False,
    ) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        return self._reduce([k(X, X2, full_cov=full_cov, presliced=presliced) for k in self.kernels])

    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        X, X2 = input_to_tensor(self, X), input_to_tensor(self, X2)
        return self._reduce([k.K(X, X2) for k in self.kernels])

    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        X = input_to_tensor(self, X)
        return self._reduce([k.K_diag(X) for k in self.kernels])

    @property
    @abc.abstractmethod
    def _reduce(self) -> Callable[[Sequence[torch.Tensor]], torch.Tensor]:
        pass


class Sum(ReducingCombination):
    @property
    def _reduce(self) -> Callable[[Sequence[torch.Tensor]], torch.Tensor]:
        return lambda ks: reduce(torch.add, ks)


class Product(ReducingCombination):
    @property
    def _reduce(self) -> Callable[[Sequence[torch.Tensor]], torch.Tensor]:
        return lambda ks: reduce(torch.multiply, ks)
