"""Kernel base class (counterpart of ``gpflow_tpu/kernels/base.py``).

``kernel(X, X2)`` gives K(X, X2) [..., N, ..., M], ``kernel(X)`` gives K(X, X)
and ``kernel(X, full_cov=False)`` its diagonal [..., N]; inputs are first
cut to ``active_dims``.
"""
from __future__ import annotations

import abc
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..base import Module, Parameter

__all__ = ["ActiveDims", "Kernel"]

ActiveDims = Union[slice, Sequence[int]]
NormalizedActiveDims = Union[slice, Tuple[int, ...]]


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

    def slice(
        self, X: torch.Tensor, X2: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Selects the ``active_dims`` columns of X and X2."""
        dims = self.active_dims
        index = dims if isinstance(dims, slice) else list(dims)
        X = X[..., index]
        if X2 is not None:
            X2 = X2[..., index]
        return X, X2

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
    def K(self, X: torch.Tensor, X2: Optional[torch.Tensor] = None) -> torch.Tensor:
        raise NotImplementedError

    @abc.abstractmethod
    def K_diag(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

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
        if not presliced:
            X, X2 = self.slice(X, X2)
        if not full_cov:
            return self.K_diag(X)
        return self.K(X, X2)
