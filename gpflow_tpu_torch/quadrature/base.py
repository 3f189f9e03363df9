"""Gaussian-expectation quadrature base (counterpart of
``gpflow_tpu/quadrature/base.py``)."""
from __future__ import annotations

import abc
from collections.abc import Iterable
from typing import Any, Callable, List, Tuple, Union

import torch

from ..base import numpy_to_tensors
from ..utilities.shapes import check_shapes

__all__ = ["GaussianQuadrature"]


class GaussianQuadrature(abc.ABC):
    """E_q[f(x)] for diagonal Gaussians q, as a weighted sum over quadrature
    points; subclasses define the points and weights."""

    @abc.abstractmethod
    @check_shapes(
        "mean: [batch..., dim]",
        "var: [batch..., dim]",
        "return[0]: [N_quad, batch..., dim]",
        "return[1]: [N_quad, broadcast ones...]",
    )
    def _build_X_W(self, mean: torch.Tensor, var: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """mean, var [batch..., dim] -> X [N_quad, batch..., dim] and
        W [N_quad, 1..., 1]."""

    @check_shapes(
        "mean: [batch..., dim]",
        "var: [batch..., dim]",
    )
    def __call__(
        self,
        fun: Union[Callable[..., torch.Tensor], Iterable],
        mean: torch.Tensor,
        var: torch.Tensor,
        *args: Any,
        **kwargs: Any,
    ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """sum_i W_i fun(X_i, ...) (``quadrature/base.py:36-52``). ``fun``
        maps [N_quad, batch..., dim] to [N_quad, batch..., d']; the extra
        arguments broadcast against the leading quadrature axis. A list of
        functions gives a list of results. numpy ``mean``, ``var`` and extra
        arguments become tensors by the rule of ``base.numpy_to_tensors``."""
        (mean, var, *args), kwargs = numpy_to_tensors((mean, var, *args), kwargs)
        X, W = self._build_X_W(mean, var)
        if isinstance(fun, Iterable) and not callable(fun):
            return [torch.sum(f(X, *args, **kwargs) * W, dim=0) for f in fun]
        return torch.sum(fun(X, *args, **kwargs) * W, dim=0)

    @check_shapes(
        "mean: [batch..., dim]",
        "var: [batch..., dim]",
    )
    def logspace(
        self,
        fun: Union[Callable[..., torch.Tensor], Iterable],
        mean: torch.Tensor,
        var: torch.Tensor,
        *args: Any,
        **kwargs: Any,
    ) -> Union[torch.Tensor, List[torch.Tensor]]:
        """log sum_i exp(fun(X_i, ...) + log W_i) (``quadrature/base.py:58-71``),
        with numpy converted as in ``__call__``."""
        (mean, var, *args), kwargs = numpy_to_tensors((mean, var, *args), kwargs)
        X, W = self._build_X_W(mean, var)
        logW = torch.log(W)
        if isinstance(fun, Iterable) and not callable(fun):
            return [torch.logsumexp(f(X, *args, **kwargs) + logW, dim=0) for f in fun]
        return torch.logsumexp(fun(X, *args, **kwargs) + logW, dim=0)
