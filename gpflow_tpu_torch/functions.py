"""Functions and mean functions (counterpart of ``gpflow_tpu/functions.py``).

A Function is an ``nn.Module`` whose ``forward`` maps X [batch..., N, D] to
[batch..., N, Q]. ``SwitchedFunction`` evaluates every branch on the whole
batch and selects per row, as the JAX package does (no data-dependent
shapes, hence no host synchronisation on a CUDA device).
"""
from __future__ import annotations

from typing import Any, Collection, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .base import Module, Parameter, input_to_tensor
from .config import default_device, default_float
from .utilities.shapes import check_shapes, inherit_check_shapes

__all__ = [
    "Additive",
    "Constant",
    "Function",
    "Identity",
    "Linear",
    "MeanFunction",
    "Polynomial",
    "Product",
    "SwitchedFunction",
    "SwitchedMeanFunction",
    "Zero",
]


class Function(Module):
    """``function(X: [batch..., N, D]) -> [batch..., N, Q]``; also used for
    input-dependent likelihood parameters (``functions.py:37-57``)."""

    @check_shapes(
        "X: [batch..., N, D]",
        "return: [batch..., N, Q]",
    )
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("Implement the forward method for this mean function")

    def __call__(self, X: Any, *args: Any, **kwargs: Any) -> torch.Tensor:
        return super().__call__(input_to_tensor(self, X), *args, **kwargs)

    def __add__(self, other: "Function") -> "Function":
        return Additive(self, other)

    def __mul__(self, other: "Function") -> "Function":
        return Product(self, other)


class MeanFunction(Function):
    """Marks Functions appropriate as GP mean functions."""


class Additive(MeanFunction, Function):
    def __init__(self, first_part: Function, second_part: Function) -> None:
        super().__init__()
        self.add_1 = first_part
        self.add_2 = second_part

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.add(self.add_1(X), self.add_2(X))


class Product(MeanFunction, Function):
    def __init__(self, first_part: Function, second_part: Function) -> None:
        super().__init__()
        self.prod_1 = first_part
        self.prod_2 = second_part

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.multiply(self.prod_1(X), self.prod_2(X))


class Linear(MeanFunction, Function):
    """y_i = A x_i + b (``functions.py:80-100``)."""

    @check_shapes(
        "A: [broadcast D, broadcast Q]",
        "b: [broadcast Q]",
    )
    def __init__(self, A: Any = None, b: Any = None) -> None:
        super().__init__()
        A = [[1.0]] if A is None else A  # Python lists take default_float()
        b = [0.0] if b is None else b
        if isinstance(A, Parameter):
            if len(A.shape) < 2:
                raise ValueError("Linear mean function: A must be at least 2-dimensional")
            self.A = A
        else:
            explicit = isinstance(A, (np.ndarray, np.generic, torch.Tensor))  # keeps its float dtype
            A = torch.atleast_2d(A) if isinstance(A, torch.Tensor) else np.atleast_2d(np.asarray(A))
            self.A = Parameter(A, dtype=None if explicit else default_float(), name="A")
        self.b = Parameter(b, name="b")

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.tensordot(X, self.A.value, dims=([-1], [0])) + self.b.value


class Identity(Linear, Function):
    """y_i = x_i (``functions.py:103-129``). ``A`` and ``b`` are the identity
    and zeros of ``input_dim``, not Parameters."""

    def __init__(self, input_dim: Optional[int] = None) -> None:
        Function.__init__(self)
        self.input_dim = input_dim

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return X

    def _require_input_dim(self) -> int:
        if self.input_dim is None:
            raise ValueError(
                "An input_dim needs to be specified when using the "
                "`Identity` mean function in combination with expectations."
            )
        return self.input_dim

    @property
    def A(self) -> torch.Tensor:
        return torch.eye(self._require_input_dim(), dtype=default_float(), device=default_device())

    @property
    def b(self) -> torch.Tensor:
        return torch.zeros(self._require_input_dim(), dtype=default_float(), device=default_device())


class Constant(MeanFunction, Function):
    """y_i = c (``functions.py:132-146``)."""

    @check_shapes(
        "c: [broadcast Q]",
    )
    def __init__(self, c: Any = None) -> None:
        super().__init__()
        c = [0.0] if c is None else c  # a Python list takes default_float()
        self.c = Parameter(c, name="c")

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        c = self.c.value.reshape((1,) * (X.ndim - 1) + (-1,))
        return c.expand(X.shape[:-1] + (c.shape[-1],))


class Zero(Constant, Function):
    """y_i = 0 (``functions.py:149-158``). A Constant with no Parameter: its
    ``__init__`` skips ``Constant.__init__``."""

    def __init__(self, output_dim: int = 1) -> None:
        Function.__init__(self)
        self.output_dim = output_dim

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        return torch.zeros(X.shape[:-1] + (self.output_dim,), dtype=X.dtype, device=X.device)


class Polynomial(MeanFunction, Function):
    """Generic polynomial mean function (``functions.py:161-206``). Integer
    powers are built by repeated multiplication, exact and NaN-free at 0."""

    @check_shapes("w: [broadcast output_dim, broadcast n_terms]")
    def __init__(
        self,
        degree: int,
        input_dim: int = 1,
        output_dim: int = 1,
        w: Any = None,
    ) -> None:
        super().__init__()
        powers = tuple(self.compute_powers(degree, input_dim))
        if w is None:
            w = [1.0] + (len(powers) - 1) * [0.0]
        w_shape = (output_dim, len(powers))
        self.degree = int(degree)
        device = default_device()
        self.register_buffer("powers", torch.tensor(powers, dtype=default_float(), device=device), persistent=False)
        # [n_terms, input_dim]
        self.register_buffer("_int_powers", torch.tensor(powers, dtype=torch.long, device=device), persistent=False)
        self.register_buffer("_dims", torch.arange(input_dim, device=device), persistent=False)
        w = np.broadcast_to(np.asarray(w, dtype=np.float64), w_shape)
        self.w = Parameter(np.array(w), dtype=default_float(), name="w")

    @staticmethod
    def compute_powers(degree: int, input_dim: int) -> Sequence[Tuple[int, ...]]:
        """All non-negative integer tuples of length input_dim summing to at
        most degree, in lexicographic order."""
        if not input_dim:
            return [()]
        result = []
        for i in range(degree + 1):
            for inner in Polynomial.compute_powers(degree - i, input_dim - 1):
                result.append((i,) + inner)
        return result

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        pows = [torch.ones_like(X)]
        for _ in range(self.degree):
            pows.append(pows[-1] * X)
        stacked = torch.stack(pows, dim=-2)  # [batch..., degree+1, input_dim]
        raised = stacked[..., self._int_powers, self._dims]  # [batch..., n_terms, input_dim]
        prod = torch.prod(raised, dim=-1)  # [batch..., n_terms]
        return torch.einsum("...i,ji->...j", prod, self.w.value)


class SwitchedFunction(MeanFunction, Function):
    """A different function per data point, chosen by the integer label in
    the last column of X (``functions.py:209-225``). Every branch is
    evaluated on the whole batch; a label outside the branches selects none
    and gives 0."""

    def __init__(self, function_list: Collection[Function]) -> None:
        super().__init__()
        self.functions = nn.ModuleList(function_list)

    @inherit_check_shapes
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        ind = X[..., -1].to(torch.long)  # [batch...]
        Xdata = X[..., :-1]
        results = torch.stack([f(Xdata) for f in self.functions], dim=0)  # [K, batch..., Q]
        branches = torch.arange(len(self.functions), device=X.device).reshape((-1,) + (1,) * ind.ndim)
        one_hot = (ind[None] == branches).to(results.dtype)  # [K, batch...]
        return torch.sum(results * one_hot[..., None], dim=0)


class SwitchedMeanFunction(SwitchedFunction):
    """Renamed SwitchedFunction kept for backwards compatibility."""

    def __init__(self, meanfunction_list: Collection[MeanFunction]) -> None:
        super().__init__(function_list=meanfunction_list)

    @property
    def meanfunctions(self) -> Collection[MeanFunction]:
        return self.functions
