"""Parameter transforms (counterpart of ``gpflow_tpu/bijectors.py``).

A bijector maps an unconstrained tensor to its constrained value with
``forward`` and back with ``inverse``; ``forward_log_det_jacobian(x)`` is
log|dy/dx| elementwise (callers sum it). Bijectors are frozen dataclasses that
hold no tensors, so a ``Parameter`` moves between devices with ``.to()``
without touching them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "Bijector",
    "Chain",
    "Exp",
    "FillTriangular",
    "Identity",
    "Shift",
    "Sigmoid",
    "Softplus",
    "TriangularMask",
    "positive",
    "triangular",
    "triangular_size",
]


@dataclasses.dataclass(frozen=True)
class Bijector:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward_shape(self, shape: torch.Size) -> torch.Size:
        """The shape of ``forward(x)`` for an x of ``shape``."""
        return shape

    def forward_np(self, x: np.ndarray) -> np.ndarray:
        """``forward`` of a numpy array, as a numpy array of its dtype
        (``gpflow_tpu/bijectors.py:57-61``)."""
        with torch.no_grad():
            return self.forward(torch.as_tensor(np.asarray(x))).numpy()

    def inverse_np(self, y: np.ndarray) -> np.ndarray:
        """``inverse`` of a numpy array, as a numpy array of its dtype."""
        with torch.no_grad():
            return self.inverse(torch.as_tensor(np.asarray(y))).numpy()

    @property
    def name(self) -> str:
        return type(self).__name__.lower()


@dataclasses.dataclass(frozen=True)
class Identity(Bijector):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)


@dataclasses.dataclass(frozen=True)
class Exp(Bijector):
    """``gpflow_tpu/bijectors.py:87-103``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return torch.log(y)

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # log(1 + e^x) as the JAX package writes it; torch's softplus returns x
    # itself above its threshold, which differs in the last digits
    return torch.logaddexp(x, torch.zeros_like(x))


@dataclasses.dataclass(frozen=True)
class Softplus(Bijector):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _softplus(x)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        # log(e^y - 1) = y + log(-expm1(-y)), stable for large and small y
        return y + torch.log(-torch.expm1(-y))

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        # log sigmoid(x) = -softplus(-x)
        return -_softplus(-x)


@dataclasses.dataclass(frozen=True)
class Shift(Bijector):
    shift: float = 0.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.shift

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return y - self.shift

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros_like(x)


@dataclasses.dataclass(frozen=True)
class Sigmoid(Bijector):
    """Maps R onto (low, high) (``gpflow_tpu/bijectors.py:155-185``)."""

    low: float = 0.0
    high: float = 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.low + (self.high - self.low) * torch.sigmoid(x)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        z = (y - self.low) / (self.high - self.low)
        return torch.log(z) - torch.log1p(-z)

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        return math.log(self.high - self.low) - _softplus(-x) - _softplus(x)


@dataclasses.dataclass(frozen=True)
class Chain(Bijector):
    """Applies ``bijectors`` right to left: forward = b[0](b[1](...(x)))."""

    bijectors: Tuple[Bijector, ...]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for b in reversed(self.bijectors):
            x = b.forward(x)
        return x

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        for b in self.bijectors:
            y = b.inverse(y)
        return y

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        ldj = torch.zeros_like(x)
        for b in reversed(self.bijectors):
            ldj = ldj + b.forward_log_det_jacobian(x)
            x = b.forward(x)
        return ldj

    def forward_shape(self, shape: torch.Size) -> torch.Size:
        for b in reversed(self.bijectors):
            shape = b.forward_shape(shape)
        return shape


def _tri_n(m: int) -> int:
    n = int(round((math.sqrt(8.0 * m + 1.0) - 1.0) / 2.0))
    if triangular_size(n) != m:
        raise ValueError(f"Last dimension {m} is not a triangular number")
    return n


@dataclasses.dataclass(frozen=True)
class FillTriangular(Bijector):
    """Packed vector [..., n(n+1)/2] <-> lower-triangular [..., n, n]
    (``gpflow_tpu/bijectors.py:262-288``); volume preserving (ldj = 0).

    ``forward`` is the JAX package's concatenate, reverse and reshape (the
    packing order of ``tfp.math.fill_triangular``, not row-major);
    ``inverse`` gathers the lower triangle in that order. ``TriangularMask``
    is what ``triangular()`` gives; this packed form is for callers that
    store n(n+1)/2 values.
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = _tri_n(x.shape[-1])
        xc = torch.cat([x[..., n:], torch.flip(x, dims=(-1,))], dim=-1)  # [..., n * n]
        return torch.tril(xc.reshape(x.shape[:-1] + (n, n)))

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        n = y.shape[-1]
        # the forward's construction run on indices: which packed entry lands
        # at each slot of the lower triangle, in row-major order
        idx = np.arange(triangular_size(n))
        packed_at_slot = np.concatenate([idx[n:], idx[::-1]]).reshape(n, n)
        rows, cols = np.tril_indices(n)
        order = np.argsort(packed_at_slot[rows, cols])
        return y[..., torch.as_tensor(rows[order], device=y.device), torch.as_tensor(cols[order], device=y.device)]

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)

    def forward_shape(self, shape: torch.Size) -> torch.Size:
        n = _tri_n(shape[-1])
        return torch.Size(tuple(shape[:-1]) + (n, n))


@dataclasses.dataclass(frozen=True)
class TriangularMask(Bijector):
    """Square matrix <-> its lower triangle (``gpflow_tpu/bijectors.py:288-315``).

    The unconstrained value is the full [..., n, n] matrix and ``forward`` is
    one ``tril``. The upper triangle gets zero gradient, so it stays at its
    initial zeros under plain gradient steps (not under weight decay).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tril(x)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        return torch.tril(y)

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape[:-2], dtype=x.dtype, device=x.device)


def positive(lower: Optional[float] = None, base: Optional[str] = None) -> Bijector:
    """``shift(lower) o softplus``, or ``shift(lower) o exp`` with
    ``base="exp"`` (``gpflow_tpu/bijectors.py:317-338``); ``lower`` defaults
    to ``config.default_positive_minimum()`` and ``base`` to
    ``config.default_positive_bijector()``."""
    from .config import default_positive_bijector, default_positive_minimum

    name = (base if base is not None else default_positive_bijector()).lower()
    if name == "softplus":
        bijector: Bijector = Softplus()
    elif name == "exp":
        bijector = Exp()
    else:
        raise ValueError(f"Unknown positive bijector {name!r}")
    shift = lower if lower is not None else default_positive_minimum()
    if shift != 0.0:
        return Chain((Shift(float(shift)), bijector))
    return bijector


def triangular() -> TriangularMask:
    """The transform of full-covariance ``q_sqrt`` parameters."""
    return TriangularMask()


# imported at the end, as in the JAX package: ``utilities`` imports this
# module, and needs ``positive`` and ``triangular`` defined first
from .utilities.shapes import check_shapes  # noqa: E402


@check_shapes(
    "n: []",
    "return: []",
)
def triangular_size(n: int) -> int:
    """The number of free entries of an n x n lower-triangular matrix
    (``gpflow_tpu/bijectors.py:355-363``)."""
    return n * (n + 1) // 2
