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

import torch

__all__ = [
    "Bijector",
    "Chain",
    "Exp",
    "Identity",
    "Shift",
    "Sigmoid",
    "Softplus",
    "TriangularMask",
    "positive",
    "triangular",
]


@dataclasses.dataclass(frozen=True)
class Bijector:
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward_log_det_jacobian(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

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
    to ``config.default_positive_minimum()``."""
    from .config import default_positive_minimum

    name = "softplus" if base is None else base.lower()
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
