"""Prior distributions for Parameters (counterpart of ``gpflow_tpu/priors.py``).

A prior is a frozen dataclass with Python-float hyperparameters and a
``log_prob`` that evaluates elementwise through ``logdensities``. Each
hyperparameter enters the computation as a 0-d tensor filled on the value's
device (``torch.full``, a fill kernel): a host-to-device copy of a Python
float would make the host wait for the device on every evaluation.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from . import logdensities
from .base import array_inputs

__all__ = [
    "Beta",
    "Exponential",
    "Gamma",
    "HalfNormal",
    "Laplace",
    "LogNormal",
    "Normal",
    "Prior",
    "StudentT",
    "Uniform",
]


def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-d tensor of ``x``'s dtype on ``x``'s device."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


@dataclasses.dataclass(frozen=True)
class Prior:
    def __post_init__(self) -> None:
        # hyperparameters are Python floats (``gpflow_tpu/priors.py:33-49``)
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if not isinstance(v, float):
                try:
                    object.__setattr__(self, f.name, float(v))
                except (TypeError, ValueError) as e:
                    raise TypeError(
                        f"{type(self).__name__}.{f.name} must be a Python scalar; got {type(v).__name__}"
                    ) from e

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    @property
    def name(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(frozen=True)
class Normal(Prior):
    loc: float = 0.0
    scale: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return logdensities.gaussian(x, _const(x, self.loc), _const(x, self.scale) ** 2)


@dataclasses.dataclass(frozen=True)
class LogNormal(Prior):
    loc: float = 0.0
    scale: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return logdensities.lognormal(x, _const(x, self.loc), _const(x, self.scale) ** 2)


@dataclasses.dataclass(frozen=True)
class Gamma(Prior):
    concentration: float = 1.0
    rate: float = 1.0  # log_prob uses scale = 1 / rate

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return logdensities.gamma(x, _const(x, self.concentration), 1.0 / _const(x, self.rate))


@dataclasses.dataclass(frozen=True)
class Exponential(Prior):
    rate: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return logdensities.exponential(x, 1.0 / _const(x, self.rate))


@dataclasses.dataclass(frozen=True)
class Beta(Prior):
    concentration1: float = 1.0
    concentration0: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return logdensities.beta(x, _const(x, self.concentration1), _const(x, self.concentration0))


@dataclasses.dataclass(frozen=True)
class Laplace(Prior):
    loc: float = 0.0
    scale: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return logdensities.laplace(x, _const(x, self.loc), _const(x, self.scale))


@dataclasses.dataclass(frozen=True)
class StudentT(Prior):
    df: float = 3.0
    loc: float = 0.0
    scale: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        return logdensities.student_t(x, _const(x, self.loc), _const(x, self.scale), self.df)


@dataclasses.dataclass(frozen=True)
class HalfNormal(Prior):
    """-inf below 0."""

    scale: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        density = math.log(2.0) + logdensities.gaussian(x, _const(x, 0.0), _const(x, self.scale) ** 2)
        return torch.where(x >= 0, density, -math.inf)


@dataclasses.dataclass(frozen=True)
class Uniform(Prior):
    """-inf outside [low, high]."""

    low: float = 0.0
    high: float = 1.0

    @array_inputs("x")
    def log_prob(self, x: torch.Tensor) -> torch.Tensor:
        inside = (x >= self.low) & (x <= self.high)
        return torch.where(inside, -torch.log(_const(x, self.high - self.low)), -math.inf)
