"""The expectation entry points (counterpart of
``gpflow_tpu/expectations/expectations.py``)."""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from ..functions import MeanFunction
from ..inducing_variables import InducingVariables
from ..kernels import Kernel
from ..probability_distributions import DiagonalGaussian, Gaussian, MarkovGaussian, ProbabilityDistribution
from . import dispatch

__all__ = ["expectation", "quadrature_expectation"]

ProbabilityDistributionLike = Union[ProbabilityDistribution, Tuple[torch.Tensor, torch.Tensor]]
ExpectationObject = Union[Kernel, MeanFunction, None]
PackedExpectationObject = Union[ExpectationObject, Tuple[Kernel, InducingVariables]]


def expectation(
    p: ProbabilityDistributionLike,
    obj1: PackedExpectationObject,
    obj2: PackedExpectationObject = None,
    nghp: Optional[int] = None,
) -> torch.Tensor:
    """<obj1(x) obj2(x)>_p(x): the analytic implementation where one is
    registered, Gauss-Hermite quadrature with ``nghp`` points a dimension
    otherwise. A kernel paired with inducing variables stands for K(x, Z).

    The psi statistics: psi0 = expectation(p, kernel) [N];
    psi1 = expectation(p, (kernel, iv)) [N, M];
    psi2 = expectation(p, (kernel, iv), (kernel, iv)) [N, M, M].
    A tuple ``p`` = (mu, cov) is a DiagonalGaussian for cov [N, D], a
    Gaussian for [N, D, D] and a MarkovGaussian for [2, N + 1, D, D]."""
    p, obj1, feat1, obj2, feat2 = _init_expectation(p, obj1, obj2)
    try:
        return dispatch.expectation(p, obj1, feat1, obj2, feat2, nghp=nghp)
    except NotImplementedError:
        return dispatch.quadrature_expectation(p, obj1, feat1, obj2, feat2, nghp=nghp)


def quadrature_expectation(
    p: ProbabilityDistributionLike,
    obj1: PackedExpectationObject,
    obj2: PackedExpectationObject = None,
    nghp: Optional[int] = None,
) -> torch.Tensor:
    """<obj1(x) obj2(x)>_p(x) by Gauss-Hermite quadrature, always."""
    p, obj1, feat1, obj2, feat2 = _init_expectation(p, obj1, obj2)
    return dispatch.quadrature_expectation(p, obj1, feat1, obj2, feat2, nghp=nghp)


def _init_expectation(
    p: ProbabilityDistributionLike, obj1: PackedExpectationObject, obj2: PackedExpectationObject
):
    if isinstance(p, tuple):
        mu, cov = p
        classes = [DiagonalGaussian, Gaussian, MarkovGaussian]
        p = classes[cov.ndim - 2](mu, cov)
    obj1, feat1 = obj1 if isinstance(obj1, tuple) else (obj1, None)
    obj2, feat2 = obj2 if isinstance(obj2, tuple) else (obj2, None)
    return p, obj1, feat1, obj2, feat2
