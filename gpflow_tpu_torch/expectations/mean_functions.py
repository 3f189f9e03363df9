"""Analytic expectations of mean functions (counterpart of
``gpflow_tpu/expectations/mean_functions.py``)."""
from __future__ import annotations

from typing import Any, Type

import torch

from .. import functions as mfn
from ..base import Parameter
from ..probability_distributions import Gaussian
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import expectation

NoneType: Type[None] = type(None)


def _value(x: Any) -> torch.Tensor:
    """A Linear mean's A or b (Parameters), or Identity's (tensors)."""
    return x.value if isinstance(x, Parameter) else x


def _e_xxt(p: Gaussian) -> torch.Tensor:
    """<x x^T>_p -> [N, D, D]."""
    return p.cov + (p.mu[:, :, None] * p.mu[:, None, :])


@dispatch.expectation.register(Gaussian, (mfn.Linear, mfn.Constant), NoneType, NoneType, NoneType)
@check_shapes("p: [N, D]", "return: [N, Q]")
def _expectation_gaussian_linear(p, mean, _, __, ___, nghp=None):
    """<m(X)>_p(X) of a Linear, Identity or Constant mean -> [N, Q]."""
    return mean(p.mu)


@dispatch.expectation.register(Gaussian, mfn.Constant, NoneType, mfn.Constant, NoneType)
@check_shapes("p: [N, D]", "return: [N, Q1, Q2]")
def _expectation_gaussian_constant__constant(p, mean1, _, mean2, __, nghp=None):
    return mean1(p.mu)[:, :, None] * mean2(p.mu)[:, None, :]


@dispatch.expectation.register(Gaussian, mfn.Constant, NoneType, mfn.MeanFunction, NoneType)
@check_shapes("p: [N, D]", "return: [N, Q1, Q2]")
def _expectation_gaussian_constant__meanfunction(p, mean1, _, mean2, __, nghp=None):
    e_mean2 = expectation(p, mean2)
    return mean1(p.mu)[:, :, None] * e_mean2[:, None, :]


@dispatch.expectation.register(Gaussian, mfn.MeanFunction, NoneType, mfn.Constant, NoneType)
@check_shapes("p: [N, D]", "return: [N, Q1, Q2]")
def _expectation_gaussian_meanfunction__constant(p, mean1, _, mean2, __, nghp=None):
    e_mean1 = expectation(p, mean1)
    return e_mean1[:, :, None] * mean2(p.mu)[:, None, :]


@dispatch.expectation.register(Gaussian, mfn.Identity, NoneType, mfn.Identity, NoneType)
@check_shapes("p: [N, D]", "return: [N, D, D]")
def _expectation_gaussian_identity__identity(p, mean1, _, mean2, __, nghp=None):
    """<x x^T>_p -> [N, D, D]."""
    return _e_xxt(p)


@dispatch.expectation.register(Gaussian, mfn.Identity, NoneType, mfn.Linear, NoneType)
@check_shapes("p: [N, D]", "return: [N, D, Q]")
def _expectation_gaussian_identity__linear(p, mean1, _, mean2, __, nghp=None):
    """<x (A x + b)^T>_p -> [N, D, Q]."""
    A, b = _value(mean2.A), _value(mean2.b)
    return torch.matmul(_e_xxt(p), A) + p.mu[:, :, None] * b[None, None, :]


@dispatch.expectation.register(Gaussian, mfn.Linear, NoneType, mfn.Identity, NoneType)
@check_shapes("p: [N, D]", "return: [N, Q, D]")
def _expectation_gaussian_linear__identity(p, mean1, _, mean2, __, nghp=None):
    """<(A x + b) x^T>_p -> [N, Q, D]."""
    A, b = _value(mean1.A), _value(mean1.b)
    return torch.matmul(A.mT, _e_xxt(p)) + b[None, :, None] * p.mu[:, None, :]


@dispatch.expectation.register(Gaussian, mfn.Linear, NoneType, mfn.Linear, NoneType)
@check_shapes("p: [N, D]", "return: [N, Q1, Q2]")
def _expectation_gaussian_linear__linear(p, mean1, _, mean2, __, nghp=None):
    """<m1(x) m2(x)^T>_p of two Linear means -> [N, Q1, Q2]."""
    A1, b1 = _value(mean1.A), _value(mean1.b)
    A2, b2 = _value(mean2.A), _value(mean2.b)
    e_A1t_xxt_A2 = torch.einsum("iq,nij,jz->nqz", A1, _e_xxt(p), A2)
    e_A1t_x_b2t = torch.einsum("iq,ni,z->nqz", A1, p.mu, b2)
    e_b1_xt_A2 = torch.einsum("q,ni,iz->nqz", b1, p.mu, A2)
    e_b1_b2t = b1[:, None] * b2[None, :]
    return e_A1t_xxt_A2 + e_A1t_x_b2t + e_b1_xt_A2 + e_b1_b2t
