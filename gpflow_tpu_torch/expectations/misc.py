"""Expectations by transposition, and the fallbacks of DiagonalGaussian and
MarkovGaussian to Gaussian (counterpart of
``gpflow_tpu/expectations/misc.py``)."""
from __future__ import annotations

from typing import Type

import torch

from .. import functions as mfn
from .. import kernels
from ..inducing_variables import InducingPoints, InducingVariables
from ..probability_distributions import DiagonalGaussian, Gaussian, MarkovGaussian
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import expectation

NoneType: Type[None] = type(None)


@dispatch.expectation.register((Gaussian, MarkovGaussian), mfn.Identity, NoneType, kernels.Linear, InducingPoints)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, D, M]")
def _expectation_gaussian__linear_inducingpoints(p, mean, _, kernel, inducing_variable, nghp=None):
    """<x_n K(x_n, Z)>_p, the transpose of <K(Z, x_n) x_n^T>_p -> [N, D, M]."""
    return expectation(p, (kernel, inducing_variable), mean).mT


@dispatch.expectation.register(
    (Gaussian, MarkovGaussian), kernels.Kernel, InducingVariables, mfn.MeanFunction, NoneType
)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, M, Q]")
def _expectation_gaussian_kernel_inducingvariables__meanfunction(p, kernel, inducing_variable, mean, _, nghp=None):
    """<K(Z, x_n) m(x_n)^T>_p -> [N, M, Q]."""
    return expectation(p, mean, (kernel, inducing_variable), nghp=nghp).mT


@dispatch.expectation.register(Gaussian, mfn.Constant, NoneType, kernels.Kernel, InducingPoints)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, Q, M]")
def _expectation_gaussian_constant__kernel_inducingpoints(p, constant_mean, _, kernel, inducing_variable, nghp=None):
    """<c K(x_n, Z)>_p -> [N, Q, M]."""
    c = constant_mean(p.mu)  # [N, Q]
    eKxz = expectation(p, (kernel, inducing_variable), nghp=nghp)  # [N, M]
    return c[..., None] * eKxz[:, None, :]


@dispatch.expectation.register(Gaussian, mfn.Linear, NoneType, kernels.Kernel, InducingPoints)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, Q, M]")
def _expectation_gaussian_linear__kernel_inducingpoints(p, linear_mean, _, kernel, inducing_variable, nghp=None):
    """<(A x_n + b) K(x_n, Z)>_p -> [N, Q, M]."""
    D = p.mu.shape[1]
    exKxz = expectation(p, mfn.Identity(int(D)), (kernel, inducing_variable), nghp=nghp)  # [N, D, M]
    eKxz = expectation(p, (kernel, inducing_variable), nghp=nghp)  # [N, M]
    A, b = linear_mean.A.value, linear_mean.b.value
    return torch.matmul(A.mT, exKxz) + b[None, :, None] * eKxz[:, None, :]


@dispatch.expectation.register(Gaussian, mfn.Identity, NoneType, kernels.Kernel, InducingPoints)
def _expectation_gaussian__kernel_inducingpoints(p, identity_mean, _, kernel, inducing_variable, nghp=None):
    """Identity is a Linear: without this, the Linear case above would ask
    for <x K(x, Z)> again; quadrature answers it instead."""
    raise NotImplementedError


@dispatch.expectation.register(
    DiagonalGaussian, object, (InducingVariables, NoneType), object, (InducingVariables, NoneType)
)
def _expectation_diagonal_generic(p, obj1, feat1, obj2, feat2, nghp=None):
    """A DiagonalGaussian without its own implementation as a full Gaussian."""
    gaussian = Gaussian(p.mu, torch.diag_embed(p.cov))
    return expectation(gaussian, (obj1, feat1), (obj2, feat2), nghp=nghp)


@dispatch.expectation.register(
    MarkovGaussian, object, (InducingVariables, NoneType), object, (InducingVariables, NoneType)
)
def _expectation_markov_generic(p, obj1, feat1, obj2, feat2, nghp=None):
    """A MarkovGaussian without its own implementation as the Gaussian of
    x_n or of x_{n+1}, where the cross-covariance is not needed; a joint
    expectation over (x_n, x_{n+1}) goes to the Markov quadrature."""
    if obj2 is None:
        return expectation(Gaussian(p.mu[:-1], p.cov[0, :-1]), (obj1, feat1), nghp=nghp)
    if obj1 is None:
        return expectation(Gaussian(p.mu[1:], p.cov[0, 1:]), (obj2, feat2), nghp=nghp)
    raise NotImplementedError
