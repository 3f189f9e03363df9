"""Analytic expectations of the Linear kernel (counterpart of
``gpflow_tpu/expectations/linears.py``)."""
from __future__ import annotations

from typing import Type

import torch

from .. import functions as mfn
from .. import kernels
from ..inducing_variables import InducingPoints
from ..probability_distributions import DiagonalGaussian, Gaussian, MarkovGaussian
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import expectation

NoneType: Type[None] = type(None)


@dispatch.expectation.register(Gaussian, kernels.Linear, NoneType, NoneType, NoneType)
@check_shapes("p: [N, D]", "return: [N]")
def _expectation_gaussian_linear(p, kernel, _, __, ___, nghp=None):
    """<diag K(X, X)>_p(X) -> [N]."""
    Xmu, _ = kernel.slice(p.mu, None)
    Xcov = kernel.slice_cov(p.cov)
    return torch.sum(kernel.variance.value * (torch.diagonal(Xcov, dim1=-2, dim2=-1) + Xmu ** 2), 1)


@dispatch.expectation.register(Gaussian, kernels.Linear, InducingPoints, NoneType, NoneType)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, M]")
def _expectation_gaussian_linear_inducingpoints(p, kernel, inducing_variable, _, __, nghp=None):
    """<K(X, Z)>_p(X) -> [N, M]."""
    Z, Xmu = kernel.slice(inducing_variable.Z.value, p.mu)
    return Xmu @ (Z * kernel.variance.value).mT


def _tiled_var_Z(kernel: kernels.Linear, Z: torch.Tensor, N: int) -> torch.Tensor:
    var_Z = kernel.variance.value * Z  # [M, D]
    return var_Z[None].expand((N,) + var_Z.shape)  # [N, M, D]


@dispatch.expectation.register(Gaussian, kernels.Linear, InducingPoints, mfn.Identity, NoneType)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, M, D]")
def _expectation_gaussian_linear_inducingpoints__identity(p, kernel, inducing_variable, mean, _, nghp=None):
    """<K(Z, x_n) x_n^T>_p(x_n) -> [N, M, D]."""
    Xmu, Xcov = p.mu, p.cov
    tiled_Z = _tiled_var_Z(kernel, inducing_variable.Z.value, Xmu.shape[0])
    return torch.matmul(tiled_Z, Xcov + (Xmu[..., None] * Xmu[:, None, :]))


@dispatch.expectation.register(MarkovGaussian, kernels.Linear, InducingPoints, mfn.Identity, NoneType)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, M, D]")
def _expectation_markov_linear_inducingpoints__identity(p, kernel, inducing_variable, mean, _, nghp=None):
    """<K(Z, x_n) x_{n+1}^T>_p of a time series -> [N, M, D]."""
    Xmu, Xcov = p.mu, p.cov
    tiled_Z = _tiled_var_Z(kernel, inducing_variable.Z.value, Xmu.shape[0] - 1)
    eXX = Xcov[1, :-1] + (Xmu[:-1][..., None] * Xmu[1:][:, None, :])  # [N, D, D]
    return torch.matmul(tiled_Z, eXX)


@dispatch.expectation.register(
    (Gaussian, DiagonalGaussian), kernels.Linear, InducingPoints, kernels.Linear, InducingPoints
)
@check_shapes("p: [N, D]", "feat1: [M, D, P]", "feat2: [M, D, P]", "return: [N, M, M]")
def _expectation_gaussian_linear_inducingpoints__linear_inducingpoints(p, kern1, feat1, kern2, feat2, nghp=None):
    """<K(Z, x_n) K(x_n, Z)>_p(x_n) -> [N, M, M]."""
    if kern1.on_separate_dims(kern2) and isinstance(p, DiagonalGaussian):
        eKxz1 = expectation(p, (kern1, feat1))
        eKxz2 = expectation(p, (kern2, feat2))
        return eKxz1[:, :, None] * eKxz2[:, None, :]

    if kern1 is not kern2 or feat1 is not feat2:
        raise NotImplementedError(
            "The expectation over two kernels has only an "
            "analytical implementation if both kernels are equal."
        )

    kernel = kern1
    Xcov = kernel.slice_cov(torch.diag_embed(p.cov) if isinstance(p, DiagonalGaussian) else p.cov)
    Z, Xmu = kernel.slice(feat1.Z.value, p.mu)

    tiled_Z = _tiled_var_Z(kernel, Z, Xmu.shape[0])  # [N, M, D]
    XX = Xcov + Xmu[:, None, :] * Xmu[:, :, None]  # [N, D, D]
    return torch.matmul(torch.matmul(tiled_Z, XX), tiled_Z.mT)
