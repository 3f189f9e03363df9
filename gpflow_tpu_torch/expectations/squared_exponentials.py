"""Analytic psi statistics of the SquaredExponential kernel (counterpart of
``gpflow_tpu/expectations/squared_exponentials.py``).

The [N, D, D] batches are factored by ``ops.linalg.cholesky`` (NaN where a
matrix is not positive definite, with no host sync) and solved by batched
triangular solves. psi2 forms [N, M, M]: its memory grows as N M^2."""
from __future__ import annotations

from typing import Type

import torch

from .. import functions as mfn
from .. import kernels
from ..inducing_variables import InducingPoints
from ..ops.linalg import cholesky
from ..probability_distributions import DiagonalGaussian, Gaussian, MarkovGaussian
from ..utilities.ops import square_distance
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import expectation

NoneType: Type[None] = type(None)


def _ard_lengthscales(kernel: kernels.Stationary, D: int) -> torch.Tensor:
    """The lengthscales as [D], a scalar one repeated."""
    lengthscales = kernel.lengthscales.value
    return lengthscales if kernel.ard else lengthscales.expand(D)


def _positive_prod(x: torch.Tensor) -> torch.Tensor:
    """The product of a positive [D] x as exp(sum(log x)): ``torch.prod``'s
    backward reads whether an entry is 0 on the host."""
    return torch.exp(torch.sum(torch.log(x)))


def _sqrt_det(chol: torch.Tensor) -> torch.Tensor:
    """|L L^T|^(1/2) of each factor of a [N, D, D] batch -> [N]."""
    return torch.exp(torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=1))


def _solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(L, B, upper=False)


@dispatch.expectation.register(Gaussian, kernels.SquaredExponential, NoneType, NoneType, NoneType)
@check_shapes("p: [N, D]", "return: [N]")
def _expectation_gaussian_sqe(p, kernel, _, __, ___, nghp=None):
    """psi0 = <diag K(X, X)>_p(X): the variance at each point
    (``squared_exponentials.py:31-37``)."""
    return kernel(p.mu, full_cov=False)


@dispatch.expectation.register(Gaussian, kernels.SquaredExponential, InducingPoints, NoneType, NoneType)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, M]")
def _expectation_gaussian_sqe_inducingpoints(p, kernel, inducing_variable, _, __, nghp=None):
    """psi1 = <K(X, Z)>_p(X) -> [N, M], through chol(L^2 + Xcov) per point
    (``squared_exponentials.py:40-67``)."""
    Xcov = kernel.slice_cov(p.cov)
    Z, Xmu = kernel.slice(inducing_variable.Z.value, p.mu)
    D = Xmu.shape[1]
    lengthscales = _ard_lengthscales(kernel, D)

    chol_L_plus_Xcov = cholesky(torch.diag(lengthscales ** 2) + Xcov)  # [N, D, D]

    all_diffs = Z.mT - Xmu[:, :, None]  # [N, D, M]
    exponent_mahalanobis = _solve_lower(chol_L_plus_Xcov, all_diffs)
    exponent_mahalanobis = torch.exp(-0.5 * torch.sum(torch.square(exponent_mahalanobis), 1))  # [N, M]

    determinants = _positive_prod(lengthscales) / _sqrt_det(chol_L_plus_Xcov)  # [N]
    return kernel.variance.value * (determinants[:, None] * exponent_mahalanobis)


def _exKxz(lengthscales, variance, Z, Xmu, Xcov, Xmu_next, Xcov_cross):
    """<x' K(x, Z)> -> [N, D, M] for the pairs (x, x') of moments Xmu,
    Xmu_next and covariances Xcov (of x), Xcov_cross (of x with x')."""
    chol_L_plus_Xcov = cholesky(torch.diag(lengthscales ** 2) + Xcov)  # [N, D, D]
    all_diffs = Z.mT - Xmu[:, :, None]  # [N, D, M]
    determinants = _positive_prod(lengthscales) / _sqrt_det(chol_L_plus_Xcov)  # [N]

    exponent_mahalanobis = torch.cholesky_solve(all_diffs, chol_L_plus_Xcov, upper=False)  # [N, D, M]
    non_exponent_term = Xmu_next[:, :, None] + torch.matmul(Xcov_cross.mT, exponent_mahalanobis)  # [N, D, M]

    exponent_mahalanobis = torch.exp(-0.5 * torch.sum(all_diffs * exponent_mahalanobis, 1))  # [N, M]
    return variance * (determinants[:, None] * exponent_mahalanobis)[:, None, :] * non_exponent_term


@dispatch.expectation.register(Gaussian, mfn.Identity, NoneType, kernels.SquaredExponential, InducingPoints)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, D, M]")
def _expectation_gaussian__sqe_inducingpoints(p, mean, _, kernel, inducing_variable, nghp=None):
    """exKxz[n] = <x_n K(x_n, Z)>_p(x_n) -> [N, D, M]
    (``squared_exponentials.py:68-97``)."""
    Xmu, Xcov = p.mu, p.cov
    lengthscales = _ard_lengthscales(kernel, Xmu.shape[1])
    return _exKxz(lengthscales, kernel.variance.value, inducing_variable.Z.value, Xmu, Xcov, Xmu, Xcov)


@dispatch.expectation.register(MarkovGaussian, mfn.Identity, NoneType, kernels.SquaredExponential, InducingPoints)
@check_shapes("p: [N, D]", "inducing_variable: [M, D, P]", "return: [N, D, M]")
def _expectation_markov__sqe_inducingpoints(p, mean, _, kernel, inducing_variable, nghp=None):
    """<x_{n+1} K(x_n, Z)>_p of a time series -> [N, D, M]
    (``squared_exponentials.py:100-131``)."""
    Xmu, Xcov = p.mu, p.cov
    lengthscales = _ard_lengthscales(kernel, Xmu.shape[1])
    return _exKxz(lengthscales, kernel.variance.value, inducing_variable.Z.value,
                  Xmu[:-1], Xcov[0, :-1], Xmu[1:], Xcov[1, :-1])


@dispatch.expectation.register(
    (Gaussian, DiagonalGaussian),
    kernels.SquaredExponential,
    InducingPoints,
    kernels.SquaredExponential,
    InducingPoints,
)
@check_shapes("p: [N, D]", "feat1: [M, D, P]", "feat2: [M, D, P]", "return: [N, M, M]")
def _expectation_gaussian_sqe_inducingpoints__sqe_inducingpoints(p, kern1, feat1, kern2, feat2, nghp=None):
    """psi2[n] = <K(Z, x_n) K(x_n, Z)>_p(x_n) -> [N, M, M]
    (``squared_exponentials.py:134-204``). The factor
    exp(-|z_m - z_m'|^2 / (4 l^2)) is kept apart from the exponent, as in
    the JAX package, whose gradient is NaN-free where Kzz underflows."""
    if kern1.on_separate_dims(kern2) and isinstance(p, DiagonalGaussian):
        eKxz1 = expectation(p, (kern1, feat1))
        eKxz2 = expectation(p, (kern2, feat2))
        return eKxz1[:, :, None] * eKxz2[:, None, :]

    if feat1 is not feat2 or kern1 is not kern2:
        raise NotImplementedError(
            "The expectation over two kernels has only an "
            "analytical implementation if both kernels are equal."
        )

    kernel = kern1
    inducing_variable = feat1

    Xcov = kernel.slice_cov(torch.diag_embed(p.cov) if isinstance(p, DiagonalGaussian) else p.cov)
    Z, Xmu = kernel.slice(inducing_variable.Z.value, p.mu)

    N, D = Xmu.shape
    squared_lengthscales = _ard_lengthscales(kernel, D) ** 2

    sqrt_det_L = torch.sqrt(_positive_prod(0.5 * squared_lengthscales))
    C = cholesky(0.5 * torch.diag(squared_lengthscales) + Xcov)  # [N, D, D]
    dets = sqrt_det_L / _sqrt_det(C)  # [N]

    C_inv_mu = _solve_lower(C, Xmu[:, :, None])  # [N, D, 1]
    C_inv_z = _solve_lower(C, (0.5 * Z.mT)[None].expand(N, D, Z.shape[0]))  # [N, D, M]
    mu_CC_inv_mu = torch.sum(torch.square(C_inv_mu), 1)[:, :, None]  # [N, 1, 1]
    z_CC_inv_z = torch.sum(torch.square(C_inv_z), 1)  # [N, M]
    zm_CC_inv_zn = torch.matmul(C_inv_z.mT, C_inv_z)  # [N, M, M]
    two_z_CC_inv_mu = 2 * torch.matmul(C_inv_z.mT, C_inv_mu)[:, :, 0]  # [N, M]

    exponent_mahalanobis = (
        mu_CC_inv_mu
        + z_CC_inv_z[:, None, :]
        + z_CC_inv_z[:, :, None]
        + 2 * zm_CC_inv_zn
        - two_z_CC_inv_mu[:, :, None]
        - two_z_CC_inv_mu[:, None, :]
    )
    exponent_mahalanobis = torch.exp(-0.5 * exponent_mahalanobis)  # [N, M, M]

    kernel_sqrt = torch.exp(-0.25 * square_distance(Z / kernel.lengthscales.value, None))
    return kernel.variance.value ** 2 * kernel_sqrt * dets.reshape(N, 1, 1) * exponent_mahalanobis
