"""The cross expectations of a SquaredExponential and a Linear kernel
(counterpart of ``gpflow_tpu/expectations/cross_kernels.py``)."""
from __future__ import annotations

import torch

from .. import kernels
from ..inducing_variables import InducingPoints
from ..ops.linalg import cholesky
from ..probability_distributions import DiagonalGaussian, Gaussian
from ..utilities.shapes import check_shapes
from . import dispatch
from .expectations import expectation
from .squared_exponentials import _positive_prod, _solve_lower, _sqrt_det


@dispatch.expectation.register(
    (Gaussian, DiagonalGaussian), kernels.SquaredExponential, InducingPoints, kernels.Linear, InducingPoints
)
@check_shapes("p: [N, D]", "feat1: [M1, D, P]", "feat2: [M2, D, P]", "return: [N, M1, M2]")
def _expectation_gaussian_sqe_inducingpoints__linear_inducingpoints(p, sqexp_kern, feat1, lin_kern, feat2, nghp=None):
    """<Ka(Z1, x_n) Kb(x_n, Z2)>_p(x_n) of a SquaredExponential and a Linear
    kernel -> [N, M1, M2]."""
    if sqexp_kern.on_separate_dims(lin_kern) and isinstance(p, DiagonalGaussian):
        eKxz1 = expectation(p, (sqexp_kern, feat1))
        eKxz2 = expectation(p, (lin_kern, feat2))
        return eKxz1[:, :, None] * eKxz2[:, None, :]

    if feat1 is not feat2:
        raise NotImplementedError("inducing_variables have to be the same for both kernels.")
    if sqexp_kern.active_dims != lin_kern.active_dims:
        raise NotImplementedError("active_dims have to be the same for both kernels.")

    Xcov = sqexp_kern.slice_cov(torch.diag_embed(p.cov) if isinstance(p, DiagonalGaussian) else p.cov)
    Z, Xmu = sqexp_kern.slice(feat1.Z.value, p.mu)
    N, D = Xmu.shape

    def take_with_ard(value: torch.Tensor) -> torch.Tensor:
        return value if sqexp_kern.ard else value.expand(D)

    lin_kern_variances = take_with_ard(lin_kern.variance.value)
    sqexp_kern_lengthscales = take_with_ard(sqexp_kern.lengthscales.value)

    chol_L_plus_Xcov = cholesky(torch.diag(sqexp_kern_lengthscales ** 2) + Xcov)  # [N, D, D]

    Z_transpose = Z.mT
    all_diffs = Z_transpose - Xmu[:, :, None]  # [N, D, M]
    exponent_mahalanobis = _solve_lower(chol_L_plus_Xcov, all_diffs)
    exponent_mahalanobis = torch.exp(-0.5 * torch.sum(torch.square(exponent_mahalanobis), 1))  # [N, M]

    determinants = _positive_prod(sqexp_kern_lengthscales) / _sqrt_det(chol_L_plus_Xcov)
    eKxz_sqexp = sqexp_kern.variance.value * (determinants[:, None] * exponent_mahalanobis)  # [N, M]

    tiled_Z = Z_transpose[None].expand((N,) + Z_transpose.shape)  # [N, D, M]
    z_L_inv_Xcov = torch.matmul(tiled_Z.mT, Xcov / sqexp_kern_lengthscales[:, None] ** 2.0)  # [N, M, D]

    cross_eKzxKxz = torch.cholesky_solve(
        (lin_kern_variances * sqexp_kern_lengthscales ** 2.0)[..., None] * tiled_Z, chol_L_plus_Xcov, upper=False
    )  # [N, D, M]
    return torch.matmul((z_L_inv_Xcov + Xmu[:, None, :]) * eKxz_sqexp[..., None], cross_eKzxKxz)  # [N, M, M]


@dispatch.expectation.register(
    (Gaussian, DiagonalGaussian), kernels.Linear, InducingPoints, kernels.SquaredExponential, InducingPoints
)
@check_shapes("p: [N, D]", "feat1: [M1, D, P]", "feat2: [M2, D, P]", "return: [N, M1, M2]")
def _expectation_gaussian_linear_inducingpoints__sqe_inducingpoints(p, lin_kern, feat1, sqexp_kern, feat2, nghp=None):
    """The transpose of the SquaredExponential-Linear case."""
    return expectation(p, (sqexp_kern, feat2), (lin_kern, feat1)).mT
